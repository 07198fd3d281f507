"""Heterogeneity-aware distributed-training subsystem: the port of
``repro.hettrain``.

Every registered scheme becomes an epoch-assignment policy over real
gradients: the unit-group engine (``engine``) computes one
canonical-order gradient sum per optimizer step -- bit-identical across
policies by work conservation -- while each policy's scheduler
(``policies``) moves virtual wall-clock over a ``VirtualWorkerPool``.
``runner.run_training_grid`` runs one scheme task of a training study
configured by ``TrainConfig`` (``config``).
"""
from .config import MODEL_PRESETS, TrainConfig
from .engine import MIN_BUCKET, ScanGradEngine, bucket_units, tree_bytes
from .policies import (StepStats, build_scheduler, policy_mode,
                       run_virtual_step)
from .runner import compute_trajectory, run_training_grid

__all__ = ["TrainConfig", "MODEL_PRESETS", "ScanGradEngine", "bucket_units",
           "tree_bytes", "MIN_BUCKET", "StepStats", "policy_mode",
           "run_virtual_step", "build_scheduler", "run_training_grid",
           "compute_trajectory"]
