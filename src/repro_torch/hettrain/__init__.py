"""Heterogeneity-aware distributed training: the port of
``repro.hettrain``.  So far its gradient engine (``engine``): one
canonical-order float32 gradient sum per unit group.  The training
config, the scheme-driven epoch policies and the runner come with a
later slice of the port."""
from .engine import MIN_BUCKET, ScanGradEngine, bucket_units, tree_bytes

__all__ = ["ScanGradEngine", "bucket_units", "tree_bytes", "MIN_BUCKET"]
