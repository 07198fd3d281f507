"""Fused work-exchange round-pipeline kernel (the ``cuda`` sampler
backend): counter-based Threefry bits + Marsaglia-Tsang Gammas + argmin
straggler selection + normal-limit Binomials, one warp per trial row."""
from .kernel import LAUNCH_COUNTS, reset_launch_counts, we_rounds_cuda
from .ops import DEFAULT_BLOCK_B, gamma_rows_grid, we_rounds, we_rounds_grid
from .ref import (gamma_rows_reference, we_rounds_reference,
                  we_rounds_reference_panel)

__all__ = [
    "DEFAULT_BLOCK_B", "LAUNCH_COUNTS", "gamma_rows_grid",
    "gamma_rows_reference", "reset_launch_counts", "we_rounds",
    "we_rounds_cuda", "we_rounds_grid", "we_rounds_reference",
    "we_rounds_reference_panel",
]
