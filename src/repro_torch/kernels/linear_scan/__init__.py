"""Linear recurrence h_t = a_t h_{t-1} + b_t (the RG-LRU scan),
differentiable."""
from .kernel import linear_scan_cuda, linear_scan_design
from .ops import linear_scan
from .ref import linear_scan_ref

__all__ = ["linear_scan", "linear_scan_cuda", "linear_scan_design",
           "linear_scan_ref"]
