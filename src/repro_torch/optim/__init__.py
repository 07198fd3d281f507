"""Optimizer and learning-rate schedules of the port (torch only)."""
from .adamw import AdamW, AdamWState
from .schedules import constant, warmup_cosine

__all__ = ["AdamW", "AdamWState", "constant", "warmup_cosine"]
