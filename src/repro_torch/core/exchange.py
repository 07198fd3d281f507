"""Unit-level work-exchange protocol types.

Only the ``Assignment`` record that ``Scheme.plan`` returns lives here so
far; the id-aware ``MasterScheduler`` of ``repro.core.exchange`` (with
its rate estimators) is ported in a later slice.
"""
from __future__ import annotations

import dataclasses
from typing import List


@dataclasses.dataclass
class Assignment:
    """Per-worker ordered unit queues plus the master's wait mode."""
    queues: List[List[int]]
    wait_all: bool            # final phase below the cutting threshold

