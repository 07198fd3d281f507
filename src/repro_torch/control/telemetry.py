"""Structured telemetry timeline for live control-plane episodes.  The
port's own copy of ``repro.control.telemetry``.

One ``Telemetry`` per episode collects three shapes of evidence, all
stamped with wall-clock seconds since ``start()``:

* **events** -- per-message coordination records (rpc sends, replies,
  retries, drops detected, worker loss, exchange-round markers), capped
  so a pathological run can't bloat a report;
* **counters** -- monotone tallies (units dispatched / completed /
  reassigned, rpc retries, messages); the conservation identity
  ``dispatched == completed + reassigned`` is checked from these;
* **spans** -- per-worker occupancy intervals (busy computing a round
  vs. idle awaiting assignment), from which per-worker occupancy and
  throughput summaries are derived.

``to_dict()`` renders the whole timeline JSON-safe for
``MCReport.extra["control_plane"]``.
"""
from __future__ import annotations

import time
from collections import defaultdict
from typing import Any, Dict, List, Optional

MAX_EVENTS = 2000


class Telemetry:
    """Append-only episode timeline (events, counters, worker spans)."""

    def __init__(self, max_events: int = MAX_EVENTS):
        self.max_events = int(max_events)
        self.events: List[Dict[str, Any]] = []
        self.dropped_events = 0
        self.counters: Dict[str, int] = defaultdict(int)
        self.spans: Dict[int, List[Dict[str, float]]] = defaultdict(list)
        self._open: Dict[int, Dict[str, Any]] = {}
        self._t0: Optional[float] = None

    def start(self) -> None:
        self._t0 = time.perf_counter()

    def now(self) -> float:
        if self._t0 is None:
            return 0.0
        return time.perf_counter() - self._t0

    def event(self, kind: str, **fields: Any) -> None:
        if len(self.events) >= self.max_events:
            self.dropped_events += 1
            return
        rec = {"t": round(self.now(), 6), "kind": kind}
        rec.update(fields)
        self.events.append(rec)

    def count(self, key: str, n: int = 1) -> None:
        self.counters[key] += int(n)

    def span_open(self, worker: int, state: str, **fields: Any) -> None:
        self.span_close(worker)
        self._open[worker] = {"state": state, "t0": self.now(), **fields}

    def span_close(self, worker: int, **fields: Any) -> None:
        rec = self._open.pop(worker, None)
        if rec is None:
            return
        rec.update(fields)
        t0 = rec.pop("t0")
        t1 = self.now()
        self.spans[worker].append(
            {"t0": round(t0, 6), "t1": round(t1, 6), **rec})

    def close_all(self) -> None:
        for worker in list(self._open):
            self.span_close(worker)

    # -- summaries ----------------------------------------------------------

    def occupancy(self) -> Dict[int, Dict[str, float]]:
        """Per-worker busy/idle wall seconds and units-per-wall-second
        throughput, from the recorded spans."""
        out: Dict[int, Dict[str, float]] = {}
        for worker, spans in sorted(self.spans.items()):
            busy = sum(s["t1"] - s["t0"] for s in spans
                       if s["state"] == "busy")
            idle = sum(s["t1"] - s["t0"] for s in spans
                       if s["state"] == "idle")
            units = sum(int(s.get("units", 0)) for s in spans
                        if s["state"] == "busy")
            out[worker] = {
                "busy_s": round(busy, 6),
                "idle_s": round(idle, 6),
                "units_done": units,
                "throughput_units_per_s":
                    round(units / busy, 3) if busy > 0 else 0.0,
            }
        return out

    def to_dict(self, events_tail: int = 200) -> Dict[str, Any]:
        """JSON-safe timeline; only the last ``events_tail`` events are
        embedded verbatim (the counters and spans carry the totals).
        Raw per-worker spans ride along under ``"spans"`` -- what the
        occupancy-timeline figure (``benchmarks/fig_timeline``) renders."""
        self.close_all()
        return {
            "counters": dict(sorted(self.counters.items())),
            "occupancy": {str(k): v for k, v in self.occupancy().items()},
            "spans": {str(k): list(v)
                      for k, v in sorted(self.spans.items())},
            "n_events": len(self.events) + self.dropped_events,
            "events": self.events[-int(events_tail):],
        }


__all__ = ["Telemetry", "MAX_EVENTS"]
