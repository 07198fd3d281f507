"""Measured-trace corpora + the ``trace_corpus`` scenario family
(the port of ``repro.scenarios.traces``; it reads the same corpora).

A corpus is one committed JSON file under ``results/traces/`` holding a
``(workers, epochs)`` matrix of observed per-epoch service rates
(units/sec) plus provenance metadata.  Corpora are **immutable**: the
name IS the version (a changed matrix must ship under a new name),
which is what lets the ``trace_corpus`` family contribute only its
corpus *name* to the experiment ``spec_hash`` and still promise
reproducibility.

``trace_corpus`` grid points are windows into the corpus -- a worker
offset and an epoch offset -- each materializing as

* a nominal ``HetSpec`` (the window's per-worker mean rates: what a
  scheduler that profiled the cluster beforehand would believe), and
* a per-round rate schedule (the window's actual epoch-by-epoch rates:
  what the cluster really does), consumed by the work-exchange engines
  through ``rate_schedule`` and replayable through the id-aware master
  protocol via ``scheme_spec("trace_replay", **family.trace_replay_
  params(g))``.

The committed ``default_64x48`` corpus is a synthetic *measured-trace
stand-in* (64 workers x 48 one-minute epochs, generated once from a
throttling + co-tenancy model -- see its ``provenance`` field); drop a
real cluster's JSON next to it and every family knob works unchanged.
"""
from __future__ import annotations

import dataclasses
import functools
import json
from pathlib import Path
from typing import Any, Dict, List, Mapping, Optional, Tuple

import numpy as np

from ..core.types import HetSpec

from .base import ScenarioFamily, check_keys, register_family

TRACES_ROOT = Path("results") / "traces"
DEFAULT_CORPUS = "default_64x48"


@dataclasses.dataclass(frozen=True)
class TraceCorpus:
    """One loaded corpus: rates (W, E) + metadata."""

    name: str
    rates: np.ndarray          # (workers, epochs), > 0
    meta: Dict[str, Any]

    @property
    def workers(self) -> int:
        return int(self.rates.shape[0])

    @property
    def epochs(self) -> int:
        return int(self.rates.shape[1])

    def window(self, K: int, worker_offset: int = 0, epoch_start: int = 0,
               epochs: Optional[int] = None) -> np.ndarray:
        """A ``(K, epochs)`` view: workers ``worker_offset ..`` and
        epochs ``epoch_start ..``, both wrapping -- every window is
        valid for any corpus size."""
        if K <= 0:
            raise ValueError("window needs K > 0")
        E = self.epochs if epochs is None else int(epochs)
        if E <= 0:
            raise ValueError("window needs epochs > 0")
        rows = (int(worker_offset) + np.arange(K)) % self.workers
        cols = (int(epoch_start) + np.arange(E)) % self.epochs
        return self.rates[np.ix_(rows, cols)]


def corpus_path(name: str) -> Path:
    """Resolve a corpus name (or literal path) to its JSON file.

    Lookup order: a literal / absolute path, ``results/traces`` under
    the current directory, then under the repo root (so tests and tools
    running from other directories still find committed corpora).
    """
    p = Path(name)
    if p.suffix == ".json" and p.is_file():
        return p
    repo_root = Path(__file__).resolve().parents[3]
    for root in (TRACES_ROOT, repo_root / TRACES_ROOT):
        cand = root / f"{name}.json"
        if cand.is_file():
            return cand
    raise FileNotFoundError(
        f"trace corpus {name!r} not found under {TRACES_ROOT} (cwd or "
        f"repo root); committed corpora live at results/traces/<name>.json")


@functools.lru_cache(maxsize=8)
def _load(path: str) -> TraceCorpus:
    d = json.loads(Path(path).read_text())
    rates = np.asarray(d["rates"], dtype=np.float64)
    if rates.ndim != 2 or rates.size == 0:
        raise ValueError(f"corpus rates must be a (workers, epochs) "
                         f"matrix; got shape {rates.shape}")
    if np.any(rates <= 0) or not np.all(np.isfinite(rates)):
        raise ValueError("corpus rates must be finite and positive")
    rates.setflags(write=False)
    meta = {k: v for k, v in d.items() if k != "rates"}
    return TraceCorpus(name=d.get("name", Path(path).stem), rates=rates,
                       meta=meta)


def load_corpus(name: str = DEFAULT_CORPUS) -> TraceCorpus:
    """Load (and cache) a corpus by name or path."""
    return _load(str(corpus_path(name)))


@register_family("trace_corpus")
@dataclasses.dataclass(frozen=True)
class TraceCorpusScenario(ScenarioFamily):
    """Windows into a measured-trace corpus as a scenario grid.

    ``windows`` is a tuple of ``(worker_offset, epoch_start)`` pairs --
    one grid point per window; ``epochs`` is the window length (and the
    length of the per-round schedule each point contributes).
    """

    corpus: str
    K: int
    windows: Tuple[Tuple[int, int], ...]
    epochs: int = 16

    def __post_init__(self):
        wins = tuple((int(w), int(e)) for w, e in self.windows)
        if not wins:
            raise ValueError("trace_corpus needs at least one window")
        if int(self.K) <= 0:
            raise ValueError("trace_corpus grids need K > 0")
        if int(self.epochs) <= 0:
            raise ValueError("epochs must be > 0")
        object.__setattr__(self, "windows", wins)
        object.__setattr__(self, "K", int(self.K))
        object.__setattr__(self, "epochs", int(self.epochs))

    def __len__(self) -> int:
        return len(self.windows)

    def _window(self, g: int) -> np.ndarray:
        w, e = self.windows[g]
        return load_corpus(self.corpus).window(self.K, w, e, self.epochs)

    def specs(self) -> List[HetSpec]:
        """Nominal rates: the window's per-worker mean (the profile a
        scheduler would have measured up front)."""
        return [HetSpec(self._window(g).mean(axis=1))
                for g in range(len(self.windows))]

    def rate_schedules(self) -> np.ndarray:
        """``(G, epochs, K)`` -- the measured epoch rates, epoch e
        driving exchange round e."""
        return np.stack([self._window(g).T
                         for g in range(len(self.windows))])

    def trace_replay_params(self, g: int) -> Dict[str, Any]:
        """Constructor params replaying point ``g``'s exact window
        through ``get_scheme("trace_replay", ...)``."""
        w, e = self.windows[g]
        return {"corpus": self.corpus, "worker_offset": w,
                "epoch_start": e, "epochs": self.epochs}

    def to_dict(self) -> Dict[str, Any]:
        return {
            "family": "trace_corpus",
            "corpus": self.corpus,
            "K": self.K,
            "windows": [list(w) for w in self.windows],
            "epochs": self.epochs,
        }

    @classmethod
    def from_dict(cls, d: Mapping[str, Any]) -> "TraceCorpusScenario":
        check_keys(d, frozenset({"corpus", "K", "windows"}),
                   frozenset({"epochs"}), "trace_corpus")
        kwargs = {"epochs": int(d["epochs"])} if "epochs" in d else {}
        return cls(corpus=str(d["corpus"]), K=int(d["K"]),
                   windows=tuple(tuple(w) for w in d["windows"]), **kwargs)


__all__ = ["TRACES_ROOT", "DEFAULT_CORPUS", "TraceCorpus", "corpus_path",
           "load_corpus", "TraceCorpusScenario"]
