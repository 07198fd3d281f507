"""Content-addressed results store: ``results/store/<spec-hash>.json``.
The port of ``repro.experiments.store``: the record format is the
reference's, so the port reads the entries the reference wrote.

Every stored file is one ``ExperimentResult`` record: the *resolved*
spec (backend and devices concrete), its hash, the per-task ``MCReport``
rows, and the execution environment.  The file name IS the spec hash,
so identity is structural: re-running an unchanged spec is a cache hit,
and any change to the spec -- scenario grid, trial budget, backend,
device count, seeds -- lands at a new address instead of silently
overwriting old numbers.

Writes are atomic (tmp file + rename); unreadable or mismatched entries
read as misses rather than crashes, so a corrupted store degrades to
recomputation.
"""
from __future__ import annotations

import json
import os
import tempfile
from pathlib import Path
from typing import List, Optional, Union

from .spec import ExperimentSpec

DEFAULT_STORE_ROOT = Path("results") / "store"


class ResultsStore:
    """Filesystem store keyed by ``ExperimentSpec.spec_hash()``."""

    def __init__(self, root: Union[str, Path] = DEFAULT_STORE_ROOT):
        self.root = Path(root)

    def path_for(self, spec_hash: str) -> Path:
        return self.root / f"{spec_hash}.json"

    def _hash_of(self, key) -> str:
        if isinstance(key, ExperimentSpec):
            # address by what running the spec here-and-now would store:
            # compile resolves backend=None to the default and devices
            # always to 1, as run_experiment does (idempotent on
            # already-resolved specs)
            from .plan import compile_plan
            return compile_plan(key).spec.spec_hash()
        return str(key)

    def __contains__(self, key) -> bool:
        return self.path_for(self._hash_of(key)).exists()

    def entries(self) -> List[str]:
        """Stored spec hashes (file names without the .json suffix)."""
        if not self.root.is_dir():
            return []
        return sorted(p.stem for p in self.root.glob("*.json"))

    def get(self, key) -> Optional["ExperimentResult"]:
        """Load the result for a spec (or literal hash); None on miss.

        A file that cannot be parsed, or whose recorded hash does not
        match its address, counts as a miss -- the engine recomputes and
        rewrites it.
        """
        from .engine import ExperimentResult

        spec_hash = self._hash_of(key)
        path = self.path_for(spec_hash)
        try:
            result = ExperimentResult.from_dict(
                json.loads(path.read_text()))
        except (OSError, ValueError, KeyError, TypeError, AttributeError):
            # unreadable, unparseable, or structurally wrong records all
            # degrade to recomputation
            return None
        if result.spec_hash != spec_hash:
            return None
        return result

    def put(self, result: "ExperimentResult") -> Path:
        """Atomically write a result at its content address."""
        path = self.path_for(result.spec_hash)
        self.root.mkdir(parents=True, exist_ok=True)
        fd, tmp = tempfile.mkstemp(dir=self.root, suffix=".tmp")
        try:
            with os.fdopen(fd, "w") as f:
                json.dump(result.to_dict(), f, indent=1)
            os.chmod(tmp, 0o644)       # mkstemp defaults to 0600
            os.replace(tmp, path)
        except BaseException:
            try:
                os.unlink(tmp)
            except OSError:
                pass
            raise
        return path


def default_store() -> ResultsStore:
    """The repo-standard store under ``results/store``."""
    return ResultsStore(DEFAULT_STORE_ROOT)


__all__ = ["DEFAULT_STORE_ROOT", "ResultsStore", "default_store"]
