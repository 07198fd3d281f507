"""How every hand-written CUDA kernel of the port is built and loaded.

Each kernel is one source in ``src/repro_torch/csrc/`` with a plain C
interface.  ``nvcc`` compiles it for ``sm_90a`` into a shared library in
the git-ignored ``src/repro_torch/_build/`` at first use; the file name
``<name>-<hash>.so`` carries a hash of the source and the flags, so a
changed source or flag is rebuilt and an unchanged one is reused.  The
library is loaded with ``ctypes``; the wrapper passes pointers as
``c_void_p`` and PyTorch's current stream, and the C function returns
``cudaGetLastError()``, which ``check_launch`` turns into an exception.

Nothing here runs when the module is imported.  ``build_all`` starts one
``nvcc`` per source at once and waits for all of them.  Every build runs
``ptxas`` verbosely and keeps its report (registers and spills of each
kernel) beside the library as ``<name>-<hash>.log``, so a cached build
still has it.

``LAUNCH_COUNTS`` holds each kernel's launches, counted by its wrapper
where the launch happens and nowhere else; ``DESIGN_COUNTS`` splits the
launches of the kernels that have more than one design ("tc" on the
tensor cores, "fma" on the FMA units; the scan's "ring" and "direct") by
the design each took.
"""
from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import threading
import time
from pathlib import Path
from typing import Callable, Dict, Iterable, List, Optional, Sequence, Tuple

import torch

PKG = Path(__file__).resolve().parents[1]
CSRC = PKG / "csrc"
BUILD_DIR = PKG / "_build"
ARCH_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
              "-O3")
SHARED_FLAGS = ("-shared", "-Xcompiler", "-fPIC")

LAUNCH_COUNTS: Dict[str, int] = {"we_rounds": 0, "linear_scan": 0,
                                 "flash_attention": 0, "expert_matmul": 0}
DESIGN_COUNTS: Dict[Tuple[str, str], int] = {
    **{(name, design): 0 for name in ("flash_attention", "expert_matmul")
       for design in ("tc", "fma")},
    ("linear_scan", "ring"): 0, ("linear_scan", "direct"): 0}


def reset_launch_counts() -> None:
    for name in LAUNCH_COUNTS:
        LAUNCH_COUNTS[name] = 0
    for key in DESIGN_COUNTS:
        DESIGN_COUNTS[key] = 0


def nvcc() -> str:
    found = shutil.which("nvcc")
    if found:
        return found
    home = os.environ.get("CUDA_HOME") or os.environ.get("CUDA_PATH") \
        or "/usr/local/cuda"
    path = Path(home) / "bin" / "nvcc"
    if not path.exists():
        raise RuntimeError("nvcc not found (looked on PATH and in "
                           f"{path.parent}); the port's CUDA kernels are "
                           "built from source at first use")
    return str(path)


class CudaLibrary:
    """One kernel source, its nvcc flags, and the C entry point's ctypes
    signature (``argtypes``; the return type is always ``int``)."""

    def __init__(self, name: str, flags: Sequence[str], entry: str,
                 argtypes: List[type]):
        self.name = name
        self.source = CSRC / f"{name}.cu"
        self.flags = tuple(flags)
        self.entry = entry
        self.argtypes = argtypes
        self._lib = None
        self._fns: Dict[str, Callable[..., int]] = {}
        self._lock = threading.Lock()

    def library_path(self) -> Path:
        """Where the built library for the current source, the shared
        headers and the flags lives."""
        content = self.source.read_bytes() + b"".join(
            h.read_bytes() for h in sorted(CSRC.glob("*.cuh")))
        h = hashlib.sha256(content
                           + " ".join(self.flags).encode()).hexdigest()[:16]
        return BUILD_DIR / f"{self.name}-{h}.so"

    def report(self) -> str:
        """nvcc's output of the build of ``library_path()`` (with
        ``-Xptxas -v``: each kernel's registers and spills); "" if that
        library is not built."""
        log = self.library_path().with_suffix(".log")
        return log.read_text() if log.exists() else ""

    def _command(self, out: Path) -> List[str]:
        return [nvcc(), *self.flags, "-Xptxas", "-v", "-o", str(out),
                str(self.source)]

    def build(self) -> Tuple[Path, float]:
        """Compile the library if it is not built yet.  Returns its path
        and the seconds spent compiling (0.0 when cached)."""
        return build_all([self])[self.name]

    def function(self, entry: Optional[str] = None) -> Callable[..., int]:
        """The loaded C entry point ``entry`` (default: the library's
        ``entry``; every entry of a library takes ``argtypes``), building
        the library if needed."""
        entry = entry or self.entry
        fn = self._fns.get(entry)
        if fn is None:
            with self._lock:
                if self._lib is None:
                    self._lib = ctypes.CDLL(str(self.build()[0]))
                fn = getattr(self._lib, entry)
                fn.argtypes = self.argtypes
                fn.restype = ctypes.c_int
                self._fns[entry] = fn
        return fn


def build_all(libs: Iterable[CudaLibrary]) -> Dict[str, Tuple[Path, float]]:
    """Build every library not built yet, one ``nvcc`` each, all started
    together.  Returns ``{name: (path, seconds compiling)}``; raises with
    nvcc's output if any build fails."""
    done: Dict[str, Tuple[Path, float]] = {}
    running = []
    for lib in libs:
        path = lib.library_path()
        if path.exists():
            done[lib.name] = (path, 0.0)
            continue
        BUILD_DIR.mkdir(parents=True, exist_ok=True)
        tmp = path.with_name(f"{path.name}.{os.getpid()}.tmp")
        # nvcc's report goes to a file: a pipe left unread while another
        # build is awaited could fill and stall the compiler
        log = open(tmp.with_suffix(".log"), "w+")
        proc = subprocess.Popen(lib._command(tmp), stdout=log,
                                stderr=subprocess.STDOUT, text=True)
        running.append((lib, path, tmp, proc, log, time.perf_counter()))
    errors = []
    for lib, path, tmp, proc, log, t0 in running:
        with log:
            proc.wait()
            seconds = time.perf_counter() - t0
            log.seek(0)
            report = log.read()
        if proc.returncode != 0:
            os.unlink(log.name)
            errors.append(f"nvcc failed on {lib.source.name} "
                          f"({proc.returncode}):\n{report}")
            continue
        # atomic: concurrent builds never clash; the report goes first, so
        # a built library always has one beside it
        os.replace(log.name, path.with_suffix(".log"))
        os.replace(tmp, path)
        done[lib.name] = (path, seconds)
    if errors:
        raise RuntimeError("\n".join(errors))
    return done


def check_launch(name: str, rc: int, design: Optional[str] = None) -> None:
    """Raise if the C entry point reported a CUDA error; else count the
    launch (and, for a kernel with designs, the design it took)."""
    if rc != 0:
        raise RuntimeError(f"{name} launch failed: cudaError {rc}")
    LAUNCH_COUNTS[name] += 1
    if design is not None:
        DESIGN_COUNTS[(name, design)] += 1


def stream_of(t: torch.Tensor) -> int:
    """PyTorch's current stream on ``t``'s device, as a pointer."""
    return torch.cuda.current_stream(t.device).cuda_stream


def check_tensor(t: torch.Tensor, name: str, shape, device: torch.device,
                 dtypes=(torch.float32,)) -> None:
    """Raise ``ValueError`` unless ``t`` is a contiguous tensor of ``shape``
    on ``device`` with one of ``dtypes``: what a kernel's raw pointer
    arithmetic assumes."""
    if t.device != device:
        raise ValueError(f"{name} must be on {device}; got {t.device}")
    if t.dtype not in dtypes:
        names = " or ".join(str(d).replace("torch.", "") for d in dtypes)
        raise ValueError(f"{name} must be {names}; got {t.dtype}")
    if tuple(t.shape) != tuple(shape):
        raise ValueError(f"{name} must have shape {tuple(shape)}; "
                         f"got {tuple(t.shape)}")
    if not t.is_contiguous():
        raise ValueError(f"{name} must be contiguous")
