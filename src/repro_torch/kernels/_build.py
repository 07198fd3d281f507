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
``nvcc`` per source at once and waits for all of them.

``LAUNCH_COUNTS`` holds each kernel's launches, counted by its wrapper
where the launch happens and nowhere else.
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
from typing import Callable, Dict, Iterable, List, Sequence, Tuple

import torch

PKG = Path(__file__).resolve().parents[1]
CSRC = PKG / "csrc"
BUILD_DIR = PKG / "_build"
ARCH_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
              "-O3")
SHARED_FLAGS = ("-shared", "-Xcompiler", "-fPIC")

LAUNCH_COUNTS: Dict[str, int] = {"we_rounds": 0, "linear_scan": 0,
                                 "flash_attention": 0, "expert_matmul": 0}


def reset_launch_counts() -> None:
    for name in LAUNCH_COUNTS:
        LAUNCH_COUNTS[name] = 0


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
        self._lock = threading.Lock()

    def library_path(self) -> Path:
        """Where the built library for the current source and flags lives."""
        h = hashlib.sha256(self.source.read_bytes()
                           + " ".join(self.flags).encode()).hexdigest()[:16]
        return BUILD_DIR / f"{self.name}-{h}.so"

    def _command(self, out: Path, verbose: bool) -> List[str]:
        return [nvcc(), *self.flags, *(["-Xptxas", "-v"] if verbose else []),
                "-o", str(out), str(self.source)]

    def build(self, verbose: bool = False) -> Tuple[Path, float]:
        """Compile the library if it is not built yet.  Returns its path
        and the seconds spent compiling (0.0 when cached).  ``verbose``
        adds ``-Xptxas -v`` and prints nvcc's report."""
        return build_all([self], verbose)[self.name]

    def function(self) -> Callable[..., int]:
        """The loaded C entry point (building the library if needed)."""
        with self._lock:
            if self._lib is None:
                lib = ctypes.CDLL(str(self.build()[0]))
                fn = getattr(lib, self.entry)
                fn.argtypes = self.argtypes
                fn.restype = ctypes.c_int
                self._lib = lib
        return getattr(self._lib, self.entry)


def build_all(libs: Iterable[CudaLibrary], verbose: bool = False
              ) -> Dict[str, Tuple[Path, float]]:
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
        proc = subprocess.Popen(lib._command(tmp, verbose), stdout=log,
                                stderr=subprocess.STDOUT, text=True)
        running.append((lib, path, tmp, proc, log, time.perf_counter()))
    errors = []
    for lib, path, tmp, proc, log, t0 in running:
        with log:
            proc.wait()
            seconds = time.perf_counter() - t0
            log.seek(0)
            report = log.read()
        os.unlink(log.name)
        if proc.returncode != 0:
            errors.append(f"nvcc failed on {lib.source.name} "
                          f"({proc.returncode}):\n{report}")
            continue
        if verbose:
            print(report, end="")
        os.replace(tmp, path)       # atomic: concurrent builds never clash
        done[lib.name] = (path, seconds)
    if errors:
        raise RuntimeError("\n".join(errors))
    return done


def check_launch(name: str, rc: int) -> None:
    """Raise if the C entry point reported a CUDA error; else count the
    launch."""
    if rc != 0:
        raise RuntimeError(f"{name} launch failed: cudaError {rc}")
    LAUNCH_COUNTS[name] += 1


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
