"""Device meshes over an initialised ``torch.distributed`` world: the port
of ``repro.launch.mesh``, and the launcher of one process a rank.

Single pod: (data=16, model=16) = 256 ranks.  Multi-pod: (pod=2,
data=16, model=16) = 512 ranks; the ``pod`` axis is pure data
parallelism and the work-exchange / failure domain.  The builders are
functions, so importing this module touches no process group.

Nothing on a machine tells a program of its cluster: ``spawn`` starts
``world_size`` processes on this host, each initialising its process
group through a file store (``file://``; one card a rank with NCCL, CPU
processes with gloo), with a timeout on every collective and a hard
limit on the whole run, so a hung rank fails instead of waiting.
"""
from __future__ import annotations

import datetime
import os
import shutil
import tempfile
import time
from typing import Callable, Optional, Sequence

import torch
import torch.distributed as dist

AXES = ("data", "model")


def _device_type() -> str:
    return "cuda" if dist.get_backend() == "nccl" else "cpu"


def make_production_mesh(*, multi_pod: bool = False):
    shape = (2, 16, 16) if multi_pod else (16, 16)
    axes = ("pod", "data", "model") if multi_pod else AXES
    need = 1
    for n in shape:
        need *= n
    have = dist.get_world_size() if dist.is_initialized() else 1
    if have != need:
        raise ValueError(f"the production mesh {dict(zip(axes, shape))} "
                         f"needs a world of {need} ranks; this one has "
                         f"{have}")
    from torch.distributed.device_mesh import init_device_mesh
    return init_device_mesh(_device_type(), shape, mesh_dim_names=axes)


def make_host_mesh(model: int = 1, pod: int = 1):
    """(data = world // model, model) over the whole initialised world;
    with ``pod`` > 1, (pod, data = world // (pod * model), model)."""
    from torch.distributed.device_mesh import init_device_mesh
    n = dist.get_world_size()
    if n % (model * pod):
        raise ValueError(f"a world of {n} ranks does not split into "
                         f"pod={pod} x model={model}")
    if pod == 1:
        return init_device_mesh(_device_type(), (n // model, model),
                                mesh_dim_names=AXES)
    return init_device_mesh(_device_type(), (pod, n // (pod * model), model),
                            mesh_dim_names=("pod",) + AXES)


def dp_axes(mesh) -> tuple:
    """Axes that shard the batch: ('pod','data') when pod exists."""
    return tuple(a for a in ("pod", "data") if a in mesh.mesh_dim_names)


def init_rank(rank: int, world_size: int, store: str, backend: str,
              timeout_s: float) -> None:
    """Join the process group as ``rank`` (NCCL: on card ``rank``)."""
    if backend == "nccl":
        torch.cuda.set_device(rank)
    else:
        torch.set_num_threads(max(1, (os.cpu_count() or 1) // world_size))
    dist.init_process_group(
        backend, init_method=f"file://{store}", rank=rank,
        world_size=world_size,
        timeout=datetime.timedelta(seconds=timeout_s))


def _rank_main(rank: int, fn: Callable, world_size: int, store: str,
               backend: str, timeout_s: float, args: tuple) -> None:
    init_rank(rank, world_size, store, backend, timeout_s)
    try:
        fn(rank, *args)
    finally:
        dist.destroy_process_group()


def spawn(fn: Callable, world_size: int, args: Sequence = (),
          backend: str = "gloo", timeout_s: float = 120.0,
          store_dir: Optional[str] = None) -> None:
    """Run ``fn(rank, *args)`` in ``world_size`` fresh processes, each in
    the process group (``fn`` must be importable by name).  Raises the
    first rank's exception, and ``TimeoutError`` (after stopping every
    rank) when the run passes ``timeout_s`` seconds."""
    import torch.multiprocessing as mp
    tmp = tempfile.mkdtemp(dir=store_dir)
    store = os.path.join(tmp, "store")
    ctx = mp.start_processes(
        _rank_main, args=(fn, world_size, store, backend, timeout_s,
                          tuple(args)),
        nprocs=world_size, join=False, start_method="spawn")
    deadline = time.monotonic() + timeout_s
    try:
        while not ctx.join(timeout=max(0.1, deadline - time.monotonic())):
            if time.monotonic() >= deadline:
                raise TimeoutError(f"{world_size} ranks of {fn.__name__} "
                                   f"passed their {timeout_s:.0f} s limit")
    finally:
        for p in ctx.processes:
            if p.is_alive():
                p.terminate()
        for p in ctx.processes:
            p.join(10)
            if p.is_alive():
                p.kill()
        shutil.rmtree(tmp, ignore_errors=True)
