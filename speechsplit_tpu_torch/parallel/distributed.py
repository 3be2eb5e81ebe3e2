"""Process groups for data-parallel training (counterpart of
speechsplit_tpu/parallel/distributed.py).

JAX runs one process a host and finds its devices itself. Here each
device is one process, a rank of a ``torch.distributed`` group: NCCL
between cards, gloo between CPU processes (or, asked for, between
processes that share one card). :func:`initialize` starts the group,
from torchrun's environment (``RANK``, ``WORLD_SIZE``, ``LOCAL_RANK``,
``MASTER_ADDR``/``MASTER_PORT``) or from its arguments, and puts the
rank on its card; :func:`launch` starts a world of ranks from one
process, as ``cli.train --num_devices N`` does.

Every rank runs the same host program on its own rows of the global
batch (:func:`local_batch_slice`); the parameters are replicated, the
gradients averaged (``parallel.mesh``, ``training.train_step``).
"""

from __future__ import annotations

import os
import shutil
import tempfile
import time
from typing import Callable, Optional

import torch
import torch.distributed as dist

BACKENDS = {"cuda": "nccl", "cpu": "gloo"}


def world() -> int:
    """Ranks in the group, 1 with no group."""
    return dist.get_world_size() if dist.is_initialized() else 1


def rank() -> int:
    """This process's rank, 0 with no group."""
    return dist.get_rank() if dist.is_initialized() else 0


def is_primary() -> bool:
    """Whether this process writes checkpoints, logs and samples."""
    return rank() == 0


def barrier() -> None:
    """Wait for every rank (nothing to wait for with no group)."""
    if dist.is_initialized():
        dist.barrier()


def _env_int(name: str) -> Optional[int]:
    value = os.environ.get(name)
    return int(value) if value not in (None, "") else None


def _rank_device(device, local_rank: int) -> torch.device:
    """``cuda:{local_rank}`` for a bare ``cuda``; an indexed device or the
    CPU as given."""
    dev = torch.device(device)
    if dev.type == "cuda" and dev.index is None:
        dev = torch.device("cuda", local_rank)
    return dev


def initialize(
    backend: Optional[str] = None,
    init_method: Optional[str] = None,
    world_size: Optional[int] = None,
    rank: Optional[int] = None,
    *,
    device="cuda",
) -> torch.device:
    """Join the process group; returns the device this rank runs on.

    With no arguments the world comes from torchrun's environment
    (``env://``). With no group and a world of one (no ``WORLD_SIZE``),
    the process stays single-process. Called again it does nothing, as
    JAX's ``initialize`` does. ``backend`` defaults to ``nccl`` for a
    CUDA ``device`` and ``gloo`` for the CPU; a caller may ask for
    ``gloo`` on CUDA. A backend that cannot start raises: there is no
    fallback to another. A bare ``cuda`` becomes ``cuda:{local_rank}``
    (``LOCAL_RANK``, else the rank), and is made the current device."""
    if world_size is None:
        world_size = _env_int("WORLD_SIZE")
    if rank is None:
        rank = _env_int("RANK")
    local_rank = _env_int("LOCAL_RANK")
    if local_rank is None:
        local_rank = rank or 0
    dev = _rank_device(device, local_rank)
    if dev.type == "cuda":
        if not torch.cuda.is_available():
            raise RuntimeError(f"{dev}: no CUDA device is available")
        torch.cuda.set_device(dev)
    if dist.is_initialized() or (world_size in (None, 1)
                                 and init_method is None):
        return dev
    if backend is None:
        backend = BACKENDS[dev.type]
    if not dist.is_available() or not dist.is_backend_available(backend):
        raise RuntimeError(f"torch.distributed backend {backend!r} is not "
                           "available in this build")
    if rank is None:
        raise ValueError("initialize: a world of several ranks needs a rank "
                         "(RANK or rank=)")
    dist.init_process_group(backend, init_method=init_method or "env://",
                            world_size=world_size, rank=rank)
    return dev


def shutdown() -> None:
    """Leave the process group, if this process is in one."""
    if dist.is_initialized():
        dist.destroy_process_group()


def local_batch_slice(global_batch: int, size: Optional[int] = None,
                      index: Optional[int] = None) -> slice:
    """The rows of a global batch this rank trains on (JAX
    distributed.py:44-52): equal shares in rank order, of ``size`` ranks
    (the world's by default) for the rank at ``index`` (this one's)."""
    size = world() if size is None else size
    index = rank() if index is None else index
    if global_batch % size:
        raise ValueError(f"a global batch of {global_batch} rows does not "
                         f"split over {size} ranks")
    per_rank = global_batch // size
    return slice(index * per_rank, (index + 1) * per_rank)


def _rank_entry(index: int, fn: Callable, args: tuple, world_size: int,
                init_method: str, backend: Optional[str], device,
                threads: int) -> None:
    """A spawned rank: one group member, then ``fn(*args)``."""
    torch.set_num_threads(threads)
    os.environ.update(RANK=str(index), WORLD_SIZE=str(world_size),
                      LOCAL_RANK=str(index))
    initialize(backend, init_method, world_size, index, device=device)
    try:
        fn(*args)
    finally:
        shutdown()


def launch(fn: Callable, world_size: int, args: tuple = (), *,
           backend: Optional[str] = None, device="cuda",
           init_method: Optional[str] = None,
           timeout: Optional[float] = None,
           threads: Optional[int] = None) -> None:
    """Run ``fn(*args)`` in ``world_size`` spawned ranks of one group and
    wait for all of them. ``fn`` must be importable by name (a module's
    top-level function). Each rank joins the group first (``backend``
    and ``device`` as :func:`initialize` takes them; an indexed device
    such as ``cuda:0`` puts every rank on that card). The group meets
    through ``init_method``, by default a file store in a new temporary
    directory, removed after. Each rank runs ``threads`` torch threads
    (default this process's count over the world, at least 1).

    A rank that raises ends the others and raises here; so does a world
    that has not ended after ``timeout`` seconds."""
    import torch.multiprocessing as mp

    scratch = None
    if init_method is None:
        scratch = tempfile.mkdtemp(prefix="speechsplit_group_")
        init_method = f"file://{os.path.join(scratch, 'store')}"
    if threads is None:
        threads = max(1, torch.get_num_threads() // world_size)
    ctx = mp.start_processes(
        _rank_entry, args=(fn, args, world_size, init_method, backend,
                           device, threads),
        nprocs=world_size, join=False, start_method="spawn")
    deadline = None if timeout is None else time.monotonic() + timeout
    try:
        while not ctx.join(timeout=1.0):
            if deadline is not None and time.monotonic() > deadline:
                raise TimeoutError(f"{world_size} ranks had not ended after "
                                   f"{timeout} s")
    finally:
        for proc in ctx.processes:
            if proc.is_alive():
                proc.terminate()
                proc.join(timeout=10.0)
            if proc.is_alive():
                proc.kill()
                proc.join()
        if scratch is not None:
            shutil.rmtree(scratch, ignore_errors=True)
