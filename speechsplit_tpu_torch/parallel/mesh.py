"""The data mesh: ranks, their rows and the collectives a train step
needs (counterpart of speechsplit_tpu/parallel/mesh.py).

JAX's mesh is a 1-D ``('data',)`` array of devices: parameters and
optimizer state replicated, batches sharded over ``data``, the gradient
all-reduce placed by XLA. Here the mesh is the process group of
``parallel.distributed``: each rank holds a replica of the model, trains
on its equal share of the global batch and averages its gradients with
the others' (``training.train_step``, DDP or an explicit all-reduce). As
in JAX, ``config.mesh_shape`` is ``(world,)`` over ``mesh_axes =
("data",)``; another shape raises.

What JAX's shardings say, here:
- ``batch_sharding``: :meth:`Mesh.rows`, this rank's rows of a global
  batch, and :func:`shard_batch`;
- ``replicated_sharding``: :func:`replicate`, the parameters broadcast
  from rank 0 when a step first runs.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Optional, Sequence

import torch
import torch.distributed as dist

from speechsplit_tpu_torch.parallel import distributed

# the mesh's one axis (JAX's ``mesh_axes``)
AXIS = "data"


@dataclass(frozen=True)
class Mesh:
    """A 1-D data mesh over the default process group: ``size`` ranks,
    this process's ``rank`` on it."""

    size: int
    rank: int

    def rows(self, global_batch: int) -> slice:
        """This rank's rows of a global batch."""
        return distributed.local_batch_slice(global_batch, self.size,
                                             self.rank)

    def example_ids(self, local_batch: int) -> torch.Tensor:
        """The global row ids of this rank's ``local_batch`` rows (JAX
        train_step.py:461)."""
        return self.rank * local_batch + torch.arange(local_batch)

    def all_reduce_sum(self, tensor: torch.Tensor) -> torch.Tensor:
        """``tensor`` summed over the ranks, in place; returns it."""
        dist.all_reduce(tensor, op=dist.ReduceOp.SUM)
        return tensor

    def all_reduce_mean(self, tensor: torch.Tensor) -> torch.Tensor:
        """``tensor`` averaged over the ranks (a sum, then / size: gloo
        has no mean), in place; returns it."""
        return self.all_reduce_sum(tensor).div_(self.size)

    def barrier(self) -> None:
        """Wait for every rank of the mesh."""
        distributed.barrier()


def check_mesh_shape(shape: Sequence[int], axes: Sequence[str],
                     world: int) -> None:
    """JAX's meaning of ``config.mesh_shape``/``mesh_axes``: one ``data``
    axis as long as the world. Anything else raises ValueError."""
    shape, axes = tuple(shape), tuple(axes)
    if axes != (AXIS,) or shape != (world,):
        raise ValueError(
            f"mesh_shape={shape} over mesh_axes={axes}: the port's mesh is "
            f"one {AXIS!r} axis of the world's {world} rank(s), "
            f"mesh_shape=({world},)")


def make_mesh(shape: Optional[Sequence[int]] = None) -> Mesh:
    """The mesh of the process group (``parallel.initialize`` first);
    ``shape``, when given, must be ``(world,)`` (JAX's ``make_mesh``
    defaults to every device on the one ``data`` axis)."""
    if not dist.is_initialized():
        raise RuntimeError("make_mesh needs a process group: call "
                           "parallel.initialize first")
    size = dist.get_world_size()
    check_mesh_shape(shape if shape is not None else (size,), (AXIS,), size)
    return Mesh(size=size, rank=dist.get_rank())


def shard_batch(mesh: Mesh, batch, axis: int = 0):
    """This rank's rows of every field of a named tuple of arrays (a
    ``Batch`` or a crop plan), along ``axis`` (1 for a ``[k, B]``
    stack)."""
    rows = mesh.rows(batch[0].shape[axis])
    index = (slice(None),) * axis + (rows,)
    return type(batch)(*(x[index] for x in batch))


@torch.no_grad()
def replicate(mesh: Mesh, module: torch.nn.Module) -> None:
    """Rank 0's parameters and buffers on every rank (a broadcast each)."""
    for tensor in [*module.parameters(), *module.buffers()]:
        dist.broadcast(tensor.data, src=0)
