"""Data-parallel training across ranks (counterpart of
speechsplit_tpu/parallel/): the process group (``distributed``) and the
data mesh over it (``mesh``)."""

from speechsplit_tpu_torch.parallel.distributed import (
    barrier,
    initialize,
    is_primary,
    launch,
    local_batch_slice,
    rank,
    shutdown,
    world,
)
from speechsplit_tpu_torch.parallel.mesh import (
    Mesh,
    check_mesh_shape,
    make_mesh,
    replicate,
    shard_batch,
)

__all__ = [
    "initialize",
    "launch",
    "shutdown",
    "local_batch_slice",
    "rank",
    "world",
    "is_primary",
    "barrier",
    "Mesh",
    "make_mesh",
    "check_mesh_shape",
    "shard_batch",
    "replicate",
]
