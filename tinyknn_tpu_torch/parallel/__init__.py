"""The sharded indexes: device meshes, the list-sharded IVF, the
point-sharded FastPQ search and the data-parallel k-means step
(counterpart of tinyknn_tpu/parallel)."""

from .mesh import (
    Mesh,
    Placed,
    make_mesh,
    make_mesh_2d,
    replicate,
    shard_on_axis0,
)
from .sharded_ivf import ShardedIVF, lloyd_step_dp
from .sharded_pq import ShardedFastPQ

__all__ = ["Mesh", "Placed", "make_mesh", "make_mesh_2d", "shard_on_axis0",
           "replicate", "ShardedIVF", "ShardedFastPQ", "lloyd_step_dp"]
