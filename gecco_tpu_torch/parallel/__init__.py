"""Data-parallel and point-sharded training over a ``torch.distributed``
process group (counterpart of ``gecco_tpu/parallel``)."""

from gecco_tpu_torch.parallel.collectives import (
    gather_points,
    point_shard,
    points_group,
    sharding_points,
    sum_over_points,
)
from gecco_tpu_torch.parallel.mesh import (
    Mesh,
    all_reduce_mean_,
    init_distributed,
    local_device,
    make_mesh,
    process_count,
    process_index,
    replicate,
    shard_batch,
    shutdown_distributed,
)

__all__ = [
    "Mesh",
    "all_reduce_mean_",
    "gather_points",
    "init_distributed",
    "local_device",
    "make_mesh",
    "point_shard",
    "points_group",
    "process_count",
    "process_index",
    "replicate",
    "shard_batch",
    "sharding_points",
    "shutdown_distributed",
    "sum_over_points",
]
