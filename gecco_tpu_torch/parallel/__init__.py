"""Data-parallel training over a ``torch.distributed`` process group
(counterpart of ``gecco_tpu/parallel``)."""

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
    "init_distributed",
    "local_device",
    "make_mesh",
    "process_count",
    "process_index",
    "replicate",
    "shard_batch",
    "shutdown_distributed",
]
