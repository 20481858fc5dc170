"""Site-batch sharding over the visible devices (``parallel.mesh``) and
multi-process job partitioning (``parallel.distributed``)."""

from saguaro_tpu_torch.parallel.distributed import partition_jobs
from saguaro_tpu_torch.parallel.mesh import (
    batch_sharding,
    default_mesh,
    default_mesh_for,
    fsdp_param_sharding,
    make_mesh,
    replicate,
    shard_batch,
)

__all__ = [
    "make_mesh",
    "default_mesh",
    "default_mesh_for",
    "shard_batch",
    "replicate",
    "batch_sharding",
    "fsdp_param_sharding",
    "partition_jobs",
]
