"""Distributed execution over torch.distributed: the mesh, the batch's
sharding and collectives (`mesh`), and the sharded render
(`distributed_render`)."""

from consistentnerf_tpu_torch.parallel.mesh import (
    batch_sharding,
    create_mesh,
    local_batch_slice,
    maybe_initialize_distributed,
    replicated_sharding,
    shard_batch,
)

__all__ = [
    "create_mesh",
    "batch_sharding",
    "replicated_sharding",
    "shard_batch",
    "local_batch_slice",
    "maybe_initialize_distributed",
]
