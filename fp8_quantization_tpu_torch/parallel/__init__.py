"""Mesh and sharding layer, port of ``parallel/``: a single-controller
``(data, model)`` mesh of ``torch.device``s, placement rules, the K4/K5
products run per shard, and ring attention."""

from .ring_attention import full_attention, ring_attention
from .shard_kernels import (
    kernel_mesh,
    partitioned_kernels,
    sharded_dequant_matmul,
    sharded_int4_matmul,
)
from .sharding import (
    initialize_multihost,
    make_mesh,
    param_spec,
    replicate,
    reshard,
    shard_batch,
    shard_variables,
)

__all__ = [
    "full_attention",
    "ring_attention",
    "kernel_mesh",
    "partitioned_kernels",
    "sharded_dequant_matmul",
    "sharded_int4_matmul",
    "initialize_multihost",
    "make_mesh",
    "param_spec",
    "replicate",
    "reshard",
    "shard_batch",
    "shard_variables",
]
