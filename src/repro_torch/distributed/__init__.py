"""Sharded execution layer (port of `repro.distributed`; DESIGN.md §4):
`halo` runs the temporally-blocked propagation over a `ShardMesh`;
`sharding` holds the layout rules (`ShardingRules`, `needs_fsdp`);
`process_group` runs data parallelism across processes."""
from repro_torch.distributed.sharding import (  # noqa: F401
    ShardingRules, needs_fsdp)
