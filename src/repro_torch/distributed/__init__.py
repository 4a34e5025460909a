"""Sharded execution layer (port of `repro.distributed`; DESIGN.md §4):
`halo` runs the temporally-blocked propagation over a `ShardMesh`."""
