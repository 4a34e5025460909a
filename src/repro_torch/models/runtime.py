"""Run-time knobs for the model stack (port of `repro.models.runtime`).

`ATTN_Q_CHUNK`: 0 takes attention's scores over the whole query length at
once; > 0 takes the queries in chunks of that size where the query length
exceeds it and divides by it (`layers.sdpa`), so the float32 scores are
(B, H, chunk, Skv): the memory-bounded schedule of long-context prefill.
The dry run sets it to 1024 for every cell of 8192 positions or more
(`launch.dryrun.run_cell`).

`MOE_DP_GROUPS`: the MoE's dispatch groups over the whole batch (1: one
global dispatch).  The dry run sets it to the data-parallel degree, so
routing, sorting and scattering stay local to a data shard
(`models.moe.moe_block`).

The reference's `SCAN_UNROLL`, `unrolled_scans` and `layer_scan` have no
counterpart: the port loops over the layers in Python, and an eager trace
(the port's dry run, `launch.dryrun`) counts every layer, so there is no
loop body that a cost analysis would count once.

Both knobs are process-wide, as the reference's are module globals:
remat's recompute runs the forward again on autograd's own thread and
must see the same values.
"""
from __future__ import annotations

import contextlib

# Query-chunked attention: 0 = full-S scores; >0 = process queries in
# chunks of this size when Sq exceeds it (memory-bounded long-context
# prefill).
ATTN_Q_CHUNK = 0

# MoE dispatch groups over the whole batch: 1 = a single global dispatch;
# the data-parallel degree in production.
MOE_DP_GROUPS = 1


@contextlib.contextmanager
def moe_dp_groups(g: int):
    global MOE_DP_GROUPS
    prev = MOE_DP_GROUPS
    MOE_DP_GROUPS = g
    try:
        yield
    finally:
        MOE_DP_GROUPS = prev


@contextlib.contextmanager
def attn_q_chunk(size: int):
    global ATTN_Q_CHUNK
    prev = ATTN_Q_CHUNK
    ATTN_Q_CHUNK = size
    try:
        yield
    finally:
        ATTN_Q_CHUNK = prev


__all__ = ["ATTN_Q_CHUNK", "MOE_DP_GROUPS", "attn_q_chunk", "moe_dp_groups"]
