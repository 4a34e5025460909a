"""The stencil's plan report for a dry run (port of
`repro.launch.dryrun.stencil_plan_report`).

The reference's dry run also lowers and compiles the language models'
train and serve steps on a 512-device host mesh and reads XLA's
`memory_analysis` / `cost_analysis`; that part belongs to the language
model stack (ROADMAP A11), and torch has no compile-time counterpart of
either analysis.
"""
from __future__ import annotations


def stencil_plan_report(physics: str, nz: int, order: int,
                        block, plan_cache=None, interp=None,
                        **plan_kwargs) -> dict:
    """Joint two-level TB plan selection for one per-shard stencil block
    (DESIGN.md §4).

    Runs `core.temporal_blocking.plan_hierarchy` (outer exchange depth x
    inner (tile, T) x overlapped-vs-serialized exchange, under the
    mesh-aware cost model) behind the survey plan cache
    (`survey/plan_cache.py`): a repeated cell answers from the cache, and
    the report's ``cache`` field records the key and hit/miss.  Records
    what the executor will do plus the per-field exchange-byte saving
    against the uniform-depth baseline and the window saving of the
    time-nested schedule against the flat plan at the same exchange depth.
    Consumed by `launch/stencil_dist.py --dryrun`.

    `interp` (a `core.interp.InterpSpec`; default multilinear) annotates
    the report: the ``interp`` field records the kernel, radius, and
    (2r)**3 footprint that size the sparse-point tables.  ``last_drift``
    is the last saved drift report's summary (`telemetry.drift`), None
    until one exists.  The hardware figures of the sweep default to the
    H100's (`autotune_plan`); with the reference's passed in
    `plan_kwargs` the report equals the reference's.
    """
    from repro_torch.core import interp as interp_mod
    from repro_torch.core.temporal_blocking import PHYSICS_COSTS, TBPlan
    from repro_torch.survey.plan_cache import cached_plan_hierarchy
    from repro_torch.telemetry import drift as drift_mod

    ispec = interp_mod.LINEAR if interp is None else interp
    hier, entry, info = cached_plan_hierarchy(physics, nz, order, block,
                                              cache=plan_cache,
                                              **plan_kwargs)
    uni = hier.exchange_bytes_uniform(nz)
    pf = hier.exchange_bytes(nz)
    fields = PHYSICS_COSTS[physics].fields
    flat_vmem = TBPlan(hier.inner.tile, hier.outer_T,
                       hier.inner.radius).vmem_bytes(nz, fields)
    return {
        "physics": physics, "order": order, "block": list(block), "nz": nz,
        "outer": {"T": hier.outer_T, "halo": hier.halo,
                  "overlap": hier.overlap,
                  "field_depths": list(hier.field_depths)},
        "inner": {"tile": list(hier.inner.tile), "T": hier.inner.T,
                  "passes": -(-hier.outer_T // hier.inner.T),
                  "grid": [block[0] // hier.inner.tile[0],
                           block[1] // hier.inner.tile[1]]},
        "exchange_bytes": int(pf),
        "exchange_bytes_uniform": int(uni),
        "exchange_saving": round(1.0 - pf / uni, 4) if uni else 0.0,
        "vmem_bytes": int(hier.vmem_bytes(nz, fields)),
        "vmem_bytes_flat": int(flat_vmem),
        "model": {k: entry[k] for k in
                  ("compute_s", "memory_s", "comm_s", "split_s", "cost_s")
                  if k in entry},
        "cache": {"key": info.key, "hit": info.hit},
        "interp": {**ispec.to_dict(), "footprint": ispec.footprint(3)},
        "last_drift": drift_mod.last_drift(),
    }


__all__ = ["stencil_plan_report"]
