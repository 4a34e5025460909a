"""Predicted-vs-measured cost-model drift ledger (port of
`repro.telemetry.drift`; DESIGN.md §7).

`autotune_plan` prices every candidate schedule as

    cost_s = max(compute_s, memory_s) + comm_s          (serialized)
           | max(max(compute_s, memory_s), comm_s) + split_s  (overlapped)

in seconds per grid-point-timestep.  This module holds those terms against
measured times:

  * `predict_plan_terms` re-derives the sweep-entry terms for an executed
    plan — same formulas, same `PHYSICS_COSTS` field counts, same hardware
    defaults (read from `autotune_plan`'s own signature: the H100 data
    sheet's, so prediction and sweep cannot disagree);
  * `DriftLedger.record(cell, predicted, measured)` stores them beside
    measured phase times and the per-term ratio measured/predicted;
  * `DriftLedger.report()` adds a geomean-ratio summary per term.

On the measured side, host clocks split the exchange from the kernel phase
(the sharded launcher times an exchange-only run), but compute and memory
inside one kernel need hardware counters, so `measured["compute_s"]` and
`measured["memory_s"]` both carry the kernel-phase time, to be read against
the model's `max(compute_s, memory_s)` (`ratio_vs_roofline`).  When the
shards share one card the exchange is a device-local copy, not a transfer
over a link: its ratio then says nothing about `link_bw` or
`link_latency`.
"""
from __future__ import annotations

import inspect
import json
import math
import os
from typing import Dict, List, Optional

from repro_torch.core.temporal_blocking import (PHYSICS_COSTS, TBPlan,
                                                autotune_plan)

DEFAULT_PATH = os.path.join("results", "telemetry_drift_torch.json")

TERMS = ("compute_s", "memory_s", "exchange_s")

# Hardware constants come from autotune_plan's own defaults (the H100 data
# sheet's) so prediction and sweep cannot disagree; overrides flow through
# predict_plan_terms.
_SWEEP_DEFAULTS = {
    k: p.default for k, p in inspect.signature(autotune_plan).parameters.items()
    if k in ("peak_flops", "hbm_bw", "link_bw", "link_latency", "dtype_bytes")
}


def predict_plan_terms(physics: str, nz: int, order: int, inner: TBPlan,
                       outer_T: Optional[int] = None,
                       block=None, overlap: bool = False,
                       **overrides) -> Dict[str, float]:
    """The cost model's per-term prediction (seconds / grid-point-timestep)
    for an EXECUTED plan — the same arithmetic `autotune_plan` used to
    pick it.

    `inner` is the (tile, T, radius) plan actually run; `block` the
    per-device (bx, by) shard block when sharded (None -> single device,
    exchange term 0); `outer_T` the exchange depth when time-nested
    (defaults to `inner.T`, the flat schedule).  `overrides` replace the
    hardware constants (`peak_flops`, `hbm_bw`, `link_bw`,
    `link_latency`, `dtype_bytes`).
    """
    pc = PHYSICS_COSTS[physics]
    hw = dict(_SWEEP_DEFAULTS)
    hw.update(overrides)
    fpp = pc.flops_per_point(order)
    T_out = inner.T if outer_T is None else int(outer_T)
    nested = block is not None and T_out != inner.T

    if nested:
        comp = (inner.nested_compute_multiplier(block, T_out)
                * fpp / hw["peak_flops"])
        mem = inner.nested_hbm_bytes_per_point_step(
            block, T_out, nz, read_fields=pc.read_fields,
            write_fields=pc.write_fields,
            dtype_bytes=hw["dtype_bytes"]) / hw["hbm_bw"]
    else:
        comp = inner.overlap_factor() * fpp / hw["peak_flops"]
        mem = inner.hbm_bytes_per_point_step(
            nz, read_fields=pc.read_fields, write_fields=pc.write_fields,
            dtype_bytes=hw["dtype_bytes"]) / hw["hbm_bw"]

    exch = 0.0
    split = 0.0
    if block is not None:
        outer = TBPlan(inner.tile, T_out, inner.radius)
        depths = tuple(max(outer.halo - lag, 0)
                       for lag in pc.exchange_lags(order))
        exch = outer.exchange_seconds_per_point_step(
            tuple(block), nz, pc.state_fields, hw["link_bw"],
            hw["link_latency"], dtype_bytes=hw["dtype_bytes"], depths=depths)
        if overlap:
            split = outer.split_step_overhead_per_point_step(
                tuple(block), nz, inner.radius, fpp, hw["peak_flops"])

    roofline = max(comp, mem)
    total = (max(roofline, exch) + split) if overlap else (roofline + exch)
    return {"compute_s": comp, "memory_s": mem, "exchange_s": exch,
            "split_s": split, "roofline_s": roofline, "total_s": total,
            "overlap": bool(overlap), "nested": nested,
            "hardware": hw}


def predict_hier_terms(hier, physics: str, nz: int, order: int,
                       **overrides) -> Dict[str, float]:
    """`predict_plan_terms` for a `HierPlan` (inner / outer_T / block /
    overlap unpacked from the plan object)."""
    return predict_plan_terms(physics, nz, order, hier.inner,
                              outer_T=hier.outer_T, block=hier.block,
                              overlap=hier.overlap, **overrides)


def _geomean(vals: List[float]) -> Optional[float]:
    vals = [v for v in vals if v is not None and v > 0.0
            and math.isfinite(v)]
    if not vals:
        return None
    return math.exp(sum(math.log(v) for v in vals) / len(vals))


class DriftLedger:
    """Accumulates (cell, predicted, measured) triples and reports
    per-term drift ratios.

    `cell` identifies what ran (physics, grid, mesh, plan — anything
    JSON-able); `predicted` is a `predict_plan_terms` dict; `measured`
    maps any subset of `TERMS` (+ `total_s`) to measured seconds per
    grid-point-timestep.
    """

    def __init__(self):
        self._records: List[dict] = []

    def record(self, cell: dict, predicted: Dict[str, float],
               measured: Dict[str, float]) -> dict:
        ratios = {}
        for term in TERMS + ("total_s",):
            p = predicted.get(term)
            m = measured.get(term)
            ratios[term] = (m / p) if (p and m is not None and p > 0.0) \
                else None
        rec = {"cell": dict(cell),
               "predicted": {k: v for k, v in predicted.items()
                             if k != "hardware"},
               "hardware": predicted.get("hardware"),
               "measured": dict(measured),
               "ratio": ratios}
        # the honest fused-kernel comparison (see module docstring)
        kern = measured.get("kernel_s", measured.get("compute_s"))
        roof = predicted.get("roofline_s")
        rec["ratio"]["kernel_vs_roofline"] = (
            kern / roof if (roof and kern is not None and roof > 0.0)
            else None)
        self._records.append(rec)
        return rec

    def extend(self, records):
        """Adopt already-built drift records (e.g. collected from child
        benchmark processes that each ran their own `record`)."""
        self._records.extend(dict(r) for r in records)

    def report(self) -> dict:
        summary = {}
        for term in TERMS + ("total_s", "kernel_vs_roofline"):
            vals = [r["ratio"].get(term) for r in self._records]
            g = _geomean(vals)
            summary[term] = {
                "geomean_ratio": g,
                "n": sum(1 for v in vals if v is not None and v > 0.0
                         and math.isfinite(v)),
            }
        return {"records": self._records, "summary": summary,
                "note": "ratio = measured / predicted; >1 means the model "
                        "is optimistic (e.g. exchange ratio R -> scale "
                        "link_bw down by ~R)"}

    def save(self, path: str = DEFAULT_PATH) -> str:
        d = os.path.dirname(os.path.abspath(path))
        os.makedirs(d, exist_ok=True)
        with open(path, "w") as f:
            json.dump(self.report(), f, indent=1)
        return path

    def __len__(self):
        return len(self._records)


def last_drift(path: str = DEFAULT_PATH) -> Optional[dict]:
    """Summary of the most recent saved drift report (None if absent or
    unreadable) — the `dryrun` report's last-run drift line."""
    try:
        with open(path) as f:
            rep = json.load(f)
    except (OSError, ValueError):
        return None
    if not isinstance(rep, dict) or "summary" not in rep:
        return None
    return {"path": path, "n_records": len(rep.get("records", ())),
            "summary": rep["summary"]}


__all__ = ["DEFAULT_PATH", "TERMS", "DriftLedger", "last_drift",
           "predict_hier_terms", "predict_plan_terms"]
