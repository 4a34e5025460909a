"""Temporal blocking plans and their cost model (port of
`repro.core.temporal_blocking`: `TimeTileSchedule`, `tiled_propagate`,
`TBPlan`, `SweepLog`, `autotune_plan`, `PhysicsCost`, `PHYSICS_COSTS`,
`plan_for_physics`, `HierPlan`, `plan_hierarchy`, and the pass geometry
the time-nested terms price).

The model prices a depth-T trapezoidal time tile per grid-point-step:

  compute  = overlap_factor * flops_per_point / peak_flops
  memory   = bytes moved per point-step / memory bandwidth

plus, for a sharded plan (`mesh_block`), the exchange of the outer
trapezoid over the interconnect.  The arithmetic is the reference's term
for term; every hardware figure is a keyword argument, defaulting to the
H100 SXM data sheet (see `autotune_plan`).

What the model does not predict: it prices each field's window as read
once per time tile.  The port's CUDA kernels (`kernels/csrc/`) re-read
every field at every in-window step, so the sweep's pick does not predict
their time (PERF.md).  `HierPlan` / `plan_hierarchy` are the two-level
plan of the sharded layer (`distributed/halo.py`): an outer exchange depth
over an inner (tile, T) per shard, searched jointly.
"""
from __future__ import annotations

import dataclasses
import math
from typing import Callable, List, NamedTuple, Optional, Tuple

import numpy as np
import torch


class TBPassGeom(NamedTuple):
    """Geometry of one inner pass of the time-nested schedule: `T` steps
    from step offset `t0`, entering with halo depth `d_in` and leaving
    `d_out` valid, on a kernel grid of `grid` points (the block plus
    2 * d_out, rounded up to the tile) cut into `ntiles` tiles."""

    T: int
    t0: int
    d_in: int
    d_out: int
    halo: int
    grid: Tuple[int, int]
    tile: Tuple[int, int]
    ntiles: Tuple[int, int]
    include_halo: bool


def nested_pass_geometry(block: Tuple[int, int], tile: Tuple[int, int],
                         T_steps: int, inner_T: int, r: int
                         ) -> List[TBPassGeom]:
    """Split `T_steps` in-tile steps into inner passes of depth <= inner_T
    (the last may be shallower); `inner_T == T_steps` is the flat
    single-pass schedule."""
    if T_steps < 0 or inner_T < 1:
        raise ValueError(f"need T_steps >= 0 and inner_T >= 1, got "
                         f"({T_steps}, {inner_T})")
    bx, by = block
    tx, ty = tile
    geoms = []
    done = 0
    while done < T_steps:
        Tp = min(inner_T, T_steps - done)
        d_out = (T_steps - done - Tp) * r
        cx = -(-(bx + 2 * d_out) // tx) * tx
        cy = -(-(by + 2 * d_out) // ty) * ty
        geoms.append(TBPassGeom(
            T=Tp, t0=done, d_in=d_out + Tp * r, d_out=d_out, halo=Tp * r,
            grid=(cx, cy), tile=(tx, ty), ntiles=(cx // tx, cy // ty),
            include_halo=Tp > 1))
        done += Tp
    return geoms


@dataclasses.dataclass(frozen=True)
class TimeTileSchedule:
    """nt timesteps split into ceil(nt/T) tiles of depth <= T."""

    nt: int
    T: int

    def __post_init__(self):
        if self.T < 1:
            raise ValueError("time tile depth must be >= 1")

    @property
    def num_tiles(self) -> int:
        return -(-self.nt // self.T)

    @property
    def padded_nt(self) -> int:
        return self.num_tiles * self.T

    def tile_starts(self) -> np.ndarray:
        return np.arange(self.num_tiles) * self.T


def tiled_propagate(step_fn: Callable, nt: int, T: int, state,
                    per_step_out: Callable = None):
    """Run `state = step_fn(state, t)` for t in [0, nt) in depth-T time tiles
    (the reference's two nested `lax.scan`s as Python loops).

    `per_step_out(state, t)` optionally collects a per-timestep output (a
    tensor or a tuple of them, e.g. receiver samples).  The last tile's
    padded steps (t >= nt) leave the state as it is and output nothing, as
    the reference's masked steps do, so results are independent of T;
    `step_fn` is not called there (a source has no wavelet sample at
    t >= nt).  Returns (final_state, outs) with outs stacked over the
    steps (the padded time axis truncated to nt), or None.
    """
    sched = TimeTileSchedule(nt, T)
    outs = []
    for t0 in sched.tile_starts():
        for t in range(int(t0), min(int(t0) + T, nt)):
            state = step_fn(state, t)
            if per_step_out is not None:
                outs.append(per_step_out(state, t))
    if per_step_out is None or not outs:
        return state, None
    if isinstance(outs[0], torch.Tensor):
        return state, torch.stack(outs)
    stacked = [torch.stack(o) for o in zip(*outs)]
    kind = type(outs[0])
    return state, kind(*stacked) if hasattr(kind, "_fields") else \
        kind(stacked)


@dataclasses.dataclass(frozen=True)
class TBPlan:
    """A (tile_x, tile_y, T) choice for the TB kernel."""

    tile: Tuple[int, int]
    T: int
    radius: int

    def to_dict(self) -> dict:
        """JSON-safe form (the survey plan cache's on-disk format)."""
        return {"tile": [int(t) for t in self.tile], "T": int(self.T),
                "radius": int(self.radius)}

    @classmethod
    def from_dict(cls, d: dict) -> "TBPlan":
        return cls(tile=tuple(int(t) for t in d["tile"]), T=int(d["T"]),
                   radius=int(d["radius"]))

    @property
    def halo(self) -> int:
        return self.T * self.radius

    def window(self, nz: int) -> Tuple[int, int, int]:
        tx, ty = self.tile
        return (tx + 2 * self.halo, ty + 2 * self.halo, nz)

    def overlap_factor(self) -> float:
        """Redundant-compute multiplier of the trapezoid: window area over
        tile area, averaged over the T steps actually computed
        (sum_k prod_d (tile_d + 2*(T-k)*r) / (T * prod_d tile_d))."""
        tx, ty = self.tile
        r = self.radius
        tot = 0.0
        for k in range(self.T):
            m = (self.T - k) * r
            tot += (tx + 2 * m) * (ty + 2 * m)
        return tot / (self.T * tx * ty)

    def vmem_bytes(self, nz: int, fields: int, dtype_bytes: int = 4) -> int:
        """Bytes of `fields` window-sized buffers (the reference's on-chip
        window; `fields` from `PHYSICS_COSTS[physics].fields`)."""
        wx, wy, wz = self.window(nz)
        return wx * wy * wz * dtype_bytes * fields

    def hbm_bytes_per_point_step(self, nz: int, read_fields: int = 4,
                                 write_fields: int = 1,
                                 dtype_bytes: int = 4) -> float:
        """Device-memory bytes moved per grid-point-timestep: the window is
        read and the centre written once per T steps."""
        tx, ty = self.tile
        wx, wy, _ = self.window(nz)
        read = wx * wy * nz * read_fields * dtype_bytes
        write = tx * ty * nz * write_fields * dtype_bytes
        return (read + write) / (tx * ty * nz * self.T)

    # --- time-nested pricing (inner T | outer T) ----------------------------

    def nested_compute_multiplier(self, block: Tuple[int, int],
                                  outer_T: int) -> float:
        """Redundant-compute multiplier when this plan's depth-T passes
        consume a depth-`outer_T * radius` exchanged halo: each pass pays
        its trapezoid overlap and the still-valid outer rim it advances."""
        bx, by = block
        tot = 0.0
        for p in nested_pass_geometry(block, self.tile, outer_T, self.T,
                                      self.radius):
            inner = TBPlan(self.tile, p.T, self.radius)
            tot += inner.overlap_factor() * p.grid[0] * p.grid[1] * p.T
        return tot / (bx * by * outer_T)

    def nested_hbm_bytes_per_point_step(self, block: Tuple[int, int],
                                        outer_T: int, nz: int,
                                        read_fields: int = 4,
                                        write_fields: int = 1,
                                        dtype_bytes: int = 4) -> float:
        """Traffic of the time-nested schedule per block-point-step: the
        per-pass flat traffic scaled by the pass grid, averaged over the
        outer depth."""
        bx, by = block
        tot = 0.0
        for p in nested_pass_geometry(block, self.tile, outer_T, self.T,
                                      self.radius):
            inner = TBPlan(self.tile, p.T, self.radius)
            tot += inner.hbm_bytes_per_point_step(
                nz, read_fields=read_fields, write_fields=write_fields,
                dtype_bytes=dtype_bytes) * p.grid[0] * p.grid[1] * p.T
        return tot / (bx * by * outer_T)

    # --- interconnect terms (the outer trapezoid of a sharded plan) ---------

    def exchange_bytes_per_tile(self, block: Tuple[int, int], nz: int,
                                fields: int = 1,
                                dtype_bytes: int = 4,
                                depths: Tuple[int, ...] = None) -> int:
        """Bytes a shard with local block (bx, by) sends per depth-T time
        tile: two (d, by, nz) strips in x and two (bx + 2d, d, nz) strips
        in y per exchanged field, at depth `halo` or the per-field
        `depths` (`fields` is then ignored)."""
        bx, by = block
        if depths is None:
            depths = (self.halo,) * fields
        return sum(2 * d * nz * (by + bx + 2 * d) * dtype_bytes
                   for d in depths)

    def exchange_seconds_per_point_step(self, block: Tuple[int, int],
                                        nz: int, fields: int,
                                        link_bw: float,
                                        link_latency: float,
                                        dtype_bytes: int = 4,
                                        depths: Tuple[int, ...] = None
                                        ) -> float:
        """Interconnect time per grid-point-timestep of one shard: one deep
        exchange (4 shifts per field that moves) amortized over T steps."""
        bx, by = block
        byts = self.exchange_bytes_per_tile(block, nz, fields, dtype_bytes,
                                            depths=depths)
        n_exchanged = (fields if depths is None
                       else sum(1 for d in depths if d > 0))
        coll = 4 * n_exchanged * link_latency
        return (byts / link_bw + coll) / (bx * by * nz * self.T)

    def split_step_overhead_per_point_step(self, block: Tuple[int, int],
                                           nz: int, r_step: int,
                                           flops_per_point: float,
                                           peak_flops: float) -> float:
        """Redundant compute of the overlapped exchange per point-step: the
        first in-tile step's four rim strips of width `halo + 2*r_step`,
        recomputed once the halo lands."""
        bx, by = block
        h = self.halo
        band = h + 2 * r_step
        strip_pts = 2 * band * ((bx + 2 * h) + (by + 2 * h)) * nz
        return strip_pts * flops_per_point / (peak_flops * bx * by * nz
                                              * self.T)


class SweepLog(dict):
    """The autotune sweep log: a {key: entry} dict plus `best_key`, the key
    the sweep's own strict-< argmin selected."""

    best_key = None


def autotune_plan(nz: int, radius: int, vmem_budget: Optional[int] = None,
                  tiles=(16, 32, 64, 128, 256), depths=(1, 2, 4, 8, 16),
                  fields: int = 5, dtype_bytes: int = 4,
                  flops_per_point: float = 40.0,
                  read_fields: int = None, write_fields: int = None,
                  peak_flops: float = 67e12, hbm_bw: float = 3.35e12,
                  mesh_block: Tuple[int, int] = None,
                  link_bw: float = 450e9, link_latency: float = 3e-6,
                  exchange_fields: int = None,
                  exchange_lags: Tuple[int, ...] = None,
                  sweep_overlap: bool = False,
                  outer_depths: Tuple[int, ...] = None,
                  ) -> Tuple[TBPlan, dict]:
    """Pick (tile, T[, outer T, overlap]) minimizing modeled time per
    point-step — the reference's sweep, term for term.

    Terms: compute = overlap_factor * flops_per_point / peak_flops, memory =
    hbm_bytes_per_point_step / hbm_bw, cost = max of the two.  With
    `mesh_block` the tile must divide the per-device block, the halo may
    not exceed it, and the exchange of the outer trapezoid is added
    (serialized: + comm; with `sweep_overlap` also max(cost, comm) + the
    split-step overhead).  With `outer_depths` every T_out that T divides is
    a candidate exchange depth, priced with the nested multipliers; log
    keys are then (tx, ty, T, T_out).  T = 1 stays in the sweep.

    Hardware defaults are the NVIDIA H100 SXM data sheet's: `peak_flops`
    67e12 (float32 outside the tensor cores), `hbm_bw` 3.35e12 bytes/s,
    `link_bw` 450e9 bytes/s (NVLink, one way).  `link_latency` 3e-6 s is an
    assumed order of magnitude for one NCCL send/receive between two cards
    of a host over NVLink, not a measurement.

    `vmem_budget` caps the bytes of one tile's `fields` windows.  The
    reference sizes it to the TPU's on-chip memory.  The port's kernels
    need no such cap: where a plan's working set does not fit a block's
    shared memory, the launch takes the schedule that keeps its windows in
    device-memory scratch (`kernels.stencil_tb.launch_plan`), so the
    default None means no cap; a caller that wants the reference's cap
    passes it (96 * 2**20).  What does bound a plan on the card is device
    memory, which depends on the grid and the shots a launch takes, not
    only on (tile, T): `plan_for_physics`'s `feasible` keeps the sweep to
    the plans that fit.
    """
    read_fields = fields - 1 if read_fields is None else read_fields
    write_fields = 1 if write_fields is None else write_fields
    exchange_fields = (write_fields if exchange_fields is None
                       else exchange_fields)
    if outer_depths is not None and mesh_block is None:
        raise ValueError("outer_depths (time-nested sweep) requires "
                         "mesh_block")
    best, best_cost, log = None, math.inf, SweepLog()
    for tx in tiles:
        for ty in tiles:
            for T in depths:
                plan = TBPlan((tx, ty), T, radius)
                vmem = plan.vmem_bytes(nz, fields, dtype_bytes)
                if vmem_budget is not None and vmem > vmem_budget:
                    continue
                if mesh_block is not None and (
                        tx > mesh_block[0] or ty > mesh_block[1]
                        or mesh_block[0] % tx or mesh_block[1] % ty):
                    continue  # infeasible inner tile on the device block
                # the flat schedule (T_out == T) is always a candidate
                outer_cands = ((T,) if outer_depths is None else
                               tuple(dict.fromkeys(
                                   (T,) + tuple(To for To in outer_depths
                                                if To % T == 0))))
                for T_out in outer_cands:
                    outer = TBPlan((tx, ty), T_out, radius)
                    if mesh_block is not None and \
                            outer.halo > min(mesh_block):
                        continue  # exchange deeper than the shard block
                    nested = outer_depths is not None
                    if nested:
                        comp = plan.nested_compute_multiplier(
                            mesh_block, T_out) * flops_per_point / peak_flops
                        mem = plan.nested_hbm_bytes_per_point_step(
                            mesh_block, T_out, nz, read_fields=read_fields,
                            write_fields=write_fields,
                            dtype_bytes=dtype_bytes) / hbm_bw
                    else:
                        comp = (plan.overlap_factor() * flops_per_point
                                / peak_flops)
                        mem = plan.hbm_bytes_per_point_step(
                            nz, read_fields=read_fields,
                            write_fields=write_fields,
                            dtype_bytes=dtype_bytes) / hbm_bw
                    entry = {"compute_s": comp, "memory_s": mem,
                             "overlap": plan.overlap_factor(),
                             "vmem_bytes": vmem}
                    cost = max(comp, mem)
                    if mesh_block is not None:
                        field_depths = None
                        if exchange_lags is not None:
                            field_depths = tuple(max(outer.halo - lag, 0)
                                                 for lag in exchange_lags)
                            entry["field_depths"] = field_depths
                        comm = outer.exchange_seconds_per_point_step(
                            mesh_block, nz, exchange_fields, link_bw,
                            link_latency, dtype_bytes=dtype_bytes,
                            depths=field_depths)
                        entry["comm_s"] = comm
                        entry["exchange_bytes"] = \
                            outer.exchange_bytes_per_tile(
                                mesh_block, nz, exchange_fields,
                                dtype_bytes, depths=field_depths)
                        serial = max(cost, 0.0) + comm
                        entry["overlap_exchange"] = False
                        if sweep_overlap:
                            split = outer.split_step_overhead_per_point_step(
                                mesh_block, nz, radius, flops_per_point,
                                peak_flops)
                            overlapped = max(cost, comm) + split
                            entry["split_s"] = split
                            if overlapped < serial:
                                entry["overlap_exchange"] = True
                                serial = overlapped
                        cost = serial
                    entry["cost_s"] = cost
                    if nested:
                        entry["outer_T"] = T_out
                        log[(tx, ty, T, T_out)] = entry
                    else:
                        log[(tx, ty, T)] = entry
                    if cost < best_cost:
                        best, best_cost = plan, cost
                        log.best_key = ((tx, ty, T, T_out) if nested
                                        else (tx, ty, T))
    if best is None:
        raise ValueError("no plan fits the VMEM budget"
                         + ("" if mesh_block is None
                            else " and per-device block"))
    return best, log


# ---------------------------------------------------------------------------
# Per-physics pricing
# ---------------------------------------------------------------------------

@dataclasses.dataclass(frozen=True)
class PhysicsCost:
    """Static per-physics quantities the cost model needs (numeric copies
    of `kernels.tb_physics.PHYSICS`, so core never imports kernels).

    state_fields / param_fields: carried wavefields / read-only model
    fields; evolved_fields: fields computed afresh each step;
    radius_mult: per-step halo growth in units of order // 2;
    flops_per_point: order -> FLOPs per grid-point-step (the propagator's
    `model_flops_per_step`); halo_lag_units: per-state-field exchange-depth
    reduction in units of order // 2.
    """

    name: str
    state_fields: int
    param_fields: int
    evolved_fields: int
    radius_mult: int
    flops_per_point: Callable[[int], float]
    halo_lag_units: Tuple[int, ...] = ()

    @property
    def fields(self) -> int:
        """Window count the reference prices: every state and param field
        plus one scratch."""
        return self.state_fields + self.param_fields + 1

    @property
    def read_fields(self) -> int:
        return self.state_fields + self.param_fields

    @property
    def write_fields(self) -> int:
        return self.state_fields

    def step_radius(self, order: int) -> int:
        return self.radius_mult * (order // 2)

    def exchange_lags(self, order: int) -> Tuple[int, ...]:
        """Per-state-field exchange-depth reductions in grid points."""
        lags = self.halo_lag_units or (0,) * self.state_fields
        return tuple(lag * (order // 2) for lag in lags)


def _flops(propagator: str):
    def f(order: int) -> float:
        from repro_torch.core.propagators import acoustic, elastic, tti
        mod = {"acoustic": acoustic, "elastic": elastic, "tti": tti}
        return float(mod[propagator].model_flops_per_step((1, 1, 1), order))
    return f


PHYSICS_COSTS = {
    # halo_lag_units in the state_fields order of tb_physics
    "acoustic": PhysicsCost("acoustic", state_fields=2, param_fields=2,
                            evolved_fields=1, radius_mult=1,
                            flops_per_point=_flops("acoustic"),
                            halo_lag_units=(1, 0)),
    "tti": PhysicsCost("tti", state_fields=4, param_fields=6,
                       evolved_fields=2, radius_mult=2,
                       flops_per_point=_flops("tti"),
                       halo_lag_units=(0, 2, 0, 2)),
    "elastic": PhysicsCost("elastic", state_fields=9, param_fields=4,
                           evolved_fields=9, radius_mult=2,
                           flops_per_point=_flops("elastic"),
                           halo_lag_units=(1, 1, 1, 0, 0, 0, 0, 0, 0)),
}


def plan_for_physics(physics: str, nz: int, order: int,
                     feasible: Optional[Callable[[TBPlan], bool]] = None,
                     **kwargs) -> Tuple[TBPlan, dict]:
    """`autotune_plan` priced for one physics: field counts, per-step halo
    radius, FLOP density and exchange lags from `PHYSICS_COSTS[physics]`;
    kwargs (vmem_budget, tiles, depths, peak_flops, hbm_bw, mesh_block,
    link_bw, link_latency, ...) pass through and override.

    `feasible`, when given, is asked about the candidates (single-level
    sweeps only) and the plan is the cheapest it accepts, first in sweep
    order among equals as the sweep's own argmin; the log keeps every
    candidate and its `best_key` names that plan.  The survey engine
    passes whether a batch at the plan fits the card's memory."""
    pc = PHYSICS_COSTS[physics]
    args = dict(fields=pc.fields, read_fields=pc.read_fields,
                write_fields=pc.write_fields,
                exchange_fields=pc.state_fields,
                exchange_lags=pc.exchange_lags(order),
                flops_per_point=pc.flops_per_point(order))
    args.update(kwargs)
    radius = pc.step_radius(order)
    plan, log = autotune_plan(nz, radius, **args)
    if feasible is None or feasible(plan):
        return plan, log
    if args.get("outer_depths") is not None:
        raise ValueError("feasible takes single-level sweeps only")
    best = None
    for key, entry in log.items():
        cand = TBPlan((key[0], key[1]), key[2], radius)
        if (best is None or entry["cost_s"] < best[0]) and feasible(cand):
            best = (entry["cost_s"], key, cand)
    if best is None:
        raise ValueError(f"no {physics} plan of the sweep passes the "
                         "caller's feasibility check")
    log.best_key = best[1]
    return best[2], log


# ---------------------------------------------------------------------------
# Hierarchical two-level plan (outer shard trapezoid x inner kernel tile)
# ---------------------------------------------------------------------------

@dataclasses.dataclass(frozen=True)
class HierPlan:
    """Joint two-level temporal-blocking plan for one shard.

    inner:         the kernel-tile plan inside the per-shard block;
                   `inner.T` is the inner time depth (one kernel pass
                   advances the exchanged block `inner.T` steps).
    outer_T:       the exchange depth, a multiple of `inner.T`;
                   `outer_T / inner.T` inner passes consume one deep
                   exchange over pass-by-pass-shrinking windows
                   (`nested_pass_geometry`).  `outer_T == inner.T` is the
                   flat schedule.
    block:         the per-shard (bx, by) block the outer trapezoid
                   exchanges around.
    overlap:       whether the first in-tile step runs as the split
                   interior/rim schedule (pass 0 only).
    field_depths:  per-state-field exchange depths (grid points); the
                   uniform depth is `halo`.
    """

    inner: TBPlan
    outer_T: int
    block: Tuple[int, int]
    overlap: bool
    field_depths: Tuple[int, ...]

    def to_dict(self) -> dict:
        """JSON-safe form (the plan cache's on-disk format)."""
        return {"inner": self.inner.to_dict(), "outer_T": int(self.outer_T),
                "block": [int(b) for b in self.block],
                "overlap": bool(self.overlap),
                "field_depths": [int(d) for d in self.field_depths]}

    @classmethod
    def from_dict(cls, d: dict) -> "HierPlan":
        return cls(inner=TBPlan.from_dict(d["inner"]),
                   outer_T=int(d["outer_T"]),
                   block=tuple(int(b) for b in d["block"]),
                   overlap=bool(d["overlap"]),
                   field_depths=tuple(int(x) for x in d["field_depths"]))

    @property
    def T(self) -> int:
        """The exchange depth (what `DistTBPlan.T` executes)."""
        return self.outer_T

    @property
    def outer(self) -> TBPlan:
        """The outer trapezoid as a TBPlan (exchange-level pricing)."""
        return TBPlan(self.inner.tile, self.outer_T, self.inner.radius)

    @property
    def halo(self) -> int:
        """Exchange depth in grid points (outer_T * r_step)."""
        return self.outer.halo

    def vmem_bytes(self, nz: int, fields: int, dtype_bytes: int = 4) -> int:
        """Bytes of the inner window: sized by `inner.T`, not the exchange
        depth."""
        return self.inner.vmem_bytes(nz, fields, dtype_bytes)

    def exchange_bytes(self, nz: int, dtype_bytes: int = 4) -> int:
        """Bytes per deep exchange with the per-field depths."""
        return self.outer.exchange_bytes_per_tile(
            self.block, nz, dtype_bytes=dtype_bytes,
            depths=self.field_depths)

    def exchange_bytes_uniform(self, nz: int, dtype_bytes: int = 4) -> int:
        """The uniform-depth baseline the per-field scheme is priced
        against."""
        return self.outer.exchange_bytes_per_tile(
            self.block, nz, fields=len(self.field_depths),
            dtype_bytes=dtype_bytes)


def plan_hierarchy(physics: str, nz: int, order: int,
                   block: Tuple[int, int], **kwargs
                   ) -> Tuple[HierPlan, dict]:
    """Jointly autotune the outer exchange depth, inner (tile, T) and
    overlap for one per-shard block: `plan_for_physics(...,
    mesh_block=block, sweep_overlap=True, outer_depths=depths)` with the
    winning sweep entry re-packaged as a `HierPlan` (log keys
    `(tx, ty, inner_T, outer_T)`); `distributed.halo.dist_plan_from_hier`
    turns it into a `DistTBPlan`."""
    kwargs.setdefault("sweep_overlap", True)
    kwargs.setdefault("outer_depths", kwargs.get("depths", (1, 2, 4, 8, 16)))
    pc = PHYSICS_COSTS[physics]
    plan, log = plan_for_physics(physics, nz, order, mesh_block=block,
                                 **kwargs)
    # the sweep's own winner over the full 4-tuple key space (the returned
    # TBPlan carries only the inner level)
    key = log.best_key
    entry = log[key]
    tx, ty, inner_T = key[0], key[1], key[2]
    outer_T = entry.get("outer_T", inner_T)
    inner = TBPlan((tx, ty), inner_T, pc.step_radius(order))
    outer_halo = outer_T * pc.step_radius(order)
    depths = entry.get("field_depths",
                       tuple(max(outer_halo - lag, 0)
                             for lag in pc.exchange_lags(order)))
    return (HierPlan(inner=inner, outer_T=outer_T,
                     block=(int(block[0]), int(block[1])),
                     overlap=bool(entry.get("overlap_exchange", False)),
                     field_depths=tuple(depths)),
            log)
