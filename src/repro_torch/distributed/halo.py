"""Sharded multi-physics temporally-blocked execution layer (port of
`repro.distributed.halo`; DESIGN.md §4).

After grid alignment, injection is local to whichever shard owns (or
halos) an affected point, so a depth-T time tile needs exactly one
neighbour exchange of depth H = T * r_step: temporal blocking applied to
communication.  Two trapezoids nest as one hierarchical plan (`DistTBPlan`
carrying an inner `TBPlan`, searched jointly by
`core.temporal_blocking.plan_hierarchy`):

    outer trapezoid   shard block + deep exchanged halo, advanced T steps
                      between exchanges.  The exchange is per field
                      (`TBPhysics.field_halo_depths`): fields the update
                      reads only pointwise at the rim ship a shallower
                      strip, zero-padded back to the uniform window.
    inner trapezoid   the per-shard schedule over the exchanged block,
                      tiled by `inner_plan.tile`: the CUDA TB kernel with
                      the shard's domain mask (``inner="cuda"``, kernel
                      B1c: one launch per pass for all shards on a card) or
                      its plain version (``inner="torch"``, the reference's
                      jnp branch: the same per-window schedule in torch) —
                      the executors of `kernels.ops.EXECUTORS`.

`inner_plan.T` may be below the exchange depth T: then ceil(T / inner.T)
passes consume one deep exchange over windows that shrink pass by pass,
each on a grid rounded up to the inner tile, whose garbage band the crop
discards (the params carry `param_fills` there).  With ``overlap=True`` the
first step splits into an interior update of the un-exchanged block plus
four rim strips, and steps 2..T run through the inner executor.

The reference runs one program over a device mesh (`shard_map`,
`lax.ppermute`).  The port runs a `launch.mesh.ShardMesh` two ways:

  single controller  one process holds each shard as a tensor on its mesh
                     device, and a neighbour shift is a copy between shard
                     tensors — a device-local copy when the shards share a
                     card;
  one shard a rank   on a rank's view of the mesh (`mesh.process_group`,
                     `launch.mesh.make_rank_mesh`) each process holds its
                     own block and a shift is a message between ranks
                     (`rank_shift_fns` over `DataParallel.exchange`): the
                     reference's SPMD program, one process a shard.

A sharded field is a shard grid: a list of px rows of py tensors (on a
rank's view, this rank's block and None elsewhere).  The shift functions
stay injectable (`shift_fns`), as in the reference.  Missing neighbours
(the domain edge) give zeros, the Dirichlet convention of the reference and
the kernel; out-of-domain cells are re-masked every in-window step.

Receivers are recorded once, by the owning shard's owning tile, as partial
per-step samples segment-summed by receiver id (`ops.combine_rec_partials`;
across ranks each rank sums its own, then one all-reduce adds the ranks');
`nt % T != 0` runs a shallower remainder tile whose params and mask are a
crop of the main tiles' exchanged ones (no second param exchange).
"""
from __future__ import annotations

import dataclasses
from typing import Dict, NamedTuple, Optional, Tuple

import numpy as np
import torch
import torch.nn.functional as F

from repro_torch._device import as_tensor
from repro_torch.core import sources as src_mod
from repro_torch.core import tables as tables_mod
from repro_torch.core.temporal_blocking import (HierPlan, TBPassGeom, TBPlan,
                                                nested_pass_geometry)
from repro_torch.kernels import ops as ops_mod
from repro_torch.kernels import stencil_tb
from repro_torch.kernels import tb_physics as phys
from repro_torch.launch.mesh import ShardMesh
from repro_torch.telemetry import spans as _spans


# ---------------------------------------------------------------------------
# Neighbour exchange on shard grids
# ---------------------------------------------------------------------------

def _neighbour_strips(blocks, h: int, dim: int, step: int):
    """Per shard, `h` slices along `dim` of its neighbour `step` (-1: the
    lower one, its last slices; +1: the upper one, its first slices) along
    the mesh axis of `dim`, copied to the shard's device; zeros at the
    domain edge (Dirichlet)."""
    px, py = len(blocks), len(blocks[0])
    out = []
    for i in range(px):
        row = []
        for j in range(py):
            x = blocks[i][j]
            ni, nj = (i + step, j) if dim == 0 else (i, j + step)
            if not (0 <= ni < px and 0 <= nj < py):
                shape = list(x.shape)
                shape[dim] = h
                row.append(x.new_zeros(shape))
                continue
            nb = blocks[ni][nj]
            lo = nb.shape[dim] - h if step < 0 else 0
            row.append(nb.narrow(dim, lo, h).to(x.device))
        out.append(row)
    return out


def shift_from_low(blocks, h: int, dim: int):
    """Every shard receives the LAST h slices of its lower neighbour."""
    return _neighbour_strips(blocks, h, dim, -1)


def shift_from_high(blocks, h: int, dim: int):
    """Every shard receives the FIRST h slices of its upper neighbour."""
    return _neighbour_strips(blocks, h, dim, +1)


def rank_shift_fns(mesh: ShardMesh):
    """The `(from_low, from_high)` pair of a rank's view of `mesh`: this
    rank's strip goes to its neighbour along the mesh axis of `dim` and
    the neighbour's comes back (`DataParallel.exchange`, one message each
    way), zeros at the domain edge.  Each message of a shift carries the
    tag of its (dim, direction), and every rank finishes a shift before it
    starts the next, so the x round, then the y round (which carries the
    x halo), can neither deadlock nor cross."""
    group = mesh.process_group
    px, py = mesh.pgrid
    i, j = divmod(group.rank, py)

    def shift(blocks, h, dim, step):
        x = blocks[i][j]
        n, c = ((px, i), (py, j))[dim]
        stride = py if dim == 0 else 1
        shape = list(x.shape)
        shape[dim] = h
        sends, recvs = [], []
        if 0 <= c - step < n:       # the neighbour this shard's strip feeds
            lo = x.shape[dim] - h if step < 0 else 0
            sends.append((group.rank - step * stride, x.narrow(dim, lo, h)))
        if 0 <= c + step < n:       # the neighbour whose strip it takes
            recvs.append((group.rank + step * stride, shape, x.dtype))
        got = group.exchange(sends, recvs, tag=2 * dim + (step > 0))
        strip = got[0] if got else x.new_zeros(shape)
        return [[strip if (a, b) == (i, j) else None for b in range(py)]
                for a in range(px)]

    return (lambda blocks, h, dim: shift(blocks, h, dim, -1),
            lambda blocks, h, dim: shift(blocks, h, dim, +1))


def mesh_shift_fns(mesh: Optional[ShardMesh]):
    """The shifts a mesh runs: `rank_shift_fns` on a rank's view, None
    (the copies above) otherwise."""
    if mesh is not None and mesh.process_group is not None:
        return rank_shift_fns(mesh)
    return None


def halo_exchange(blocks, h: int, dim: int, shift_fns=None):
    """Pad every shard's block with depth-h halos from both neighbours
    along `dim`.  `shift_fns` (default: the copies above) injects the two
    strip providers `(from_low, from_high)`, each taking and returning a
    shard grid (None where the process holds no block)."""
    from_low, from_high = shift_fns or (shift_from_low, shift_from_high)
    lo = from_low(blocks, h, dim)
    hi = from_high(blocks, h, dim)
    return [[None if b is None else torch.cat([lo[i][j], b, hi[i][j]],
                                              dim=dim)
             for j, b in enumerate(row)] for i, row in enumerate(blocks)]


def halo_exchange_2d(blocks, h: int, shift_fns=None,
                     mesh: Optional[ShardMesh] = None):
    """x then y (the second exchange carries the x-halo, so the corners are
    filled); one exchange round, counted on `mesh`.  Without `shift_fns`,
    the mesh's own (`mesh_shift_fns`)."""
    if mesh is not None:
        mesh.exchange_rounds += 1
    shift_fns = shift_fns or mesh_shift_fns(mesh)
    blocks = halo_exchange(blocks, h, 0, shift_fns=shift_fns)
    return halo_exchange(blocks, h, 1, shift_fns=shift_fns)


def exchange_to_depth(blocks, depth: int, h: int, shift_fns=None,
                      mesh: Optional[ShardMesh] = None):
    """Exchange a depth-`depth` halo, then zero-pad out to the uniform
    window depth `h` — the per-field deep exchange.  Cells in the zero band
    only ever feed values the trapezoid discards (`TBPhysics.halo_lags`);
    `depth == 0` runs no exchange at all."""
    if depth > 0:
        blocks = halo_exchange_2d(blocks, depth, shift_fns=shift_fns,
                                  mesh=mesh)
    if h > depth:
        pad = h - depth
        blocks = [[None if b is None else F.pad(b, (0, 0, pad, pad, pad, pad))
                   for b in row] for row in blocks]
    return blocks


# ---------------------------------------------------------------------------
# Plan
# ---------------------------------------------------------------------------

class _StepSpec(NamedTuple):
    """The slice of `TBKernelSpec` a `TBPhysics.update` reads."""

    dt: float
    spacing: Tuple[float, float, float]
    order: int


class DistTBPlan(NamedTuple):
    """Static setup of the sharded temporally-blocked propagator.

    `inner_plan` is the inner level: its tile tiles the shard block inside
    the per-shard schedule and its T is the inner time depth, any depth up
    to the exchange depth `T` (time-nested passes when below).  None means
    one flat pass with one tile covering the block.  `inner` is the
    per-shard executor: ``"cuda"`` (the kernel; every mesh device must be a
    card) or ``"torch"`` (its plain version, on any device).  Build from
    the joint autotuner with `dist_plan_from_hier`.
    """

    mesh: ShardMesh
    grid_shape: Tuple[int, int, int]
    physics: phys.TBPhysics = phys.ACOUSTIC
    order: int = 4
    T: int = 2
    dt: float = 1e-3
    spacing: Tuple[float, float, float] = (10.0, 10.0, 10.0)
    inner: str = "cuda"
    inner_plan: Optional[TBPlan] = None
    overlap: bool = False       # overlapped (split-first-step) exchange
    per_field_halo: bool = True  # per-field exchange depths (halo_lags)

    @property
    def r_step(self) -> int:
        """Per-timestep halo consumption (order//2 acoustic, order TTI and
        elastic)."""
        return self.physics.step_radius(self.order)

    @property
    def halo(self) -> int:
        return self.T * self.r_step

    @property
    def pgrid(self) -> Tuple[int, int]:
        return self.mesh.pgrid

    @property
    def block(self) -> Tuple[int, int]:
        """Per-shard local block (bx, by)."""
        px, py = self.pgrid
        return (self.grid_shape[0] // px, self.grid_shape[1] // py)

    @property
    def inner_tile(self) -> Tuple[int, int]:
        return self.inner_plan.tile if self.inner_plan is not None \
            else self.block

    @property
    def inner_T(self) -> int:
        return self.inner_plan.T if self.inner_plan is not None else self.T

    def field_depths(self, T_depth: int) -> Tuple[int, ...]:
        """Per-state-field exchange depth for a depth-`T_depth` tile."""
        if not self.per_field_halo:
            h = T_depth * self.r_step
            return (h,) * len(self.physics.state_fields)
        return self.physics.field_halo_depths(T_depth, self.order)

    def validate(self):
        nx, ny, _ = self.grid_shape
        px, py = self.pgrid
        if nx % px or ny % py:
            raise ValueError(
                f"grid ({nx}, {ny}) must divide by the ({px}, {py}) mesh")
        bx, by = self.block
        if self.halo > min(bx, by):
            raise ValueError(
                f"halo depth T*r_step={self.halo} exceeds local block "
                f"({bx}, {by}); single-hop neighbor exchange requires "
                f"T*r_step <= block — lower T or use a coarser decomposition")
        if self.inner not in ops_mod.EXECUTORS:
            raise ValueError(f"unknown inner schedule {self.inner!r}")
        if self.inner == "cuda" and any(d.type != "cuda"
                                        for d in self.mesh.devices):
            raise ValueError(
                f"inner='cuda' runs the CUDA kernel, but the mesh holds "
                f"{[str(d) for d in self.mesh.devices]}; use inner='torch' "
                f"off the card")
        if self.inner_plan is not None:
            itx, ity = self.inner_plan.tile
            if bx % itx or by % ity:
                raise ValueError(
                    f"inner tile {self.inner_plan.tile} must divide the "
                    f"shard block ({bx}, {by})")
            if not 1 <= self.inner_plan.T <= self.T:
                raise ValueError(
                    f"inner plan depth T={self.inner_plan.T} must lie in "
                    f"[1, outer T={self.T}]: ceil(T / inner_T) inner "
                    f"passes consume one deep exchange (time-nested "
                    f"schedule)")


def dist_plan_from_hier(mesh: ShardMesh, grid_shape: Tuple[int, int, int],
                        physics: phys.TBPhysics, order: int,
                        hier: HierPlan, dt: float,
                        spacing: Tuple[float, float, float],
                        inner: str = "cuda", **kwargs) -> DistTBPlan:
    """The executable `DistTBPlan` of a jointly autotuned `HierPlan` (outer
    T and overlap from the outer level, tile from the inner one)."""
    return DistTBPlan(mesh=mesh, grid_shape=grid_shape, physics=physics,
                      order=order, T=hier.T, dt=dt, spacing=spacing,
                      inner=inner, inner_plan=hier.inner,
                      overlap=hier.overlap, **kwargs)


def _local_domain_mask(plan: DistTBPlan, h: int, shard: Tuple[int, int],
                       device, dtype=torch.float32) -> torch.Tensor:
    """1.0 inside the global domain for the depth-h halo-padded block of
    shard (i, j): (bx + 2h, by + 2h, 1), z-invariant by construction."""
    nx, ny, _ = plan.grid_shape
    bx, by = plan.block
    gx = shard[0] * bx - h + torch.arange(bx + 2 * h, device=device)
    gy = shard[1] * by - h + torch.arange(by + 2 * h, device=device)
    ok = (((gx >= 0) & (gx < nx))[:, None]
          & ((gy >= 0) & (gy < ny))[None, :])
    return ok.to(dtype)[:, :, None]


# ---------------------------------------------------------------------------
# Per-shard inner trapezoids
# ---------------------------------------------------------------------------

def _run_pass(plan: DistTBPlan, geom: TBPassGeom, state_pads, param_pads,
              dom_pad, h_full: int, s_coords, s_vals, r_coords, r_w,
              kept: Optional[dict] = None):
    """Advance ONE inner pass of the time-nested schedule for S shard rows
    on one device, in one executor call (one kernel launch).

    The incoming state, one (S, bx + 2 d_in, by + 2 d_in, nz) tensor a
    field, is the shard block padded to the remaining halo depth
    `geom.d_in`; the pass advances `geom.T` steps over the region that
    stays valid afterwards (`block + 2 d_out`, rounded up to the inner tile
    with a garbage band the crop discards) and returns the state cropped to
    depth `geom.d_out`.  `param_pads` (S, ., ., nz) and `dom_pad`
    (S, ., ., 1) stay at the full exchange depth `h_full` and are cut to the
    pass window here; the params' round-up band carries `param_fills`.

    Tables are per pass-local tile: s_coords (S, ntiles, cap, 3)
    window-local, s_vals (S, ntiles, geom.T, cap), r_coords/r_w likewise.
    `kept`, a dict the caller keeps for this pass over its tiles, holds
    the kernel's copies of the pass's params (`stencil_tb.param_copies`),
    made at the first launch: the params do not change over a run.
    Returns (state tuple at depth d_out, rec partials
    (S, ntiles, geom.T, capr, chan)).
    """
    physics = plan.physics
    bx, by = plan.block
    S, nz = state_pads[0].shape[0], state_pads[0].shape[3]
    cx, cy = geom.grid
    keep = (bx + 2 * geom.d_out, by + 2 * geom.d_out)
    ex, ey = cx - keep[0], cy - keep[1]
    fills = dict(physics.param_fills)

    def fit(a, crop, fill):
        if crop:
            a = a[:, crop:a.shape[1] - crop, crop:a.shape[2] - crop]
        if ex or ey:
            a = F.pad(a, (0, 0, 0, ey, 0, ex), value=fill)
        return a.contiguous()

    crop_p = h_full - geom.d_in
    spads = tuple(fit(a, 0, 0.0) for a in state_pads)
    ppads = tuple(fit(a, crop_p, fills.get(f, 0.0))
                  for f, a in zip(physics.param_fields, param_pads))
    # the kernels take the mask in float32 whatever the storage dtype (a
    # 0/1 mask: the same values)
    dom = fit(dom_pad, crop_p, 0.0)[..., 0].to(torch.float32).contiguous()
    spec = ops_mod.pass_inner_spec(
        geom, nz, plan.order, float(plan.dt),
        tuple(float(s) for s in plan.spacing), s_coords.shape[-2],
        r_coords.shape[-2], spads[0].dtype, physics)
    copies = None
    if plan.inner == "cuda" and kept is not None:
        if "param_copies" not in kept:
            kept["param_copies"] = stencil_tb.param_copies(spec, physics,
                                                           ppads)
        copies = kept["param_copies"]
    # the receiver weights in the state's dtype, as the single-device
    # tables hold them (the kernels take them so)
    new, rec = ops_mod.EXECUTORS[plan.inner](
        spec, physics, spads, ppads, s_coords, s_vals, r_coords,
        r_w.to(spads[0].dtype), dom=dom, param_copies=copies)
    new = tuple(a[:, :keep[0], :keep[1]] for a in new)
    rec = rec.reshape(S, -1, geom.T, rec.shape[-2], rec.shape[-1])
    return new, rec


def _split_first_step(plan: DistTBPlan, sspec: _StepSpec, h: int,
                      state_blocks, state_pads, param_pads, dom,
                      s_coords, s_vals0, r_coords, r_w):
    """The overlapped first step of a deep tile, for one shard.

    The exchanged halo is needed only within `h + r_step` of the window
    edge at step 1, so the step splits into

      interior   `physics.update` on the zero-padded LOCAL block (no data
                 dependency on the exchange); valid at >= h + r_step from
                 the window edge;
      rim strips four band updates of width `h + 2 r_step` cut from the
                 exchanged window, each valid (after an r_step crop at cut
                 edges) over the rim the interior cannot cover.

    The strips are written over the interior result; then the mask,
    injection and receiver partials run as in the first in-window step, on
    shard-level tables.  `dom` is (wx, wy, 1).

    Returns (stitched padded state tuple, rec partials (1, capr, chan)).
    """
    physics = plan.physics
    r = plan.r_step
    sd = dict(zip(physics.state_fields, state_pads))
    pd = dict(zip(physics.param_fields, param_pads))
    wx, wy = state_pads[0].shape[0], state_pads[0].shape[1]
    bx = wx - 2 * h

    def upd(slx, sly):
        st_ = {f: a[slx, sly] for f, a in sd.items()}
        pr_ = {f: a[slx, sly] for f, a in pd.items()}
        dm = dom[slx, sly]
        return physics.update(st_, pr_, sspec, lambda a: a * dm)

    # interior: independent of the exchange (zero-padded local block)
    interior = {f: F.pad(b, (0, 0, h, h, h, h))
                for f, b in zip(physics.state_fields, state_blocks)}
    out = physics.update(interior, pd, sspec, lambda a: a * dom)

    band = h + 2 * r
    xlo = upd(slice(0, band), slice(None))
    xhi = upd(slice(wx - band, wx), slice(None))
    for f in out:
        out[f][:h + r] = xlo[f][:h + r]
        out[f][wx - h - r:] = xhi[f][r:]
    if bx > 2 * r:  # a middle x range exists: cover its y rims
        ylo = upd(slice(h, wx - h), slice(0, band))
        yhi = upd(slice(h, wx - h), slice(wy - band, wy))
        for f in out:
            out[f][h + r:wx - h - r, :h + r] = ylo[f][r:bx - r, :h + r]
            out[f][h + r:wx - h - r, wy - h - r:] = yhi[f][r:bx - r, r:]

    # the post-step sequence of the first in-window step
    for f in physics.evolved_fields:
        if f not in physics.premasked_fields:
            out[f] = out[f] * dom
    sidx = tuple(s_coords.long().T)
    for f in physics.inject_fields:
        out[f] = out[f].index_put(sidx, s_vals0.to(out[f].dtype),
                                  accumulate=True)
    ridx = tuple(r_coords.long().T)
    rec = torch.stack([(arr[ridx] * r_w).to(arr.dtype)
                       for arr in physics.record(out)], dim=-1)
    return tuple(out[f] for f in physics.state_fields), rec[None]


# ---------------------------------------------------------------------------
# Host-side per-pass table binning
# ---------------------------------------------------------------------------

def _shard_axis_ranges(v, b, n_shard, geom, axis):
    """(shard, tile) pairs along ONE axis whose window [shard*b + tile*t
    - d - hp, ... + t + 2*hp) (or centre, for depth-1 passes) contains
    coordinate v — `tables.axis_tile_range` applied at shard granularity,
    then at tile granularity inside each covering shard.  O(pairs)."""
    t = geom.tile[axis]
    n_tile = geom.ntiles[axis]
    hp, d = geom.halo, geom.d_out
    pad = 0 if geom.include_halo else hp     # centre binning: shrink by hp
    span = t + 2 * (hp - pad)
    s_lo, s_hi = tables_mod.axis_tile_range(
        v, -(d + hp - pad), b, n_shard, (n_tile - 1) * t + span)
    out = []
    for s in range(s_lo, s_hi + 1):
        lo0 = s * b - d - hp + pad           # shard's tile-0 window lo
        k_lo, k_hi = tables_mod.axis_tile_range(v, lo0, t, n_tile, span)
        for k in range(k_lo, k_hi + 1):
            out.append((s, k))
    return out


def _pass_source_tables(plan: DistTBPlan, g, geom: TBPassGeom,
                        cap: Optional[int] = None):
    """Sharded (px, py, ntiles, ...) source tables for one inner pass, host
    numpy.

    The pass's tile grid is per shard and shifted by the remaining depth
    `geom.d_out` off the shard origin, so neighbouring shards' windows
    overlap: every affected point is duplicated into every (shard, tile)
    window that holds it (paper Fig. 4b); depth-1 passes bin by tile
    centre.  `cap` bounds entries per (shard, tile); None auto-sizes, a
    too-small cap raises the overflow error naming the (shard, tile).

    Returns (coords (px, py, ntl, cap, 3) window-local int32,
             sid    (px, py, ntl, cap) int32, -1 padding,
             mask   (px, py, ntl, cap) float32 1/0 validity — the physical
             injection scale is gathered on the device from sid).
    """
    px, py = plan.pgrid
    ntx, nty = geom.ntiles
    ntl = ntx * nty
    if g is None:
        return (np.zeros((px, py, ntl, 1, 3), np.int32),
                np.full((px, py, ntl, 1), -1, np.int32),
                np.zeros((px, py, ntl, 1), np.float32))
    bx, by = plan.block
    tx, ty = geom.tile
    hp = geom.halo
    d = geom.d_out
    pts = src_mod.to_numpy(g.points)

    pairs = []  # (flat (shard, tile) id, point_idx)
    for p in range(pts.shape[0]):
        x, y = int(pts[p, 0]), int(pts[p, 1])
        for sx, ti in _shard_axis_ranges(x, bx, px, geom, 0):
            for sy, tj in _shard_axis_ranges(y, by, py, geom, 1):
                pairs.append(((sx * py + sy) * ntl + ti * nty + tj, p))

    def tile_name(flat):
        s, t = divmod(flat, ntl)
        return f"(shard {divmod(s, py)}, tile {t})"

    _, slot, cap = tables_mod.pack_slots(pairs, px * py * ntl, cap,
                                         "pass source table", tile_name)
    coords = np.zeros((px, py, ntl, cap, 3), np.int32)
    sid = np.full((px, py, ntl, cap), -1, np.int32)
    mask = np.zeros((px, py, ntl, cap), np.float32)
    for (flat, p), k in zip(pairs, slot):
        (sx, sy), t = divmod(flat // ntl, py), flat % ntl
        ti, tj = t // nty, t % nty
        ox = sx * bx + ti * tx - d - hp
        oy = sy * by + tj * ty - d - hp
        coords[sx, sy, t, k] = (pts[p, 0] - ox, pts[p, 1] - oy, pts[p, 2])
        sid[sx, sy, t, k] = p
        mask[sx, sy, t, k] = 1.0
    return coords, sid, mask


def _pass_receiver_tables(plan: DistTBPlan, receivers, geom: TBPassGeom,
                          cap: Optional[int] = None):
    """Sharded receiver gather entries for one inner pass, host numpy.

    Each (receiver, grid point) pair is recorded exactly once per step: by
    the shard that OWNS the point and the pass tile whose centre holds it
    (owned points sit deep enough inside every pass window to be valid at
    every in-pass step).  `cap` follows `tables.pack_slots`.  Returns
    (coords (px, py, ntl, cap, 3), weight, rid) — rid is what
    `_combine_pass` segment-sums the partials by.
    """
    px, py = plan.pgrid
    ntx, nty = geom.ntiles
    ntl = ntx * nty
    if receivers is None:
        return (np.zeros((px, py, ntl, 1, 3), np.int32),
                np.zeros((px, py, ntl, 1), np.float32),
                np.full((px, py, ntl, 1), -1, np.int32))
    idx = src_mod.to_numpy(receivers.indices).reshape(-1, 3)
    w = src_mod.to_numpy(receivers.weights).astype(np.float64).reshape(-1)
    rids = np.repeat(np.arange(receivers.num, dtype=np.int32),
                     receivers.indices.shape[1])
    keep = w != 0.0
    idx, w, rids = idx[keep], w[keep], rids[keep]
    bx, by = plan.block
    tx, ty = geom.tile
    hp = geom.halo
    d = geom.d_out
    sx = idx[:, 0] // bx
    sy = idx[:, 1] // by
    cxl = idx[:, 0] - sx * bx + d        # pass-grid-local x in [d, bx + d)
    cyl = idx[:, 1] - sy * by + d
    ti, tj = cxl // tx, cyl // ty
    t = ti * nty + tj
    flat = (sx * py + sy) * ntl + t

    def tile_name(fl):
        s, tt = divmod(fl, ntl)
        return f"(shard {divmod(s, py)}, tile {tt})"

    _, slot, cap = tables_mod.pack_slots(
        list(zip(flat.tolist(), range(idx.shape[0]))), px * py * ntl, cap,
        "pass receiver table", tile_name)
    coords = np.zeros((px, py, ntl, cap, 3), np.int32)
    weight = np.zeros((px, py, ntl, cap), np.float32)
    rid = np.full((px, py, ntl, cap), -1, np.int32)
    for p in range(idx.shape[0]):
        k = slot[p]
        coords[sx[p], sy[p], t[p], k] = (cxl[p] - ti[p] * tx + hp,
                                         cyl[p] - tj[p] * ty + hp,
                                         idx[p, 2])
        weight[sx[p], sy[p], t[p], k] = w[p]
        rid[sx[p], sy[p], t[p], k] = rids[p]
    return coords, weight, rid


class _RidTab(NamedTuple):
    """The slice of a receiver table `ops.combine_rec_partials` reads."""

    rid: torch.Tensor


def _combine_pass(parts, rid, nrec: int):
    """(px, py, ntl, T, capr, chan) shard partials + the rid table ->
    (T, nrec, chan) per-step samples (segment sum over receiver ids)."""
    px, py, ntl, T, capr, chan = parts.shape
    flat = parts.reshape(1, px * py * ntl, 1, T, capr, chan)
    rid = torch.as_tensor(rid, device=parts.device)
    tab = _RidTab(rid=rid.reshape(1, px * py * ntl, capr))
    return ops_mod.combine_rec_partials(flat, tab, nrec)[0]


def _gather_vals(win, sid, smask, scale_vec, dtype):
    """(T, npts) decomposed wavelets -> per-tile (S, ntl, T, cap) injection
    values, the scale gathered on the device (no host sync)."""
    safe = sid.clamp(min=0)
    sv = win[:, safe] * (scale_vec[safe] * smask)[None]   # (T, S, ntl, cap)
    return sv.permute(1, 2, 0, 3).contiguous().to(dtype)


# ---------------------------------------------------------------------------
# Sharded driver
# ---------------------------------------------------------------------------

def _split_blocks(a, plan: DistTBPlan):
    """A global (nx, ny, ...) array as a shard grid of blocks, each on its
    shard's device.  On a rank's view only this rank's block is cut out
    (wherever `a` lies, a numpy array or a tensor) and moved, contiguous:
    the device never holds the whole grid; the grid holds None
    elsewhere."""
    px, py = plan.pgrid
    bx, by = plan.block
    k = plan.mesh.rank
    if k is not None:
        i, j = divmod(k, py)
        b = a[i * bx:(i + 1) * bx, j * by:(j + 1) * by]
        if isinstance(b, np.ndarray):
            b = np.ascontiguousarray(b)
        b = as_tensor(b, plan.mesh.device_of(k)).contiguous()
        return [[b if (r, c) == (i, j) else None for c in range(py)]
                for r in range(px)]
    return [[a[i * bx:(i + 1) * bx, j * by:(j + 1) * by]
             .to(plan.mesh.device_of(i * py + j)) for j in range(py)]
            for i in range(px)]


def _join_blocks(blocks, device) -> torch.Tensor:
    """A shard grid of blocks as one global tensor on `device`."""
    return torch.cat([torch.cat([b.to(device) for b in row], dim=1)
                      for row in blocks], dim=0)


def _rows(arr, ks, device, dtype=None):
    """Rows `ks` (flat shard ids) of a host (px, py, ...) table, as one
    tensor on `device`."""
    flat = arr.reshape((-1,) + arr.shape[2:])[ks]
    return torch.as_tensor(flat, dtype=dtype, device=device)


def _in_shard_order(per_group, groups, device):
    """Per-group tensors of rows -> one tensor on `device` whose rows are
    in flat shard order."""
    cat = torch.cat([t.to(device) for t in per_group])
    order = [k for _, ks in groups for k in ks]
    if order == list(range(len(order))):
        return cat
    out = torch.empty_like(cat)
    out[torch.as_tensor(order, device=device)] = cat
    return out


def _depth_setup(plan: DistTBPlan, T_depth: int,
                 g: Optional[src_mod.GriddedSources],
                 receivers: Optional[src_mod.GriddedReceivers],
                 param_blocks: Dict[str, list], prepped=None):
    """The tile function, its tables and padded params, and the receiver
    combiner for one time-tile depth (main T or the nt % T remainder).

    The host-built tables depend only on geometry, never on the params; the
    injection scale is gathered on the device by the tile function.
    `prepped` is the `(param_pads, dom_pads, h_from)` a deeper setup
    already exchanged: the remainder's halo is shallower, so its padded
    params and domain mask are a per-shard centre crop of those — no param
    exchange at all.

    Returns (run_tile, combine, (param_pads, dom_pads, h)) with
      run_tile(state blocks, t0, src_dcmp, scale) -> (new state blocks,
               partials), src_dcmp/scale per group device;
      combine(partials) -> (T_depth, nrec, rec_channels) per-step samples
               (on a rank's view, this rank's part of them);
    param_pads / dom_pads per device group (`ShardMesh.groups`), one
    (S, bx + 2h, by + 2h, nz) tensor a param and one (S, ., ., 1) mask.
    """
    physics = plan.physics
    mesh = plan.mesh
    groups = mesh.groups()
    dev0 = mesh.devices[0]
    px, py = plan.pgrid
    bx, by = plan.block
    r = plan.r_step
    h = T_depth * r
    overlap = plan.overlap
    T_rest = T_depth - 1 if overlap else T_depth  # steps the inner exec runs
    depths = plan.field_depths(T_depth)
    nrec = receivers.num if receivers is not None else 0
    nchan = physics.rec_channels
    sspec = _StepSpec(float(plan.dt), tuple(float(s) for s in plan.spacing),
                      plan.order)

    # --- the time-nested pass schedule: T_rest steps in inner-depth chunks
    # over pass-by-pass-shrinking windows (flat = one pass) ------------------
    geoms = nested_pass_geometry((bx, by), plan.inner_tile, T_rest,
                                 min(plan.inner_T, max(T_rest, 1)), r)

    # --- host-side owner-sharded tables, one binning per pass, moved to
    # each group's device once (on a rank's view, this rank's rows) --------
    # the receiver ids' rows this process combines: all, or this rank's
    if mesh.rank is None:
        rid_rows, held = np.s_[:, :], (px, py)
    else:
        ri, rj = divmod(mesh.rank, py)
        rid_rows, held = np.s_[ri:ri + 1, rj:rj + 1], (1, 1)

    def device_tables(sc, sid, smask, rc, rw):
        return [(_rows(sc, ks, dev), _rows(sid, ks, dev, torch.long),
                 _rows(smask, ks, dev), _rows(rc, ks, dev),
                 _rows(rw, ks, dev)) for dev, ks in groups]

    pass_tabs, pass_rids = [], []
    for geom in geoms:
        sc, sid, smask = _pass_source_tables(plan, g, geom)
        rc, rw, rid = _pass_receiver_tables(plan, receivers, geom)
        pass_tabs.append(device_tables(sc, sid, smask, rc, rw))
        pass_rids.append(torch.as_tensor(rid[rid_rows], device=dev0))
    if overlap:
        # shard-level tables for the split first step (window = the whole
        # exchanged block, one "tile" per shard)
        og = TBPassGeom(T=1, t0=0, d_in=h, d_out=0, halo=h, grid=(bx, by),
                        tile=(bx, by), ntiles=(1, 1),
                        include_halo=T_depth > 1)
        sc, sid, smask = _pass_source_tables(plan, g, og)
        rc, rw, o_rid = _pass_receiver_tables(plan, receivers, og)
        o_tabs = device_tables(sc, sid, smask, rc, rw)
        o_rid = torch.as_tensor(o_rid[rid_rows], device=dev0)

    # --- time-invariant param halos (exchanged once per depth) --------------
    fills = dict(physics.param_fills)
    with _spans.span("halo.setup_exchange", depth=h,
                     reused=prepped is not None):
        if prepped is not None and prepped[2] >= h:
            # a per-shard centre crop of the deeper setup's exchanged pads
            d = prepped[2] - h

            def crop(a):
                return a[:, d:a.shape[1] - d, d:a.shape[2] - d] if d else a

            param_pads = [tuple(crop(p) for p in pp) for pp in prepped[0]]
            dom_pads = [crop(dm) for dm in prepped[1]]
        else:
            pads = {f: halo_exchange_2d(param_blocks[f], h, mesh=mesh)
                    for f in physics.param_fields}
            param_pads, dom_pads = [], []
            for dev, ks in groups:
                pdtype = pads[physics.param_fields[0]][ks[0] // py][
                    ks[0] % py].dtype
                doms = [_local_domain_mask(plan, h, divmod(k, py), dev,
                                           pdtype) for k in ks]
                fields = []
                for f in physics.param_fields:
                    rows = [pads[f][k // py][k % py] for k in ks]
                    fill = fills.get(f, 0.0)
                    if fill:
                        rows = [torch.where(dm > 0, p, fill)
                                for p, dm in zip(rows, doms)]
                    fields.append(torch.stack(rows))
                param_pads.append(tuple(fields))
                dom_pads.append(torch.stack(doms))

    # per (device group, pass): the kernel's copies of the pass's params
    kept: Dict[Tuple[int, int], dict] = {}

    def run_tile(blocks, t0, src_dcmp, scale_vec):
        # ONE deep exchange per depth-T tile, per-field depths zero-padded
        # to the uniform window
        with _spans.annotate("halo.exchange", depth=h):
            spads = [exchange_to_depth(b, d, h, mesh=mesh)
                     for b, d in zip(blocks, depths)]
        new_blocks = [[[None] * py for _ in range(px)] for _ in blocks]
        parts = []
        for gi, (dev, ks) in enumerate(groups):
            dtype = spads[0][ks[0] // py][ks[0] % py].dtype
            win = src_dcmp[gi][t0:t0 + T_depth]
            gparts = []
            off = 0
            if overlap:
                osc, osid, osmask, orc, orw = o_tabs[gi]
                safe = osid[:, 0].clamp(min=0)              # (S, cap)
                sv0 = (win[0][safe] * (scale_vec[gi][safe]
                                       * osmask[:, 0])).to(dtype)
                rows, recs = [], []
                with _spans.annotate("halo.split_first_step", depth=h):
                    for row, k in enumerate(ks):
                        i, j = divmod(k, py)
                        st1, rec1 = _split_first_step(
                            plan, sspec, h,
                            tuple(b[i][j] for b in blocks),
                            tuple(sp[i][j] for sp in spads),
                            tuple(p[row] for p in param_pads[gi]),
                            dom_pads[gi][row], osc[row, 0], sv0[row],
                            orc[row, 0], orw[row, 0])
                        rows.append(st1)
                        recs.append(rec1)
                # depth h - r = T_rest * r: exactly the first pass's d_in
                state = tuple(torch.stack([st[f][r:-r, r:-r] for st in rows])
                              for f in range(len(depths)))
                gparts.append(torch.stack(recs)[:, None])
                off = 1
            else:
                state = tuple(torch.stack([sp[k // py][k % py] for k in ks])
                              for sp in spads)
            for ip, (geom, tabs) in enumerate(zip(geoms, pass_tabs)):
                isc, isid, ismask, irc, irw = tabs[gi]
                with _spans.annotate("halo.pass", idx=ip, T=geom.T,
                                     d_out=geom.d_out):
                    sv = _gather_vals(
                        win[off + geom.t0:off + geom.t0 + geom.T],
                        isid, ismask, scale_vec[gi], dtype)
                    state, rec = _run_pass(plan, geom, state,
                                           param_pads[gi], dom_pads[gi], h,
                                           isc, sv, irc, irw,
                                           kept.setdefault((gi, ip), {}))
                gparts.append(rec)
            for f, a in enumerate(state):
                for row, k in enumerate(ks):
                    new_blocks[f][k // py][k % py] = a[row]
            parts.append(gparts)
        # per pass (overlap step first): partials of every group
        return new_blocks, list(zip(*parts))

    def combine(partials):
        """Shard partials -> (T_depth, nrec, nchan) per-step samples."""
        if receivers is None:
            return torch.zeros((T_depth, 0, nchan), dtype=torch.float32,
                               device=dev0)
        rids = ([o_rid] if overlap else []) + pass_rids
        recs = []
        for per_group, rid in zip(partials, rids):
            rows = (per_group[0] if mesh.rank is not None
                    else _in_shard_order(per_group, groups, dev0))
            recs.append(_combine_pass(rows.reshape(held + rows.shape[1:]),
                                      rid, nrec))
        return recs[0] if len(recs) == 1 else torch.cat(recs, dim=0)

    return run_tile, combine, (param_pads, dom_pads, h)


def sharded_tb_propagate(plan: DistTBPlan, nt: int,
                         state: Tuple[torch.Tensor, ...],
                         params: Dict[str, torch.Tensor],
                         g: Optional[src_mod.GriddedSources] = None,
                         receivers: Optional[src_mod.GriddedReceivers] = None):
    """Temporally-blocked sharded propagation of any registered physics.

    Semantics identical to the matching `kernels.ref.*_reference` (tested):
    `state` is ordered as `plan.physics.state_fields`, `params` maps
    `param_fields` to global (nx, ny, nz) fields (numpy arrays or
    tensors); both are split onto the mesh's shards.  `nt` need not divide
    by `plan.T`: the remainder runs as a shallower tile with its own
    exchange depth.  The schedule (inner tiling, inner depth, per-field
    depths, overlap) changes only data movement, never results.

    On a rank's view of the mesh (`launch.mesh.make_rank_mesh`) every
    rank of its group calls this with the same arguments: the global
    `state` and `params` may lie anywhere (host arrays, say), and only
    this rank's block of them reaches its device.  Each rank advances its
    block, exchanging halos with its neighbours, and the receivers'
    samples are summed over the ranks (one all-reduce), so every rank
    holds the traces.

    Returns (final state tuple: global fields on the mesh's first device,
    or on a rank's view this rank's (bx, by, nz) blocks, which
    `gather_blocks` puts together; rec (nt, nrec, rec_channels) | None),
    receiver traces per step at any T, summed across shards by receiver
    id.
    """
    physics = plan.physics
    plan.validate()
    state = tuple(state)
    if len(state) != len(physics.state_fields):
        raise ValueError(f"{physics.name} carries "
                         f"{len(physics.state_fields)} state fields, "
                         f"got {len(state)}")
    mesh = plan.mesh
    groups = mesh.groups()
    dev0 = mesh.devices[0]
    local = mesh.rank is not None
    if not local:
        state = tuple(as_tensor(a, dev0) for a in state)
        params = {f: as_tensor(params[f], dev0)
                  for f in physics.param_fields}
    # on a rank's view the caller's arrays stay where they lie: each rank
    # takes its block of them
    if tuple(state[0].shape) != tuple(plan.grid_shape):
        raise ValueError(f"state shaped {tuple(state[0].shape)}, plan grid "
                         f"{tuple(plan.grid_shape)}")
    blocks = [_split_blocks(a, plan) for a in state]
    param_blocks = {f: _split_blocks(params[f], plan)
                    for f in physics.param_fields}
    k0 = groups[0][1][0]
    dtype = blocks[0][k0 // plan.pgrid[1]][k0 % plan.pgrid[1]].dtype
    nchan = physics.rec_channels

    if g is not None:
        if g.nt < nt:
            raise ValueError(f"source wavelets cover {g.nt} steps < nt={nt}")
        # the injection scale reads the params at the sources' points,
        # where the params lie
        prm = {}
        for f in physics.param_fields:
            p = params[f]
            prm[f] = as_tensor(p, p.device if torch.is_tensor(p) else "cpu")
        pdev = prm[physics.param_fields[0]].device
        scale = physics.inject_scale(prm, g.to(pdev),
                                     float(plan.dt)).to(dev0)
        g = g.to(dev0)
        src_dcmp = g.src_dcmp
    else:
        src_dcmp = torch.zeros((max(nt, 1), 1), dtype=dtype, device=dev0)
        scale = torch.zeros((1,), dtype=torch.float32, device=dev0)
    src_dcmp = [src_dcmp.to(dev) for dev, _ in groups]
    scale = [scale.to(dev) for dev, _ in groups]

    n_main = nt // plan.T
    rem = nt - n_main * plan.T
    recs = []
    main_pads = None
    if n_main > 0:
        with _spans.span("halo.setup", depth=plan.T):
            run_tile, combine, main_pads = _depth_setup(
                plan, plan.T, g, receivers, param_blocks)
        for i in range(n_main):
            blocks, parts = run_tile(blocks, i * plan.T, src_dcmp, scale)
            recs.append(combine(parts))
    if rem > 0:
        # the remainder nests the same way, at the same inner depth
        # (clamped when shallower); its pads are a crop of the main ones
        rplan = plan._replace(
            T=rem, inner_plan=(dataclasses.replace(
                plan.inner_plan, T=min(plan.inner_plan.T, rem))
                if plan.inner_plan is not None else None))
        with _spans.span("halo.remainder", depth=rem):
            run_rem, combine_rem, _ = _depth_setup(
                rplan, rem, g, receivers, param_blocks, prepped=main_pads)
            blocks, parts = run_rem(blocks, n_main * plan.T, src_dcmp,
                                    scale)
            recs.append(combine_rem(parts))
    if local:
        i, j = divmod(mesh.rank, plan.pgrid[1])
        final = tuple(b[i][j] for b in blocks)
    else:
        final = tuple(_join_blocks(b, dev0) for b in blocks)
    if receivers is None:
        return final, None
    if not recs:
        return final, torch.zeros((0, receivers.num, nchan), dtype=dtype,
                                  device=dev0)
    rec = torch.cat(recs, dim=0)
    if local:
        # each (receiver, point) pair is recorded by one shard: the other
        # ranks add zeros there
        mesh.process_group.all_reduce_(rec)
    return final, rec


# tag of `gather_blocks`' messages (the shifts use 0-3)
GATHER_TAG = 8


def gather_blocks(blocks, mesh: ShardMesh, dst: int = 0):
    """The global fields from every rank's blocks (`sharded_tb_propagate`'s
    final state on a rank's view of `mesh`), put together on rank `dst`:
    a tuple of (nx, ny, ...) tensors there, None on the other ranks.  Every
    rank of the mesh's group calls it; each block moves once, to `dst`
    (`DataParallel.exchange`, a message a field)."""
    group = mesh.process_group
    px, py = mesh.pgrid
    blocks = tuple(blocks)
    if group.rank != dst:
        for f, b in enumerate(blocks):
            group.exchange([(dst, b)], [], tag=GATHER_TAG + f)
        return None
    out = []
    for f, b in enumerate(blocks):
        peers = [k for k in range(px * py) if k != dst]
        got = dict(zip(peers, group.exchange(
            [], [(k, b.shape, b.dtype) for k in peers], tag=GATHER_TAG + f)))
        got[dst] = b
        out.append(torch.cat([torch.cat([got[i * py + j] for j in range(py)],
                                        dim=1) for i in range(px)], dim=0))
    return tuple(out)


__all__ = ["DistTBPlan", "dist_plan_from_hier", "exchange_to_depth",
           "gather_blocks", "halo_exchange", "halo_exchange_2d",
           "mesh_shift_fns", "rank_shift_fns", "sharded_tb_propagate",
           "shift_from_high", "shift_from_low"]
