"""Sparse "off-the-grid" sources & receivers and the paper's precompute
scheme (port of `repro.core.sources`, paper §II).

  1. discover the grid points a source touches (Listing 2) —
     `affected_points` / `affected_points_by_injection`;
  2. the binary source mask ``SM`` and unique-ID volume ``SID`` (Fig. 5b/5c);
  3. the per-affected-point wavelets ``src_dcmp`` (Listing 3, Fig. 5d);
  4. the fused grid-aligned injection (Listing 4) — `inject`, and its
     dense form `dense_increment`;
  5. the z-compressed iteration space (Listing 5, Fig. 6) — `z_compress`,
     `inject_zcompressed`;
  plus the per-(x, y)-tile source/receiver tables the TB kernel consumes
  (`tile_source_tables`, `tile_receiver_tables`).

The host side stays numpy (it runs once per model setup) and emits torch
tensors on the requested device; `sm`/`sid` stay host numpy arrays, since
nothing on the device path reads them.
"""
from __future__ import annotations

import dataclasses
from typing import NamedTuple, Optional, Tuple

import numpy as np
import torch

from repro_torch._device import resolve_device
from repro_torch.core import interp as interp_mod
from repro_torch.core import tables as tables_mod
from repro_torch.core.grid import Grid
from repro_torch.core.interp import LINEAR, InterpSpec


def to_numpy(x) -> np.ndarray:
    """Host numpy view of a tensor (any device) or array-like."""
    if isinstance(x, torch.Tensor):
        return x.detach().cpu().numpy()
    return np.asarray(x)


# ---------------------------------------------------------------------------
# Source / receiver descriptions (off-the-grid)
# ---------------------------------------------------------------------------

@dataclasses.dataclass(frozen=True)
class SparseOperator:
    """A set of sparsely located off-the-grid points (sources or receivers).

    coords: (num, ndim) float64 physical coordinates — *not* grid-aligned.
    """

    coords: np.ndarray

    def __post_init__(self):
        object.__setattr__(self, "coords",
                           np.atleast_2d(np.asarray(self.coords, np.float64)))

    @property
    def num(self) -> int:
        return self.coords.shape[0]


class InterpStencil(NamedTuple):
    """Expanded interpolation stencil for a set of off-grid points.

    indices: (num, footprint, ndim) int32; weights: (num, footprint) float64,
    rows summing to 1.  footprint is (2r)**ndim.
    """

    indices: np.ndarray
    weights: np.ndarray


def interp_stencil(op: SparseOperator, grid: Grid,
                   spec: InterpSpec = LINEAR) -> InterpStencil:
    """Interpolation stencil — paper Fig. 3, `f` in Listing 1."""
    co = interp_mod.precompute_coeffs(op.coords, grid, spec)
    return InterpStencil(*co.expand())


# ---------------------------------------------------------------------------
# Step 1 (Listing 2): discover affected points
# ---------------------------------------------------------------------------

def affected_points_by_injection(stencil: InterpStencil, grid: Grid,
                                 wavelet0: np.ndarray) -> np.ndarray:
    """The paper's Listing 2: scatter one timestep into an empty grid, then
    read off the non-zero coordinates."""
    u = np.zeros(grid.shape, np.float64)
    num, npts, _ = stencil.indices.shape
    for s in range(num):
        for i in range(npts):
            xs = tuple(stencil.indices[s, i])
            u[xs] += stencil.weights[s, i] * wavelet0[s]
    return np.argwhere(u != 0.0).astype(np.int32)


def affected_points(stencil: InterpStencil) -> np.ndarray:
    """Index-based equivalent of Listing 2: unique grid points with non-zero
    interpolation weight, in lexicographic order (ascending unique IDs)."""
    flatidx = stencil.indices.reshape(-1, stencil.indices.shape[-1])
    flatw = stencil.weights.reshape(-1)
    pts = flatidx[flatw != 0.0]
    return np.unique(pts, axis=0).astype(np.int32)


# ---------------------------------------------------------------------------
# Steps 2-3: SM / SID masks and decomposed wavefields
# ---------------------------------------------------------------------------

class GriddedSources(NamedTuple):
    """Grid-aligned decomposition of an off-the-grid source set (Fig. 5d).

    sm:        (grid) uint8 numpy — binary source mask (Fig. 5b).
    sid:       (grid) int32 numpy — unique ascending ID per affected point,
               -1 elsewhere (Fig. 5c).
    points:    (npts, ndim) int32 tensor — affected points in SID order.
    src_dcmp:  (nt, npts) tensor — per-affected-point wavelets (Listing 3):
               src_dcmp[t, sid] = sum_s w(s->point) * src[t, s].
    """

    sm: np.ndarray
    sid: np.ndarray
    points: torch.Tensor
    src_dcmp: torch.Tensor

    @property
    def npts(self) -> int:
        return self.points.shape[0]

    @property
    def nt(self) -> int:
        return self.src_dcmp.shape[0]

    def to(self, device) -> "GriddedSources":
        return self._replace(points=self.points.to(device),
                             src_dcmp=self.src_dcmp.to(device))


def precompute(op: SparseOperator, grid: Grid, wavelets: np.ndarray,
               *, discover_by_injection: bool = False,
               dtype=torch.float32, interp: InterpSpec = LINEAR,
               device="cuda") -> GriddedSources:
    """The paper's §II.A precompute pipeline (steps 1-3).

    `wavelets` is (nt, num_sources).  `discover_by_injection` uses the
    literal Listing-2 discovery; the default index-based path is
    equivalent.  `interp` picks the interpolation kernel and edge policy.
    """
    dev = resolve_device(device)
    wavelets = np.asarray(wavelets, np.float64)
    if wavelets.ndim != 2 or wavelets.shape[1] != op.num:
        raise ValueError(f"wavelets must be (nt, {op.num}), "
                         f"got {wavelets.shape}")
    st = interp_stencil(op, grid, interp)

    if discover_by_injection:
        t0 = next((t for t in range(wavelets.shape[0])
                   if np.all(wavelets[t] != 0.0)), None)
        if t0 is None:
            pts = affected_points(st)
        else:
            pts = affected_points_by_injection(st, grid, wavelets[t0])
    else:
        pts = affected_points(st)

    npts = pts.shape[0]
    sm = np.zeros(grid.shape, np.uint8)
    sid = np.full(grid.shape, -1, np.int32)
    sm[tuple(pts.T)] = 1
    sid[tuple(pts.T)] = np.arange(npts, dtype=np.int32)

    # Listing 3: a point shared by several sources accumulates all their
    # weighted wavelets (np.add.at handles the repeated ids).
    ids = sid[tuple(st.indices.reshape(-1, grid.ndim).T)]
    w = st.weights.reshape(-1)
    src_ids = np.repeat(np.arange(op.num), st.indices.shape[1])
    nt = wavelets.shape[0]
    src_dcmp = np.zeros((nt, npts), np.float64)
    contrib = wavelets[:, src_ids] * w[None, :]
    np.add.at(src_dcmp.T, ids, contrib.T)

    return GriddedSources(
        sm=sm, sid=sid,
        points=torch.as_tensor(pts, device=dev),
        src_dcmp=torch.as_tensor(src_dcmp, device=dev).to(dtype))


# ---------------------------------------------------------------------------
# Step 4 (Listing 4): fused grid-aligned injection
# ---------------------------------------------------------------------------

def inject(u: torch.Tensor, g: GriddedSources, t: int,
           scale: Optional[torch.Tensor] = None) -> torch.Tensor:
    """Grid-aligned injection of timestep `t` into field `u`, IN PLACE.

    u[p] += scale[p] * src_dcmp[t, SID[p]] for p in affected points (the
    reference's functional ``u.at[points].add``; in place here, since the
    callers always pass a freshly computed field).  Returns `u`.
    """
    vals = g.src_dcmp[t]
    if scale is not None:
        vals = vals * scale
    idx = tuple(g.points.long().T)
    return u.index_put_(idx, vals.to(u.dtype), accumulate=True)


def point_scale(field: torch.Tensor, g: GriddedSources) -> torch.Tensor:
    """Gather a per-grid-point factor (e.g. m) at the affected points."""
    return field[tuple(g.points.long().T)]


def dense_increment(g: GriddedSources, t: int, shape: Tuple[int, ...],
                    dtype=torch.float32) -> torch.Tensor:
    """The full-grid injection increment for timestep `t` — the SM/SID-
    masked read the fused loop in Listing 4 performs:
    ``SM[p] ? src_dcmp[t, SID[p]] : 0``, on the sources' device.  Used by
    oracles and tests; the production paths use `inject` (scatter) or the
    per-tile tables."""
    vals = g.src_dcmp[t]
    dev = vals.device
    safe_sid = torch.as_tensor(np.maximum(g.sid, 0), device=dev).long()
    sm = torch.as_tensor(g.sm, device=dev).to(dtype)
    return (vals[safe_sid] * sm).reshape(shape).to(dtype)


# ---------------------------------------------------------------------------
# Step 5 (Listing 5 / Fig. 6): reduced iteration space along z
# ---------------------------------------------------------------------------

class ZCompressed(NamedTuple):
    """The paper's nnz_mask / Sp_SID compression of SM/SID along z.

    nnz_mask: (nx, ny) int32 — number of affected z's per column (Fig. 6).
    sp_z:     (nx, ny, max_nnz) int32 — packed z indices (padded with -1).
    sp_sid:   (nx, ny, max_nnz) int32 — packed SIDs (padded with -1).
    """

    nnz_mask: torch.Tensor
    sp_z: torch.Tensor
    sp_sid: torch.Tensor

    @property
    def max_nnz(self) -> int:
        return self.sp_z.shape[-1]


def z_compress(g: GriddedSources) -> ZCompressed:
    """Aggregate non-zeros along z, cutting off all-zero z-slices
    (§II.A.5).  Built in numpy from SM/SID, as the reference builds it;
    the tables land on the sources' device."""
    sm, sid = g.sm, g.sid
    if sm.ndim != 3:
        raise ValueError("z-compression is defined for 3-D grids")
    nx, ny, nz = sm.shape
    nnz = sm.astype(np.int32).sum(axis=2, dtype=np.int32)
    max_nnz = max(int(nnz.max()), 1)
    sp_z = np.full((nx, ny, max_nnz), -1, np.int32)
    sp_sid = np.full((nx, ny, max_nnz), -1, np.int32)
    xs, ys = np.nonzero(nnz)
    for x, y in zip(xs, ys):
        zz = np.nonzero(sm[x, y])[0]
        sp_z[x, y, :zz.size] = zz
        sp_sid[x, y, :zz.size] = sid[x, y, zz]
    dev = g.src_dcmp.device
    return ZCompressed(*(torch.as_tensor(a, device=dev)
                         for a in (nnz, sp_z, sp_sid)))


def inject_zcompressed(u: torch.Tensor, g: GriddedSources, zc: ZCompressed,
                       t: int,
                       scale: Optional[torch.Tensor] = None) -> torch.Tensor:
    """Listing-5 semantics: iterate only the packed non-zero z entries,
    IN PLACE as `inject`.  Vectorized over the packed slots; padding slots
    (sid == -1) contribute 0.  Equivalent to `inject` (tested).  Returns
    `u`."""
    vals = g.src_dcmp[t]
    if scale is not None:
        vals = vals * scale
    nx, ny, k = zc.sp_sid.shape
    dev = zc.sp_sid.device
    valid = zc.sp_sid >= 0
    inc = torch.where(valid, vals[zc.sp_sid.clamp(min=0).long()],
                      torch.zeros((), dtype=vals.dtype, device=dev))
    xi = torch.arange(nx, device=dev)[:, None, None].expand(nx, ny, k)
    yi = torch.arange(ny, device=dev)[None, :, None].expand(nx, ny, k)
    zi = zc.sp_z.clamp(min=0).long()
    return u.index_put_((xi.reshape(-1), yi.reshape(-1), zi.reshape(-1)),
                        inc.reshape(-1).to(u.dtype), accumulate=True)


# ---------------------------------------------------------------------------
# Receivers (measurement interpolation, Fig. 3b)
# ---------------------------------------------------------------------------

class GriddedReceivers(NamedTuple):
    """Grid-aligned receiver gather table.

    indices: (nrec, footprint, ndim) int32 tensor; weights: (nrec, footprint)
    tensor — footprint is (2r)**ndim (8 for the default trilinear kernel).
    """

    indices: torch.Tensor
    weights: torch.Tensor

    @property
    def num(self) -> int:
        return self.indices.shape[0]

    def to(self, device) -> "GriddedReceivers":
        return self._replace(indices=self.indices.to(device),
                             weights=self.weights.to(device))


def precompute_receivers(op: SparseOperator, grid: Grid,
                         dtype=torch.float32, interp: InterpSpec = LINEAR,
                         device="cuda") -> GriddedReceivers:
    dev = resolve_device(device)
    st = interp_stencil(op, grid, interp)
    return GriddedReceivers(torch.as_tensor(st.indices, device=dev),
                            torch.as_tensor(st.weights, device=dev).to(dtype))


def interpolate(u: torch.Tensor, r: GriddedReceivers) -> torch.Tensor:
    """d(t, r) = sum_i w_i * u[neigh_i] — one sample per receiver."""
    nrec, k, ndim = r.indices.shape
    flat = r.indices.reshape(-1, ndim).long()
    vals = u[tuple(flat.T)].reshape(nrec, k)
    return torch.sum(vals * r.weights.to(u.dtype), dim=1)


# ---------------------------------------------------------------------------
# Tile-granular tables for the TB kernel
# ---------------------------------------------------------------------------

class TileSourceTable(NamedTuple):
    """Per-(x,y)-tile source table (the tile-granular analogue of nnz_mask).

    nnz:    (n_tiles,) int32 — valid entries per tile.
    coords: (n_tiles, cap, 3) int32 — window-local (x, y, z), padded 0.
    sid:    (n_tiles, cap) int32 — SID per entry, padded -1.
    scale:  (n_tiles, cap) float32 — per-point physical factor, padded 0.
    """

    nnz: torch.Tensor
    coords: torch.Tensor
    sid: torch.Tensor
    scale: torch.Tensor

    @property
    def cap(self) -> int:
        """Slots per tile (also of a table with a leading shot axis)."""
        return self.coords.shape[-2]


def tile_source_tables(g: GriddedSources, grid_shape: Tuple[int, int, int],
                       tile: Tuple[int, int], halo: int,
                       scale: Optional[np.ndarray] = None,
                       cap: Optional[int] = None,
                       include_halo: bool = False,
                       device=None) -> TileSourceTable:
    """Bin affected points into (x, y) tiles for the TB kernel.

    `halo` is the window overhang (T*r for a depth-T time tile), so local
    coords are point - (tile_origin - halo).  ``include_halo=False`` bins
    each point into the one tile whose centre holds it; ``True`` into
    every tile whose window holds it (paper Fig. 4b: a neighbour's source
    must reach this tile's halo during the in-window steps).  The tables
    land on `device` (default: where `g` lives).
    """
    nx, ny, _ = grid_shape
    tx, ty = tile
    ntx = -(-nx // tx)
    nty = -(-ny // ty)
    pts = to_numpy(g.points)
    npts = pts.shape[0]
    scl = (np.ones(npts, np.float32) if scale is None
           else to_numpy(scale).astype(np.float32, copy=False))

    wg = tables_mod.WindowGrid(origin=(-halo, -halo), tile=(tx, ty),
                               ntiles=(ntx, nty), pad=halo)
    pairs = tables_mod.bin_points(pts[:, :2], wg,
                                  "window" if include_halo else "centre")
    fill, slot, cap = tables_mod.pack_slots(pairs, wg.n_tiles, cap,
                                            "source table")
    coords = np.zeros((wg.n_tiles, cap, 3), np.int32)
    sid_t = np.full((wg.n_tiles, cap), -1, np.int32)
    scale_t = np.zeros((wg.n_tiles, cap), np.float32)
    for (tt, p), k in zip(pairs, slot):
        ox, oy = wg.window_origin(tt // nty, tt % nty)
        coords[tt, k] = (pts[p, 0] - ox, pts[p, 1] - oy, pts[p, 2])
        sid_t[tt, k] = p
        scale_t[tt, k] = scl[p]
    dev = g.src_dcmp.device if device is None else device
    return TileSourceTable(*(torch.as_tensor(a, device=dev)
                             for a in (fill, coords, sid_t, scale_t)))


class TileReceiverTable(NamedTuple):
    """Per-tile receiver gather entries (point, receiver id, weight).

    A receiver's gather points may straddle tiles; each (receiver, point)
    pair goes to the owning tile and contributes a *partial* sample — the
    partials are segment-summed by receiver id afterwards.
    """

    nnz: torch.Tensor       # (n_tiles,)
    coords: torch.Tensor    # (n_tiles, cap, 3) window-local
    rid: torch.Tensor       # (n_tiles, cap) receiver id, padded -1
    weight: torch.Tensor    # (n_tiles, cap) float32


def tile_receiver_tables(r: GriddedReceivers,
                         grid_shape: Tuple[int, int, int],
                         tile: Tuple[int, int], halo: int,
                         cap: Optional[int] = None,
                         device=None) -> TileReceiverTable:
    nx, ny, _ = grid_shape
    tx, ty = tile
    nty = -(-ny // ty)
    ntx = -(-nx // tx)
    idx = to_numpy(r.indices).reshape(-1, 3)
    w = to_numpy(r.weights).astype(np.float64).reshape(-1)
    rids = np.repeat(np.arange(r.num, dtype=np.int32), r.indices.shape[1])
    keep = w != 0.0
    idx, w, rids = idx[keep], w[keep], rids[keep]
    wg = tables_mod.WindowGrid(origin=(-halo, -halo), tile=(tx, ty),
                               ntiles=(ntx, nty), pad=halo)
    pairs = tables_mod.bin_points(idx[:, :2], wg, "centre")
    fill, slot, cap = tables_mod.pack_slots(pairs, wg.n_tiles, cap,
                                            "receiver table")
    coords = np.zeros((wg.n_tiles, cap, 3), np.int32)
    rid_t = np.full((wg.n_tiles, cap), -1, np.int32)
    w_t = np.zeros((wg.n_tiles, cap), np.float32)
    for (tt, p), k in zip(pairs, slot):
        ox, oy = wg.window_origin(tt // nty, tt % nty)
        coords[tt, k] = (idx[p, 0] - ox, idx[p, 1] - oy, idx[p, 2])
        rid_t[tt, k] = rids[p]
        w_t[tt, k] = w[p]
    dev = r.weights.device if device is None else device
    return TileReceiverTable(*(torch.as_tensor(a, device=dev)
                               for a in (fill, coords, rid_t, w_t)))


# ---------------------------------------------------------------------------
# Wavelets
# ---------------------------------------------------------------------------

def ricker_wavelet(nt: int, dt: float, f0: float, num: int = 1,
                   t0: Optional[float] = None) -> np.ndarray:
    """Ricker (Mexican-hat) wavelet, (nt, num) float64.  `t0` defaults to
    1/f0 so the onset is non-zero at early timesteps."""
    t0 = 1.0 / f0 if t0 is None else t0
    t = np.arange(nt) * dt
    a = (np.pi * f0 * (t - t0)) ** 2
    w = (1.0 - 2.0 * a) * np.exp(-a)
    return np.tile(w[:, None], (1, num)).astype(np.float64)
