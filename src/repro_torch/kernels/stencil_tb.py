"""Temporally-blocked time tile: the hand-written CUDA kernel for Hopper and
its plain PyTorch version (port of `repro.kernels.stencil_tb`).

One call advances the whole grid of each of B shots by one depth-T time
tile on a grid of (ntx, nty) spatial tiles.  Each tile takes a
``(tx + 2H, ty + 2H, nz)`` window of every state and param field
(H = T * step_radius), runs T steps of the physics update with the x/y
domain mask, adds the per-tile source values at window-local points,
records ``rec_w``-weighted receiver samples, and writes back only its
centre.  State, tables and outputs carry a leading shot axis; the params
are one copy shared by every shot (the reference's ``vmap`` over
`pallas_call` with ``in_axes=(None, None, 0)``).  A single shot is B = 1.

The sharded layer (`distributed/halo.py`) runs the same kernels on the
passes of its shards (the reference's `_tb_kernel` with `external_dom`):
each row of the leading axis is then one shard, with its own params
(``(B, nx + 2H, ny + 2H, nz)``) and its own domain mask `dom`, a
z-invariant ``(B, nx + 2H, ny + 2H)`` plane sliced per window at the same
origin as the fields, in place of the spec's "inside the grid" predicate.

`tb_time_tile` dispatches on where its tensors lie: CPU tensors run
`tb_time_tile_plain`; CUDA tensors launch the physics' kernel
(``csrc/stencil_tb.cu`` acoustic, ``csrc/stencil_tb_tti.cu`` TTI,
``csrc/stencil_tb_elastic.cu`` elastic; float32, and bf16: kernels
B1a-bf16 acoustic, B1b-bf16 TTI and elastic, B1c-bf16 with `dom`) or
raise.  `launches`
counts kernel launches, so a run can show it went through the kernel.

Each kernel has two schedules, and `launch_plan` picks one a launch from
its shape: the first schedule (``csrc/tb_common.cuh``, one block a tile,
every step re-reading the window from device-memory scratch) or the
z-streamed trapezoid of ``csrc/tb_stream.cuh``, where a block takes a
sub-tile of the spec tile (`stream_plan`), each launch makes float32
z-major copies of its padded state in the scratch, and reads the params
as z-major copies that the caller owning them makes once
(`param_copies`) or the launch makes itself.  The TTI and elastic kernels
have a third, the cluster-shared trapezoid of ``csrc/tb_cluster.cuh``
(B5, `cluster_plan`): a thread block cluster shares one spec tile's
trapezoid, each pass cut into chunks (`pass_chunks`) spread over its
blocks, so the deep halos of orders 8 and 12 are computed once a tile
and not once a sub-tile.  The acoustic kernel's third is the
cluster-shared z-wavefront (B6, `wave_plan`): the z-streamed wavefront of
every level kept on chip, one spec tile's levels cut into a part a block
of a cluster (`WavePlan`), the seams between parts written into the
neighbours' shared memory.
"""
from __future__ import annotations

import ctypes
import dataclasses
import functools
from typing import Callable, Dict, Optional, Tuple

import numpy as np
import torch

from repro_torch.core import stencil as st
from repro_torch.core.propagators import acoustic as ac
from repro_torch.core.propagators import elastic as el
from repro_torch.core.propagators import tti as tt
from repro_torch.kernels import tb_physics as phys

# kernel launches made by `tb_time_tile` (set it to 0 before a counted
# run), and the same launches by schedule (`schedule_name`)
launches = 0
schedule_launches = {"first": 0, "z-streamed": 0, "cluster": 0,
                     "wavefront": 0}


@dataclasses.dataclass(frozen=True)
class TBKernelSpec:
    """Static configuration of one temporally-blocked kernel call."""

    nx: int
    ny: int
    nz: int
    tile: Tuple[int, int]
    T: int                      # time-tile depth
    order: int                  # space order (radius = order // 2)
    dt: float
    spacing: Tuple[float, float, float]
    src_cap: int                # max sources per tile (padded)
    rec_cap: int                # max receiver gather entries per tile
    dtype: torch.dtype = torch.float32
    step_radius: Optional[int] = None   # per-step halo; None -> order // 2
    rec_channels: int = 1

    @property
    def radius(self) -> int:
        return self.order // 2

    @property
    def halo(self) -> int:
        r = self.radius if self.step_radius is None else self.step_radius
        return self.T * r

    @property
    def window(self) -> Tuple[int, int, int]:
        return (self.tile[0] + 2 * self.halo, self.tile[1] + 2 * self.halo,
                self.nz)

    @property
    def ntiles(self) -> Tuple[int, int]:
        tx, ty = self.tile
        if self.nx % tx or self.ny % ty:
            raise ValueError(
                f"grid ({self.nx},{self.ny}) must divide by tile {self.tile}")
        return (self.nx // tx, self.ny // ty)

    def window_bytes(self, nwindows: int = 4) -> int:
        """Bytes of `nwindows` window-sized buffers (one per state/param
        field; 4 = the acoustic u_prev, u, m, damp)."""
        wx, wy, wz = self.window
        return wx * wy * wz * self.dtype.itemsize * nwindows


# ---------------------------------------------------------------------------
# Plain PyTorch version (port of the reference's `_jnp_window_tile` /
# `_jnp_time_tile`)
# ---------------------------------------------------------------------------

def window_tile_plain(physics: phys.TBPhysics, sspec, T: int, h: int,
                      state_pads, param_pads, dom, s_coords, s_vals,
                      r_coords, r_w):
    """T in-window timesteps on one halo-padded window: the same
    update / mask / inject / record sequence as the kernel, in the
    kernel's arithmetic: values are read as float32, a step is computed in
    float32, and each store rounds to the fields' storage dtype (the
    step's fields, again after the injection, and each receiver sample).
    For float32 fields every rounding is the identity.  In bf16 this is
    kernel B1a-bf16's function, not the reference's bf16 tile, which
    computes op by op in bf16 with bf16 taps.  `sspec` exposes
    `dt`/`spacing`/`order`; `dom` broadcasts against the window.

    Returns (cropped centre tuple in the storage dtype, rec partials
    (T, capr, rec_channels)).
    """
    f32 = torch.float32
    store = state_pads[0].dtype
    rnd = lambda a: a.to(store).to(f32)  # noqa: E731
    state = {f: a.to(f32) for f, a in zip(physics.state_fields, state_pads)}
    params = {f: a.to(f32) for f, a in zip(physics.param_fields, param_pads)}
    dom = dom.to(f32)
    mask_fn = lambda a: a * dom  # noqa: E731
    sidx = tuple(s_coords.long().T)
    ridx = tuple(r_coords.long().T)
    recs = []
    for k in range(T):
        new = physics.update(state, params, sspec, mask_fn)
        for f in physics.evolved_fields:
            if f not in physics.premasked_fields:
                new[f] = new[f] * dom
            new[f] = rnd(new[f])
        # fused grid-aligned injection (paper Listing 4); padding slots
        # carry val = 0 and add harmlessly onto window point (0, 0, 0)
        for f in physics.inject_fields:
            new[f] = rnd(new[f].index_put(sidx, s_vals[k].to(f32),
                                          accumulate=True))
        recs.append(torch.stack(
            [rnd(arr[ridx] * r_w.to(f32)) for arr in physics.record(new)],
            dim=-1).to(store))
        state = new
    wx, wy = state_pads[0].shape[0], state_pads[0].shape[1]
    crop = (slice(h, wx - h), slice(h, wy - h), slice(None))
    return (tuple(state[f][crop].to(store) for f in physics.state_fields),
            torch.stack(recs, dim=0))


def tb_time_tile_plain(spec: TBKernelSpec, physics: phys.TBPhysics,
                       state_pads, param_pads, s_coords, s_vals, r_coords,
                       r_w, dom=None, param_copies=None, scratch=None):
    """Plain PyTorch version of `tb_time_tile`: the same per-window
    trapezoid, looped over the shots and the (ti, tj) tiles.  Runs on any
    device.  A param with a leading axis is one per row; `dom` (B,
    nx + 2H, ny + 2H) replaces the grid predicate, as in `tb_time_tile`;
    `param_copies` (the kernel's copies of the params) and `scratch` (the
    kernel's working memory) are not read.

    Returns (state tuple (B, nx, ny, nz), rec partials
    (B, ntx, nty, T, capr, chan))."""
    shots = [_shot_tile_plain(spec, physics, tuple(p[b] for p in state_pads),
                              tuple(p[b] if p.dim() == 4 else p
                                    for p in param_pads),
                              s_coords[b], s_vals[b], r_coords[b], r_w[b],
                              None if dom is None else dom[b])
             for b in range(state_pads[0].shape[0])]
    return (tuple(torch.stack(f) for f in zip(*(st for st, _ in shots))),
            torch.stack([rec for _, rec in shots]))


def _shot_tile_plain(spec: TBKernelSpec, physics: phys.TBPhysics,
                     state_pads, param_pads, s_coords, s_vals, r_coords,
                     r_w, dom_pad=None):
    """One shot of `tb_time_tile_plain` (no shot axis)."""
    h = spec.halo
    tx, ty = spec.tile
    ntx, nty = spec.ntiles
    dev = state_pads[0].device
    outs = [torch.zeros((spec.nx, spec.ny, spec.nz), dtype=p.dtype,
                        device=dev) for p in state_pads]
    rec_rows = []
    for ti in range(ntx):
        row = []
        for tj in range(nty):
            k = ti * nty + tj
            slx = slice(ti * tx, ti * tx + tx + 2 * h)
            sly = slice(tj * ty, tj * ty + ty + 2 * h)
            if dom_pad is None:
                gx = torch.arange(ti * tx - h, (ti + 1) * tx + h, device=dev)
                gy = torch.arange(tj * ty - h, (tj + 1) * ty + h, device=dev)
                dom = (((gx >= 0) & (gx < spec.nx))[:, None]
                       & ((gy >= 0) & (gy < spec.ny))[None, :])
            else:
                dom = dom_pad[slx, sly]
            out_w, rec = window_tile_plain(
                physics, spec, spec.T, h,
                tuple(p[slx, sly] for p in state_pads),
                tuple(p[slx, sly] for p in param_pads),
                dom[:, :, None].to(spec.dtype), s_coords[k], s_vals[k],
                r_coords[k], r_w[k])
            for i, centre in enumerate(out_w):
                outs[i][ti * tx:(ti + 1) * tx, tj * ty:(tj + 1) * ty] = centre
            row.append(rec)
        rec_rows.append(torch.stack(row, dim=0))
    return tuple(outs), torch.stack(rec_rows, dim=0)


# ---------------------------------------------------------------------------
# CUDA kernel wrapper
# ---------------------------------------------------------------------------

_MAX_RADIUS = 8         # MAX_RADIUS in csrc/tb_common.cuh
_MAX_T = 32             # MAX_T in csrc/tb_stream.cuh (acoustic level tables)
# shared memory a block of the z-streamed kernels may take (STREAM_SMEM in
# csrc/tb_stream.cuh: sm_90's 232,448 bytes less 8 KB), their threads, and
# the acoustic kernel's output staging depth (OUT_CHUNK)
_STREAM_SMEM = 232448 - 8192
_STREAM_THREADS = 512
_OUT_CHUNK = 8
# the largest overhang (bx + 2H)(by + 2H) / (bx by) of a z-streamed
# sub-tile that `launch_plan` takes (measured at 512^3, tile 32, PERF.md:
# overhangs of 9 and 10 still beat the first schedule; at 81 the elastic
# block windows need 370 GiB)
_MAX_OVERHANG = 16


# the cluster-shared trapezoid (B5, csrc/tb_cluster.cuh): the clusters of
# C blocks (~200 KB of shared memory each, one an SM) an H100 holds at
# once, by C (cudaOccupancyMaxActiveClusters, measured; PERF.md): a
# cluster's blocks share a GPC, so clusters of 4 and more leave some of
# the 132 SMs idle.  C = 16 is beyond the portable 8 and is allowed a
# launch by cudaFuncAttributeNonPortableClusterSizeAllowed.
_ACTIVE_CLUSTERS = {1: 132, 2: 66, 4: 30, 8: 15, 16: 7}
# the write-back's warp tiles: the least shared memory of a streamed block
_WB_TILES = 4 * (_STREAM_THREADS // 32) * 32 * 33
# the cluster-shared z-wavefront (B6, csrc/stencil_tb.cu): the depths it
# takes (WAVE_MAX_T), the blocks a cluster may have (CLUSTER_MAX in
# csrc/tb_cluster.cuh) and the cluster sizes `wave_size` chooses among
_WAVE_MAX_T = 8
_WAVE_MAX_K = 2
_WAVE_MIN_R = 4           # WAVE_MIN_R: B6 takes space orders 8 to 16
_CLUSTER_MAX = 16
_WAVE_CLUSTERS = (1, 2, 4, 8, 16)


@dataclasses.dataclass(frozen=True)
class _CudaKernel:
    source: str                 # csrc/<source>.cu
    scratch_windows: int        # first schedule: window buffers a tile
    weights: Callable[[int], np.ndarray]   # order -> one axis' FD weights
    deriv: int                  # derivative order of those weights
    # the z-streamed trapezoid schedule (csrc/tb_stream.cuh): the block
    # windows a block keeps (float32, z-major), each over the sub-tile's
    # window less its margin (`stream_windows[i]` radii, order // 2, at
    # each side), and the least halo at which `launch_plan` takes it
    # (measured at 512^3, tile 32, PERF.md: below it the first schedule's
    # window barely overhangs the tile, and the z-streamed launch's fixed
    # costs, the state's z-major copies and one level's unhidden
    # plane-steps, cost more than the re-reads they save)
    stream_windows: Tuple[int, ...]
    stream_from_halo: int
    # the cluster-shared trapezoid (B5): the least space order and halo
    # at which `launch_plan` takes it (None: the kernel has none; measured
    # at 512^3, PERF.md: from order 8 at T = 2, halo 16, it beat both
    # other schedules at every tile measured); it keeps `scratch_windows`
    # whole spec windows a tile, float32 z-major
    cluster_from_order: Optional[int] = None
    cluster_from_halo: int = 0
    # the cluster-shared z-wavefront (B6, acoustic): the least space order
    # and halo at which `launch_plan` takes it, float32 at T >= 2, and the
    # most blocks a cluster it takes (measured at 512^3, PERF.md: from
    # halo 12 with 2 or 4 blocks a cluster it beat the z-streamed and first
    # schedules at every tile and T measured; at halo 8 the z-streamed one
    # is the faster, and with 8 or 16 blocks, 15 or 7 clusters at once,
    # mostly the other schedules)
    wave_from_order: Optional[int] = None
    wave_from_halo: int = 0
    wave_max_cluster: int = 0
    # the first schedule's scratch windows a tile in bf16 (`_KERNELS`)
    bf16_first_windows: int = 0


# physics name -> its hand-written kernel; all share one C entry point.
# `bf16_first_windows`: the first schedule's scratch a tile in bf16, in
# bf16 windows: the state windows, and the float32 ones at two each (TTI's
# three inner derivatives; elastic's three velocities, unrounded until
# the step ends, after a spare window that keeps them 4-byte aligned)
_KERNELS = {
    "acoustic": _CudaKernel("stencil_tb", 2, st.second_derivative_weights,
                            2, stream_windows=(), stream_from_halo=4,
                            wave_from_order=8, wave_from_halo=12,
                            wave_max_cluster=4, bf16_first_windows=2),
    # p and r twice (ping-pong) from the first step's region, the three
    # inner first derivatives from the first phase A's (`tti_blk_floats`);
    # streamed from the least halo measured, 4 (order 4, T = 1: 14.2
    # against 15.5 ms), as its z taps come from shared memory
    "tti": _CudaKernel("stencil_tb_tti", 7, st.first_derivative_weights, 1,
                       stream_windows=(2, 2, 2, 2, 1, 1, 1),
                       stream_from_halo=4, cluster_from_order=8,
                       cluster_from_halo=16, bf16_first_windows=4 + 3 * 2),
    "elastic": _CudaKernel(
        "stencil_tb_elastic", 9,
        lambda order: st.staggered_first_derivative_weights(order)[1], 1,
        stream_windows=(0,) * 9, stream_from_halo=12, cluster_from_order=8,
        cluster_from_halo=16, bf16_first_windows=9 + 1 + 3 * 2),
}


def _stream_smem(physics: phys.TBPhysics, spec: TBKernelSpec, bx: int,
                 by: int) -> int:
    """Shared memory of one block of a z-streamed kernel on sub-tile
    (bx, by) (`acoustic_smem` / `tti_smem` / `elastic_smem` in the .cu
    files, which size the launch; a launch refuses a sub-tile beyond
    STREAM_SMEM)."""
    H, r = spec.halo, spec.radius
    tiles = _WB_TILES
    if physics.name == "acoustic":
        T = spec.T
        pitch = (bx * by + 31) // 32 * 32 + 4
        f = (2 * r + 2) * (bx + 2 * H) * (by + 2 * H)
        f += sum((2 * r + 1) * (bx + 2 * (H - j * r)) * (by + 2 * (H - j * r))
                 for j in range(1, T))
        return 4 * (f + 2 * _OUT_CHUNK * pitch)
    if physics.name == "tti":
        # phase A: rings of 2r + 2 planes of p and r over the block window;
        # phase B: rings of Dx~p and Dz~r and two planes of Dy~p over the
        # window less r
        ring = 2 * r + 2
        return max(4 * 2 * ring * (bx + 2 * H) * (by + 2 * H),
                   4 * (2 * ring + 2) * (bx + 2 * H - 2 * r)
                   * (by + 2 * H - 2 * r), tiles)
    # elastic: two buffers of five planes of the block window
    return max(4 * 2 * 5 * (bx + 2 * H) * (by + 2 * H), tiles)


def stream_plan(spec: TBKernelSpec,
                physics: phys.TBPhysics) -> Tuple[int, int, int]:
    """(bx, by, shared bytes): the sub-tile a block of the z-streamed
    schedule takes: the largest of the tile's divisors whose working set
    fits a block's shared memory, among equal areas the most nearly
    square, then the larger bx.  Raises ValueError when none fits."""
    tx, ty = spec.tile
    best = None
    for bx in range(tx, 0, -1):
        if tx % bx:
            continue
        for by in range(ty, 0, -1):
            if ty % by:
                continue
            need = _stream_smem(physics, spec, bx, by)
            if need > _STREAM_SMEM:
                continue
            key = (bx * by, -abs(bx - by))
            if best is None or key > best[0]:
                best = (key, (bx, by, need))
    if best is None:
        raise ValueError(
            f"{physics.name}: T={spec.T} order {spec.order} (halo "
            f"{spec.halo}) needs more shared memory than a block has even "
            f"for a 1x1 sub-tile; use a smaller T or order")
    return best[1]


Chunk = Tuple[int, int, int, int]        # (x0, y0, h, w), window-local


@dataclasses.dataclass(frozen=True)
class ClusterPlan:
    """The cluster-shared trapezoid (B5) of one launch shape: `cluster`
    blocks share each spec tile; `chunks[n - 1][b]` are block b's chunks
    of pass n (`pass_chunks`); `smem` the shared bytes a block takes (the
    largest chunk's need); `chunk` the largest chunk's (h, w)."""

    cluster: int
    chunk: Tuple[int, int]
    smem: int
    chunks: Tuple[Tuple[Tuple[Chunk, ...], ...], ...]


def chunk_load(R: int, x0: int, y0: int, h: int,
               w: int) -> Tuple[int, int, int, int]:
    """(x, y, h, w) of the points a chunk's pass loads a plane of
    (`chunk_load` in csrc/tb_cluster.cuh): the chunk and its seam, R
    points of the previous pass's output on every side, widened in y to
    whole 16-byte groups of the window's rows."""
    ly = (y0 - R) // 4 * 4
    return x0 - R, ly, h + 2 * R, -(-(y0 + w + R) // 4) * 4 - ly


def chunk_smem(physics: phys.TBPhysics, R: int, n: int, lh: int,
               lw: int) -> int:
    """Shared bytes of a B5 chunk of pass n whose load rectangle is lh x lw
    (`tti_chunk_smem` / `elastic_chunk_smem` in the .cu files): TTI's
    phase A streams p and r through rings of 2R + 2 planes, phase B Dx~p
    and Dz~r the same way and Dy~p through two planes; elastic's phase V
    the three stresses it takes z taps of through rings and the other
    three through two planes, phase S the three velocities through
    rings; at least the write-back's warp tiles."""
    cap = lh * lw
    ring = 2 * R + 2
    if physics.name == "tti":
        planes = 2 * ring if n % 2 else 2 * ring + 2
    else:
        planes = 3 * ring + 6 if n % 2 else 3 * ring
    return max(4 * planes * cap, _WB_TILES)


def _split(n: int, k: int):
    """n points in k near-equal runs: [(start, size)]."""
    q, r = divmod(n, k)
    return [(i * q + min(i, r), q + (i < r)) for i in range(k)]


@functools.lru_cache(maxsize=None)
def _pass_chunks(name: str, wx: int, wy: int, R: int, npass: int,
                 cluster: int):
    physics = phys.PHYSICS[name]
    passes = []
    for n in range(1, npass + 1):
        m = n * R
        hx, hy = wx - 2 * m, wy - 2 * m
        best = None
        for px in (d for d in range(1, cluster + 1) if cluster % d == 0):
            py = cluster // px
            if px > hx or py > hy:
                continue
            parts = [(x0, y0, h, w) for x0, h in _split(hx, px)
                     for y0, w in _split(hy, py)]
            # a part more than a quarter above the mean keeps the other
            # blocks waiting at the pass's barrier
            uneven = max(h * w for _, _, h, w in parts) * cluster \
                > 1.25 * hx * hy
            # the fewest chunks a part (qx x qy) at which every chunk fits
            # a block, among them the least seam a block loads
            for q in range(1, hx * hy + 1):
                fits = []
                for qx in (d for d in range(1, q + 1) if q % d == 0):
                    qy = q // qx
                    if qx > hx // px or qy > hy // py:
                        continue
                    blocks = [[(m + x0 + cx, m + y0 + cy, ch, cw)
                               for cx, ch in _split(h, qx)
                               for cy, cw in _split(w, qy)]
                              for x0, y0, h, w in parts]
                    loads = [[chunk_load(R, *c) for c in b] for b in blocks]
                    if any(chunk_smem(physics, R, n, lh, lw) > _STREAM_SMEM
                           for b in loads for _, _, lh, lw in b):
                        continue
                    seam = max(sum(lh * lw for _, _, lh, lw in b)
                               for b in loads)
                    fits.append((seam, qx, blocks))
                if fits:
                    seam, _, blocks = min(fits, key=lambda f: f[:2])
                    break
            else:
                continue
            if best is None or (uneven, q, seam) < best[0]:
                best = ((uneven, q, seam), blocks)
        if best is None:
            raise ValueError(f"{name}: pass {n}'s region {hx}x{hy} fits no "
                             f"chunking over {cluster} blocks")
        passes.append(tuple(tuple(b) for b in best[1]))
    return tuple(passes)


def pass_chunks(spec: TBKernelSpec, physics: phys.TBPhysics,
                cluster: int):
    """Each block's chunks of each pass of the cluster-shared trapezoid
    (B5) on `spec`, handed to the kernel as an int table (`chunk_table`):
    ``out[n - 1][b]`` is block b's tuple of (x0, y0, h, w) chunks of pass
    n (window-local output points).  Pass n of 2T computes the spec
    window's region of margin n R (R = order // 2); its region is cut
    into `cluster` near-equal parts (px x py, one a block, so every point
    of a level is computed once a spec tile and the blocks' areas differ
    by a row or a column), and each part into the fewest near-equal
    chunks whose load rectangle (`chunk_load`) fits a block's shared
    memory (`chunk_smem`): the grid of parts and chunks whose largest
    part is within a quarter of the mean, then with the fewest chunks a
    part, then with the least seam a block loads."""
    wx, wy, _ = spec.window
    return _pass_chunks(physics.name, wx, wy, spec.radius, 2 * spec.T,
                        cluster)


def cluster_size(spec: TBKernelSpec) -> int:
    """Blocks a B5 cluster takes at `spec`: the C of `_ACTIVE_CLUSTERS`
    whose launch of one row (a cluster a spec tile) ends soonest, taking
    a tile's time as 1 / C and the launch's as its waves, ceil(tiles /
    clusters at once), times that; the smaller C on a tie, and only a C
    whose blocks can each take a part of the tile (`pass_chunks`)."""
    ntx, nty = spec.ntiles
    tx, ty = spec.tile
    best = None
    for c, active in sorted(_ACTIVE_CLUSTERS.items()):
        if not any(c % px == 0 and px <= tx and c // px <= ty
                   for px in range(1, c + 1)):
            continue
        cost = -(-ntx * nty // active) / c
        if best is None or cost < best[0]:
            best = (cost, c)
    return best[1]


def cluster_plan(spec: TBKernelSpec, physics: phys.TBPhysics,
                 cluster: Optional[int] = None) -> ClusterPlan:
    """The B5 launch of `spec`: `cluster` (default `cluster_size`) blocks
    a spec tile, each pass's chunks (`pass_chunks`), the shared bytes a
    block takes (the largest chunk's `chunk_smem`) and the largest
    chunk's (h, w).  Raises ValueError where the kernel has no B5 or its
    rows are not whole 16-byte groups (a tile width ty not a multiple of
    4)."""
    if _KERNELS[physics.name].cluster_from_order is None:
        raise ValueError(f"{physics.name}: no cluster-shared schedule")
    if spec.tile[1] % 4:
        raise ValueError(f"tile {spec.tile}: B5 needs ty a multiple of 4")
    c = cluster_size(spec) if cluster is None else cluster
    chunks = pass_chunks(spec, physics, c)
    R = spec.radius
    smem = max(chunk_smem(physics, R, n, *chunk_load(R, *ch)[2:])
               for n, per_block in enumerate(chunks, 1)
               for b in per_block for ch in b)
    big = max((ch for p in chunks for b in p for ch in b),
              key=lambda ch: ch[2] * ch[3])
    return ClusterPlan(c, big[2:], smem, chunks)


def redundancy(spec: TBKernelSpec, physics: phys.TBPhysics,
               plan="launch") -> float:
    """Points a launch computes a pass over the tile's points: 1 when every
    level is computed once.  The first schedule computes the whole window
    every pass, the z-streamed one each sub-tile's trapezoid (phase n of
    2T over its block window less n R a side, one step a pass for
    acoustic), B5 the spec tile's trapezoid once.  `plan` defaults to the
    one `launch_plan` picks."""
    if plan == "launch":
        plan = launch_plan(spec, physics)
    tx, ty = spec.tile
    wx, wy, _ = spec.window
    h = spec.halo
    if plan is None:
        return wx * wy / (tx * ty)
    steps = spec.T if physics.name == "acoustic" else 2 * spec.T
    r = h // steps
    if isinstance(plan, (ClusterPlan, WavePlan)):
        bx, by = tx, ty
    else:
        bx, by = plan[:2]
    return sum((bx + 2 * (h - n * r)) * (by + 2 * (h - n * r))
               for n in range(1, steps + 1)) / (steps * bx * by)


@dataclasses.dataclass(frozen=True)
class WavePlan:
    """The cluster-shared z-wavefront (B6) of one acoustic launch shape:
    `cluster` blocks share each spec tile, block a * py + b keeping part
    (a, b) of every level, the parts cut by lines fixed in window
    coordinates (`xcuts`: px + 1 lines from 0 to wx, `ycuts` the same in
    y); `planes` planes of every level a step; `smem` the shared bytes a
    block takes (`wave_smem`)."""

    cluster: int
    parts: Tuple[int, int]
    xcuts: Tuple[int, ...]
    ycuts: Tuple[int, ...]
    smem: int
    planes: int = 1


def wave_slots(r: int, j: int, T: int, K: int = 1) -> int:
    """Planes of level j's ring in B6 at K planes a step (`wave_slots` in
    csrc/stencil_tb.cu): the 2r + K planes level j + 1 taps, the K planes
    level j writes meanwhile, and where level j + 2 reads it as u_prev,
    r + K planes behind, K more."""
    return 2 * r + 3 * K if j + 2 <= T else 2 * r + 2 * K


def wave_rect(xcuts, ycuts, a: int, b: int, j: int, r: int, wx: int,
              wy: int, ring: bool = False) -> Chunk:
    """(x0, y0, h, w), window-local, of part (a, b) at level j of B6
    (`wave_rect` in csrc/stencil_tb.cu): its own points, the part within
    the region of margin j r; with `ring` the rectangle its ring holds,
    those widened by r within the region (the seam: its neighbours'
    points that level j + 1 taps)."""
    s, m = (r if ring else 0), j * r
    x0, x1 = max(xcuts[a] - s, m), min(xcuts[a + 1] + s, wx - m)
    y0, y1 = max(ycuts[b] - s, m), min(ycuts[b + 1] + s, wy - m)
    return x0, y0, x1 - x0, y1 - y0


def wave_smem(T: int, r: int, wx: int, wy: int, xcuts, ycuts,
              K: int = 1) -> int:
    """Shared bytes of a B6 block at K planes a step (`wave_smem` in
    csrc/stencil_tb.cu, which refuses a launch given less): the largest
    part's rings of levels 0..T-1 (`wave_slots` planes of its ring
    rectangle each) and the staging of its part of the centre, OUT_CHUNK
    planes of u_T and of u_{T-1}."""
    most = 0
    for a in range(len(xcuts) - 1):
        for b in range(len(ycuts) - 1):
            f = sum(wave_slots(r, j, T, K) * h * w for j in range(T)
                    for _, _, h, w in [wave_rect(xcuts, ycuts, a, b, j, r,
                                                 wx, wy, True)])
            _, _, h, w = wave_rect(xcuts, ycuts, a, b, T, r, wx, wy)
            f += 2 * _OUT_CHUNK * ((h * w + 31) // 32 * 32 + 4)
            most = max(most, 4 * f)
    return most


def wave_cuts(n: int, H: int, r: int, T: int, p: int) -> Tuple[int, ...]:
    """p + 1 cut lines, 0 to n, of a window n points wide into B6's p parts
    along it: at the nearest points where the levels' work splits evenly
    (a window column's work: the levels 1..T whose region holds it).
    Raises ValueError where a part would be narrower than r (its seam then
    reaches beyond its neighbours) or a cut would fall outside the tile
    (H, n - H) (a part without points at some level)."""
    weight = [sum(j * r <= x < n - j * r for j in range(1, T + 1))
              for x in range(n)]
    total = sum(weight)
    cuts, acc, x = [0], 0, 0
    for k in range(1, p):
        while acc + weight[x] / 2 < k * total / p:
            acc += weight[x]
            x += 1
        cuts.append(x)
    cuts.append(n)
    if any(b - a < r for a, b in zip(cuts, cuts[1:])) or any(
            not H < c < n - H for c in cuts[1:-1]):
        raise ValueError(f"{p} parts of a window {n} wide (halo {H}, radius "
                         f"{r}): a part narrower than {r} or a cut outside "
                         "the tile")
    return tuple(cuts)


@functools.lru_cache(maxsize=None)
def _wave_plan(wx: int, wy: int, H: int, r: int, T: int, cluster: int,
               K: int) -> Optional[WavePlan]:
    if r < _WAVE_MIN_R or K > 1 and (r % K or r < 3 * K - 2):
        return None
    best = None
    for px in (d for d in range(1, cluster + 1) if cluster % d == 0):
        py = cluster // px
        try:
            xc, yc = wave_cuts(wx, H, r, T, px), wave_cuts(wy, H, r, T, py)
        except ValueError:
            continue
        smem = wave_smem(T, r, wx, wy, xc, yc, K)
        if smem <= _STREAM_SMEM and (best is None or (smem, -px) < best[0]):
            best = ((smem, -px), WavePlan(cluster, (px, py), xc, yc, smem,
                                          K))
    return None if best is None else best[1]


def wave_plan(spec: TBKernelSpec, physics: phys.TBPhysics,
              cluster: Optional[int] = None,
              planes: Optional[int] = None) -> WavePlan:
    """The B6 launch of `spec`: `cluster` blocks a spec tile and `planes`
    planes a step (defaults: `wave_size`), cut into px x py parts
    (`wave_cuts`), the grid of parts whose largest block needs the least
    shared memory.  Two planes a step need an even radius of at least 4
    (a step's planes then start at multiples of 2, and a seam is read two
    or more steps after it is written).  Raises ValueError where the
    kernel has no B6 (TTI, elastic), the launch is not float32 at T =
    2..8 and space order 8..16 with ty a multiple of 4, or no parts of
    that cluster fit a block."""
    if _KERNELS[physics.name].wave_from_order is None:
        raise ValueError(f"{physics.name}: no cluster-shared wavefront")
    if spec.dtype != torch.float32 or not 2 <= spec.T <= _WAVE_MAX_T:
        raise ValueError(f"B6 takes float32 at T = 2..{_WAVE_MAX_T}, not "
                         f"{spec.dtype} at T = {spec.T}")
    if spec.tile[1] % 4:
        raise ValueError(f"tile {spec.tile}: B6 needs ty a multiple of 4")
    c, k = wave_size(spec)
    if planes is not None:
        ks = (planes,)
    elif cluster is None:
        ks = (k,)
    else:                       # the most planes a step that fit
        ks = range(_WAVE_MAX_K, 0, -1)
    c = c if cluster is None else cluster
    wx, wy, _ = spec.window
    for k in ks:
        plan = (_wave_plan(wx, wy, spec.halo, spec.radius, spec.T, c, k)
                if 1 <= c <= _CLUSTER_MAX and 1 <= k <= _WAVE_MAX_K
                else None)
        if plan is not None:
            return plan
    raise ValueError(f"acoustic T={spec.T} order {spec.order} tile "
                     f"{spec.tile}: no parts of {c} blocks at "
                     f"{planes or 'any number of'} planes a step fit a "
                     "block's shared memory")


def wave_size(spec: TBKernelSpec) -> Tuple[int, int]:
    """(blocks a cluster, planes a step) of B6 at `spec`: the fewest blocks
    of `_WAVE_CLUSTERS` whose parts fit a block at the most planes a step
    that fit, else at one (the largest cluster where none fits:
    `wave_plan` then raises)."""
    wx, wy, _ = spec.window
    for c in _WAVE_CLUSTERS:
        for k in range(_WAVE_MAX_K, 0, -1):
            if _wave_plan(wx, wy, spec.halo, spec.radius, spec.T, c,
                          k) is not None:
                return c, k
    return _WAVE_CLUSTERS[-1], 1


# (plan, device) -> the chunk table on the host and on the device
_TABLES: Dict = {}


def chunk_table(plan: ClusterPlan, dev) -> Tuple[np.ndarray, torch.Tensor]:
    """The kernel's chunk table of a B5 plan, int32: ``2T * cluster + 1``
    starts (block b's chunks of pass n are entries [start[(n - 1) *
    cluster + b], start[(n - 1) * cluster + b + 1])), then the chunks'
    (x0, y0, h, w).  The host copy is what the C entry checks, the device
    copy (made once a plan and device) what the kernel reads."""
    key = (plan, str(dev))
    if key not in _TABLES:
        starts, flat = [0], []
        for per_block in plan.chunks:
            for chunks in per_block:
                flat += [v for ch in chunks for v in ch]
                starts.append(len(flat) // 4)
        host = np.ascontiguousarray(starts + flat, dtype=np.int32)
        _TABLES[key] = (host, torch.from_numpy(host).to(dev))
    return _TABLES[key]


def launch_plan(spec: TBKernelSpec, physics: phys.TBPhysics):
    """The schedule a CUDA launch of this shape takes: a `ClusterPlan`
    (B5, TTI and elastic from the kernel's `cluster_from_order` and
    `cluster_from_halo` up, where the tile's rows are whole 16-byte
    groups), a `WavePlan` (B6, acoustic from `wave_from_order` and
    `wave_from_halo` up, where `wave_plan`'s parts fit clusters of at most
    `wave_max_cluster` blocks), the z-streamed schedule's (bx, by, shared
    bytes) (`stream_plan`), or None for the first
    schedule.  The z-streamed one is taken from the kernel's
    `stream_from_halo` up, where a sub-tile fits a block's shared
    memory and its window overhangs it at most `_MAX_OVERHANG` times;
    elsewhere the first schedule is the faster, or the only one that
    runs."""
    kern = _KERNELS[physics.name]
    if (kern.cluster_from_order is not None
            and spec.order >= kern.cluster_from_order
            and spec.halo >= kern.cluster_from_halo
            and spec.tile[1] % 4 == 0):
        return cluster_plan(spec, physics)
    if (kern.wave_from_order is not None
            and spec.order >= kern.wave_from_order
            and spec.halo >= kern.wave_from_halo):
        try:
            plan = wave_plan(spec, physics)
        except ValueError:          # bf16, T = 1, or no parts fit
            plan = None
        if plan is not None and plan.cluster <= kern.wave_max_cluster:
            return plan
    if spec.halo < kern.stream_from_halo:
        return None
    if physics.name == "acoustic" and spec.T > _MAX_T:
        return None
    try:
        bx, by, smem = stream_plan(spec, physics)
    except ValueError:
        return None
    h = spec.halo
    if (bx + 2 * h) * (by + 2 * h) > _MAX_OVERHANG * bx * by:
        return None
    return bx, by, smem


def _scratch_elems(spec: TBKernelSpec,
                   physics: phys.TBPhysics) -> Tuple[int, int, torch.dtype]:
    """(scratch elements a row of a launch needs, elements of the params'
    float32 z-major copies (one row of params), the scratch's dtype).  The
    first schedule's scratch is its tiles' windows in the storage dtype
    (in bf16 `bf16_first_windows` of them: its float32 windows at two bf16
    windows each) and it takes no copies; the z-streamed schedule's is
    float32: z-major copies of the row's state and its blocks' windows,
    and the params' copies (`param_copies`, or made by the launch in its
    scratch); B5's the same copies and `scratch_windows` whole spec
    windows a tile; B6's the copies alone."""
    ntx, nty = spec.ntiles
    kern = _KERNELS[physics.name]
    plan = launch_plan(spec, physics)
    wx, wy, nz = spec.window
    if plan is None:
        windows = (kern.scratch_windows if spec.dtype == torch.float32
                   else kern.bf16_first_windows)
        return ntx * nty * windows * wx * wy * nz, 0, spec.dtype
    h = spec.halo
    vol = (spec.nx + 2 * h) * (spec.ny + 2 * h) * spec.nz
    if isinstance(plan, WavePlan):
        blocks, windows = 0, 0          # every level stays on chip
    elif isinstance(plan, ClusterPlan):
        blocks, windows = ntx * nty, kern.scratch_windows * wx * wy
    else:
        bx, by, _ = plan
        blocks = (spec.nx // bx) * (spec.ny // by)
        r = spec.radius
        windows = sum((bx + 2 * h - 2 * m * r) * (by + 2 * h - 2 * m * r)
                      for m in kern.stream_windows)
    per_row = len(physics.state_fields) * vol + blocks * windows * spec.nz
    return per_row, len(physics.param_fields) * vol, torch.float32


def scratch_bytes(spec: TBKernelSpec, physics: phys.TBPhysics,
                  rows: int) -> int:
    """Bytes of scratch a CUDA launch of `spec` on `rows` rows (shots, or
    the sharded layer's shards) works in when it is given the params'
    copies: each row's part (`_scratch_elems`)."""
    per_row, _, sdtype = _scratch_elems(spec, physics)
    return rows * per_row * sdtype.itemsize


def make_scratch(specs, physics: phys.TBPhysics, rows: int,
                 device) -> torch.Tensor:
    """One scratch buffer (bytes) for launches of every spec of `specs`
    (None entries skipped) on `rows` rows, given the params' copies, to
    pass to each `tb_time_tile` as `scratch=`.  Its owner, a
    propagation's tile loop or a survey engine, makes it once, before its
    first launch, and keeps it no longer than it runs launches: it is the
    largest block a launch needs."""
    need = max(scratch_bytes(s, physics, rows)
               for s in specs if s is not None)
    return torch.empty(max(need, 1), dtype=torch.uint8, device=device)


def check_scratch(scratch: torch.Tensor, need: int, dev) -> None:
    """Raise unless `scratch` can be a launch's scratch of `need` bytes on
    `dev`: a contiguous 1-D uint8 tensor there, 16-byte aligned, of at
    least `need` bytes (the remainder tile's launch takes a larger
    buffer made for the main tile's)."""
    if scratch.device != dev:
        raise ValueError(f"scratch is on {scratch.device}, expected {dev}")
    if scratch.dtype != torch.uint8:
        raise TypeError(f"scratch has dtype {scratch.dtype}, expected "
                        "torch.uint8 (bytes, from make_scratch)")
    if scratch.dim() != 1 or not scratch.is_contiguous() \
            or scratch.data_ptr() % 16:
        raise ValueError("scratch must be a contiguous, 16-byte aligned 1-D "
                         "tensor")
    if scratch.numel() < need:
        raise ValueError(f"scratch has {scratch.numel()} bytes, the launch "
                         f"needs {need}")


def _bind(source: str):
    from repro_torch.kernels import _build
    lib = _build.load(source)
    if lib.repro_tb_tile.argtypes is None:
        p, i = ctypes.c_void_p, ctypes.c_int
        entries = [lib.repro_tb_tile, lib.repro_tb_tile_bf16]
        # the sub-tile (bx, by) of the z-streamed schedule, (0, 0) for
        # the first
        for fn in entries:
            fn.argtypes = ([i] + [p] * 9 + [i] * 12 + [p]
                           + [ctypes.c_float] * 2 + [i, i, p])
            fn.restype = i
        if hasattr(lib, "repro_tb_tile_cluster"):
            # B5: the cluster size, the chunk table on the host and on the
            # device, its length, the shared bytes a block
            for fn in (lib.repro_tb_tile_cluster,
                       lib.repro_tb_tile_cluster_bf16):
                fn.argtypes = ([i] + [p] * 9 + [i] * 12 + [p]
                               + [ctypes.c_float] * 2 + [i, p, p, i, i, p])
                fn.restype = i
            for fn in (lib.repro_tb_cluster_occupancy,
                       lib.repro_tb_cluster_occupancy_bf16):
                fn.argtypes = [i, i, i, i, p]
                fn.restype = i
        if hasattr(lib, "repro_tb_tile_wave"):
            # B6: the cluster size, the parts (px, py), the planes a step,
            # the cut lines in x and in y, the shared bytes a block
            lib.repro_tb_tile_wave.argtypes = (
                [i] + [p] * 9 + [i] * 12 + [p] + [ctypes.c_float] * 2
                + [i, i, i, i, p, p, i, p])
            lib.repro_tb_tile_wave.restype = i
            lib.repro_tb_wave_occupancy.argtypes = [i, i, i, i, p]
            lib.repro_tb_wave_occupancy.restype = i
        for fn in (lib.repro_tb_param_copies,
                   lib.repro_tb_param_copies_bf16):
            fn.argtypes = [i, p] + [i] * 7 + [p, p]
            fn.restype = i
        lib.repro_bf16_built.argtypes = [i, i]
        lib.repro_bf16_built.restype = i
        lib.repro_cuda_error_string.argtypes = [i]
        lib.repro_cuda_error_string.restype = ctypes.c_char_p
        if lib.repro_max_radius() != _MAX_RADIUS:
            raise RuntimeError(f"csrc/{source}.cu MAX_RADIUS disagrees with "
                               "the wrapper")
    return lib


def _device_index(dev) -> int:
    return dev.index if dev.index is not None else \
        torch.cuda.current_device()


def param_copies(spec: TBKernelSpec, physics: phys.TBPhysics,
                 param_pads) -> Optional[torch.Tensor]:
    """The params' float32 z-major copies ((nparam, rows, X * Y * nz)) that
    a z-streamed or B5 launch of `spec` reads, made once by the caller that
    owns the params (a propagation's tile loop, a survey executable) and passed
    to each `tb_time_tile`; None where the launch takes none (the first
    schedule, the plain version on the CPU).  A launch given none makes
    them in its scratch every time."""
    dev = param_pads[0].device
    if dev.type != "cuda" or launch_plan(spec, physics) is None:
        return None
    lib = _bind(_KERNELS[physics.name].source)
    param_rows = param_pads[0].dim() == 4
    rows = param_pads[0].shape[0] if param_rows else 1
    h = spec.halo
    vol = (spec.nx + 2 * h) * (spec.ny + 2 * h) * spec.nz
    copies = torch.empty((len(param_pads), rows, vol), dtype=torch.float32,
                         device=dev)
    entry = (lib.repro_tb_param_copies if spec.dtype == torch.float32
             else lib.repro_tb_param_copies_bf16)
    rc = entry(_device_index(dev), _ptrs(param_pads), len(param_pads),
               int(param_rows), rows, spec.nx, spec.ny, spec.nz, h,
               ctypes.c_void_p(copies.data_ptr()),
               ctypes.c_void_p(torch.cuda.current_stream(dev).cuda_stream))
    if rc != 0:
        raise RuntimeError("param copies failed: "
                           + lib.repro_cuda_error_string(rc).decode())
    return copies


def cluster_occupancy(spec: TBKernelSpec, physics: phys.TBPhysics,
                      plan: ClusterPlan, dom: bool = False) -> int:
    """Clusters of a B5 launch of `plan` in `spec.dtype` the card holds at
    once (cudaOccupancyMaxActiveClusters; a launch whose clusters number
    more runs in waves, and one that gets 0 raises).  Needs a card."""
    lib = _bind(_KERNELS[physics.name].source)
    out = ctypes.c_int(0)
    query = (lib.repro_tb_cluster_occupancy if spec.dtype == torch.float32
             else lib.repro_tb_cluster_occupancy_bf16)
    rc = query(spec.radius, int(dom), plan.cluster, plan.smem,
               ctypes.byref(out))
    if rc != 0:
        raise RuntimeError("cluster occupancy query failed: "
                           + lib.repro_cuda_error_string(rc).decode())
    return out.value


def bf16_built(spec: TBKernelSpec, physics: phys.TBPhysics,
               dom: bool = False) -> bool:
    """Whether `physics`' bf16 kernel is built at `spec`'s space order,
    without or with (`dom`) a domain mask: its library's answer
    (`radius_built` in csrc/tb_common.cuh: B1a-bf16 at every order, TTI,
    elastic and any launch with a mask at the orders their paths launch).
    Needs the library."""
    lib = _bind(_KERNELS[physics.name].source)
    return bool(lib.repro_bf16_built(spec.radius, int(dom)))


def wave_occupancy(spec: TBKernelSpec, physics: phys.TBPhysics,
                   plan: WavePlan, dom: bool = False) -> int:
    """Clusters of a B6 launch of `plan` the card holds at once
    (cudaOccupancyMaxActiveClusters at the plan's shared bytes; a launch
    whose clusters number more runs in waves, one that gets 0 raises).
    Needs a card."""
    lib = _bind(_KERNELS[physics.name].source)
    out = ctypes.c_int(0)
    rc = lib.repro_tb_wave_occupancy(spec.radius, int(dom), plan.cluster,
                                     plan.smem, ctypes.byref(out))
    if rc != 0:
        raise RuntimeError("cluster occupancy query failed: "
                           + lib.repro_cuda_error_string(rc).decode())
    return out.value


def _check(name, t, shape, dtype, dev):
    if t.device != dev:
        raise ValueError(f"{name} is on {t.device}, expected {dev}")
    if t.dtype != dtype:
        raise TypeError(f"{name} has dtype {t.dtype}, expected {dtype}")
    if tuple(t.shape) != tuple(shape):
        raise ValueError(f"{name} has shape {tuple(t.shape)}, expected "
                         f"{tuple(shape)}")
    if not t.is_contiguous():
        raise ValueError(f"{name} must be contiguous")


def kernel_coefs(spec: TBKernelSpec, physics: phys.TBPhysics):
    """The kernel's FD coefficients: each axis' taps in order (x, then y,
    then z), ``w * h**-deriv`` computed in float64 and rounded to float32
    as the reference's stencils round them (a zero weight stays 0)."""
    k = _KERNELS[physics.name]
    w = k.weights(spec.order)
    return tuple(st.round_to(wk * float(h) ** -k.deriv, torch.float32)
                 for h in spec.spacing for wk in w)


def _ptrs(ts):
    return (ctypes.c_void_p * len(ts))(*(t.data_ptr() for t in ts))


def _tb_time_tile_cuda(spec: TBKernelSpec, physics: phys.TBPhysics,
                       state_pads, param_pads, s_coords, s_vals, r_coords,
                       r_w, dom, copies, scratch):
    if physics.name not in _KERNELS:
        raise ValueError(f"no CUDA TB kernel for physics {physics.name!r}")
    kern = _KERNELS[physics.name]
    dev = state_pads[0].device
    f32 = torch.float32
    dtype = spec.dtype
    h = spec.halo
    ntx, nty = spec.ntiles
    ntiles = ntx * nty
    wx, wy, nz = spec.window
    if dtype not in (f32, torch.bfloat16):
        raise TypeError(f"spec.dtype {dtype}: the TB kernels take float32 "
                        "or bfloat16")
    lib = _bind(kern.source)
    if dtype == torch.bfloat16 and not bf16_built(spec, physics,
                                                  dom is not None):
        # B1a-bf16 (acoustic) at every order; B1b-bf16 (TTI, elastic) and
        # B1c-bf16 (`dom`) at the orders their paths launch
        raise ValueError(
            f"{physics.name}{' with dom' if dom is not None else ''}: the "
            f"bfloat16 kernel is not built at space order {spec.order} "
            "(radius_built in csrc/tb_common.cuh)")
    if h != spec.T * physics.step_radius(spec.order):
        raise ValueError(f"spec halo {h} is not T * {physics.name}'s step "
                         f"radius {physics.step_radius(spec.order)}")
    names = physics.state_fields + physics.param_fields
    fields = (*state_pads, *param_pads)
    if len(fields) != len(names):
        raise ValueError(f"{physics.name} takes {len(names)} fields "
                         f"{names}, got {len(fields)}")
    if state_pads[0].dim() != 4:
        raise ValueError(f"state fields must be (B, nx + 2H, ny + 2H, nz), "
                         f"got {tuple(state_pads[0].shape)}")
    B = state_pads[0].shape[0]
    if not 1 <= B <= 65535:
        raise ValueError(f"{B} shots: the kernel takes 1..65535")
    pad_shape = (spec.nx + 2 * h, spec.ny + 2 * h, spec.nz)
    # params: one copy for every row, or one a row (the sharded layer)
    param_rows = param_pads[0].dim() == 4
    for i, (name, t) in enumerate(zip(names, fields)):
        shot_axis = (B,) if i < len(state_pads) or param_rows else ()
        _check(name, t, shot_axis + pad_shape, dtype, dev)
    if dom is not None:
        _check("dom", dom, (B,) + pad_shape[:2], f32, dev)
    cap, capr = s_coords.shape[-2], r_coords.shape[-2]
    chan = physics.rec_channels
    _check("src_coords", s_coords, (B, ntiles, cap, 3), torch.int32, dev)
    _check("src_vals", s_vals, (B, ntiles, spec.T, cap), dtype, dev)
    _check("rec_coords", r_coords, (B, ntiles, capr, 3), torch.int32, dev)
    _check("rec_w", r_w, (B, ntiles, capr), dtype, dev)
    if wx * wy * nz >= 2 ** 31:
        raise ValueError(f"window {spec.window} too large for the kernel")
    r = spec.radius
    if not 1 <= r <= _MAX_RADIUS:
        raise ValueError(f"order {spec.order}: the kernel takes space orders "
                         f"2..{2 * _MAX_RADIUS}")
    coefs = kernel_coefs(spec, physics)
    dt = st.round_to(spec.dt, f32)
    dt2 = st.round_to(dt * dt, f32)

    plan = launch_plan(spec, physics)
    outs = tuple(torch.empty((B, spec.nx, spec.ny, spec.nz), dtype=dtype,
                             device=dev) for _ in physics.state_fields)
    rec = torch.zeros((B, ntx, nty, spec.T, capr, chan), dtype=dtype,
                      device=dev)
    per_row, pelems, sdtype = _scratch_elems(spec, physics)
    rows_flag = int(param_rows)
    extra = 0
    cluster = isinstance(plan, ClusterPlan)
    wave = isinstance(plan, WavePlan)
    if cluster:
        table, table_dev = chunk_table(plan, dev)
        tail = (plan.cluster, table.ctypes.data_as(ctypes.c_void_p),
                ctypes.c_void_p(table_dev.data_ptr()), table.size,
                plan.smem)
    elif wave:
        if dtype != f32:
            raise TypeError("the cluster-shared wavefront (B6) takes float32")
        tail = (plan.cluster, *plan.parts, plan.planes,
                (ctypes.c_int * len(plan.xcuts))(*plan.xcuts),
                (ctypes.c_int * len(plan.ycuts))(*plan.ycuts), plan.smem)
    else:
        # the z-streamed schedule's sub-tile, (0, 0) for the first
        tail = (0, 0) if plan is None else plan[:2]
    if plan is not None:
        prow = B if param_rows else 1
        if copies is None:
            extra = prow * pelems       # the launch copies the params
        else:
            # the caller's z-major copies (PARAMS_COPIED in tb_stream.cuh)
            _check("param_copies", copies,
                   (len(param_pads), prow, pelems // len(param_pads)), f32,
                   dev)
            fields = (*state_pads, *copies)
            rows_flag |= 2
    if scratch is None:
        scratch = torch.empty(max(B * per_row + extra, 1), dtype=sdtype,
                              device=dev)
    else:
        check_scratch(scratch, (B * per_row + extra) * sdtype.itemsize, dev)
    if cluster:
        entry = (lib.repro_tb_tile_cluster if dtype == f32
                 else lib.repro_tb_tile_cluster_bf16)
    else:
        entry = (lib.repro_tb_tile_wave if wave else lib.repro_tb_tile
                 if dtype == f32 else lib.repro_tb_tile_bf16)
    ptr = lambda t: ctypes.c_void_p(t.data_ptr())  # noqa: E731
    stream = torch.cuda.current_stream(dev).cuda_stream
    rc = entry(
        _device_index(dev),
        _ptrs(fields), ptr(s_coords), ptr(s_vals), ptr(r_coords), ptr(r_w),
        _ptrs(outs), ptr(rec), ptr(scratch),
        ctypes.c_void_p(dom.data_ptr() if dom is not None else None),
        rows_flag, B,
        spec.nx, spec.ny, spec.nz, spec.tile[0], spec.tile[1], spec.T, h,
        cap, capr, r, (ctypes.c_float * len(coefs))(*coefs), dt, dt2,
        *tail, ctypes.c_void_p(stream))
    if rc != 0:
        raise RuntimeError(f"{kern.source} CUDA launch failed: "
                           + lib.repro_cuda_error_string(rc).decode())
    global launches
    launches += 1
    schedule_launches[schedule_name(plan)] += 1
    return outs, rec


def schedule_name(plan) -> str:
    """"first", "z-streamed", "cluster" (B5) or "wavefront" (B6): the
    schedule of a `launch_plan` result."""
    if plan is None:
        return "first"
    if isinstance(plan, WavePlan):
        return "wavefront"
    return "cluster" if isinstance(plan, ClusterPlan) else "z-streamed"


def launch_bytes(spec: TBKernelSpec, physics: phys.TBPhysics) -> int:
    """Device bytes one shot of a CUDA launch allocates: its output fields,
    its receiver partials and its part of the scratch (`launch_plan`: the
    first schedule's tile windows in the storage dtype; the z-streamed
    schedule's float32 z-major copies of the shot's state and its blocks'
    windows, none for acoustic; B5's copies and its spec tiles' windows;
    B6's copies).
    The params' copies, shared by the shots, are `launch_shared_bytes`."""
    ntx, nty = spec.ntiles
    elems = (len(physics.state_fields) * spec.nx * spec.ny * spec.nz
             + ntx * nty * spec.T * spec.rec_cap * physics.rec_channels)
    return elems * spec.dtype.itemsize + scratch_bytes(spec, physics, 1)


def launch_shared_bytes(spec: TBKernelSpec,
                        physics: phys.TBPhysics) -> int:
    """Device bytes of the params' float32 z-major copies a z-streamed
    launch reads, for all its shots (one copy of shared params; a launch
    with one param row a shot needs this a row): `param_copies`, or the
    launch's own scratch where the caller passes none.  0 for the first
    schedule."""
    _, params, _ = _scratch_elems(spec, physics)
    return params * 4


def design_bytes(spec: TBKernelSpec, physics: phys.TBPhysics,
                 shots: int = 1, param_rows: bool = False) -> float:
    """Device bytes a launch moves by its schedule's design, no L2 reuse
    between blocks counted: the yardstick of the kernels' achieved GB/s
    beside `kernel_cost`'s least bytes.  The first schedule reads every
    read field's window and writes every evolved field's window once a
    step.  The z-streamed one makes the z-major copies (each padded input
    read in the storage dtype, written in float32; the params' counted
    as if the launch made them), then per block reads the planes its
    passes read and writes the fields they write, each region once a
    pass.  B5 (`ClusterPlan`) reads each chunk's load rectangle
    (`chunk_load`: the chunk, its seam and its 16-byte widening) of the
    tap fields and its points' pointwise operands, once a spec tile.  B6
    (`WavePlan`) reads u over each part's level-0 ring rectangle (the
    seams twice) and every level's pointwise operands once a spec tile;
    its seams between levels move between shared memories, not here."""
    h, nz = spec.halo, spec.nz
    item = spec.dtype.itemsize
    ns, npar = len(physics.state_fields), len(physics.param_fields)
    plan = launch_plan(spec, physics)
    ntx, nty = spec.ntiles
    wx, wy, _ = spec.window
    if plan is None:
        return float(shots * spec.T * ntx * nty * wx * wy * nz * item
                     * (physics.num_windows + len(physics.evolved_fields)))
    bx, by = spec.tile if isinstance(plan, (ClusterPlan, WavePlan)) \
        else plan[:2]
    vol = (spec.nx + 2 * h) * (spec.ny + 2 * h) * nz
    prow = shots if param_rows else 1
    copies = (ns * shots + npar * prow) * vol * (item + 4)
    blocks = shots * (spec.nx // bx) * (spec.ny // by)

    def area(margin):
        return (bx + 2 * (h - margin)) * (by + 2 * (h - margin))

    r = spec.radius
    if physics.name == "acoustic":
        lv = [area(j * r) for j in range(spec.T + 1)]
        if isinstance(plan, WavePlan):
            px, py = plan.parts
            lv[0] = sum(h * w for a in range(px) for b in range(py)
                        for _, _, h, w in [wave_rect(
                            plan.xcuts, plan.ycuts, a, b, 0, r, wx, wy,
                            True)])
        return float(copies + blocks * (
            4 * nz * (lv[0] + lv[1] + 2 * sum(lv[1:]))
            + 2 * item * bx * by * nz))
    # (tap planes read over the previous region, pointwise reads and
    # writes over the region) of phases (A, B) / (V, S): TTI taps p, r,
    # then Dx~p, Dy~p, Dz~r, reads theta, phi, then the 6 params and 4
    # state fields, and writes 3, then 2 fields; elastic as its notes
    terms = {"tti": ((2, 2 + 3), (3, 10 + 2)),
             "elastic": ((5, 11), (3, 18))}[physics.name]
    if isinstance(plan, ClusterPlan) and physics.name == "elastic":
        # B5 loads the z-tap fields with the chunk too: phase V six
        # stresses, then the 3 velocities and 2 params pointwise and 3
        # writes; phase S three velocities, then 6 stresses, 3 params, 6
        # writes
        terms = ((6, 8), (3, 15))
    per_block = 0
    for n in range(1, 2 * spec.T + 1):
        taps, points = terms[1 - n % 2]
        if isinstance(plan, ClusterPlan):
            seam = sum(lh * lw for b in plan.chunks[n - 1] for ch in b
                       for _, _, lh, lw in [chunk_load(r, *ch)])
        else:
            seam = area((n - 1) * r)
        per_block += taps * seam + points * area(n * r)
    per_block = 4 * nz * (per_block + 2 * ns * bx * by)
    return float(copies + blocks * per_block)


def tb_time_tile(spec: TBKernelSpec, physics: phys.TBPhysics,
                 state_pads, param_pads, src_coords, src_vals, rec_coords,
                 rec_w, dom=None, param_copies=None, scratch=None):
    """One depth-T time tile over the whole grid of each of B shots.

    Args:
      state_pads: one (B, nx + 2H, ny + 2H, nz) tensor per
                  physics.state_fields (zero-padded).
      param_pads: one (nx + 2H, ny + 2H, nz) tensor per
                  physics.param_fields (edge-padded), shared by the shots;
                  or one (B, nx + 2H, ny + 2H, nz) tensor each, one a row.
      src_coords: (B, ntiles, cap, 3) window-local int32.
      src_vals:   (B, ntiles, T, cap), scale folded in, 0 on padding.
      rec_coords: (B, ntiles, capr, 3) int32; rec_w: (B, ntiles, capr).
      dom:        None, or (B, nx + 2H, ny + 2H) float32: each row's mask
                  of the points inside the physical domain (nonzero), in
                  place of the grid predicate — a shard's pass over its
                  exchanged block (distributed/halo.py).
      param_copies: None, or the params' copies from `param_copies` for
                  this spec, which a z-streamed launch then reads instead
                  of copying the params itself (the plain version reads
                  the params).
      scratch:    None (the launch allocates its own), or a buffer from
                  `make_scratch` of at least `scratch_bytes` for this
                  launch, which the caller makes once and passes to every
                  launch (the plain version does not read it).
    Returns (new_states tuple, rec_partials) with fields (B, nx, ny, nz)
    and rec_partials (B, ntx, nty, T, capr, rec_channels).

    CPU tensors run `tb_time_tile_plain`; CUDA tensors launch the physics'
    kernel once for all B shots (contiguous; float32, or bfloat16 where
    `bf16_built`) or raise.  The launch
    goes on the current stream and does not synchronise.
    """
    dev = state_pads[0].device
    if dev.type == "cpu":
        return tb_time_tile_plain(spec, physics, state_pads, param_pads,
                                  src_coords, src_vals, rec_coords, rec_w,
                                  dom)
    if dev.type == "cuda":
        return _tb_time_tile_cuda(spec, physics, state_pads, param_pads,
                                  src_coords, src_vals, rec_coords, rec_w,
                                  dom, param_copies, scratch)
    raise ValueError(f"no TB time tile for device {dev}")


def kernel_cost(spec: TBKernelSpec,
                physics: phys.TBPhysics = phys.ACOUSTIC,
                shots: int = 1, shard_rows: bool = False) -> dict:
    """Analytic per-call cost of one time tile of `shots` shots.

    ``flops``/``hbm_bytes`` price the kernel's schedule (every window
    computed in full, each field's window read once per call, as the
    reference prices it); ``useful_flops`` is the stencil work on the grid
    as the reference counts it; ``needed_flops`` the work the output needs
    (below ``useful_flops`` for TTI, whose reference count prices rotated
    Laplacians it discards) and ``min_bytes`` the least traffic of the
    function (each unpadded input field read once, each output field
    written once) — the numerators of the roofline bound.  Bytes and
    FLOPs scale with the shots, except that the param fields, shared by
    all shots, are read once.  With `shard_rows` the rows are shards of
    the sharded layer: each reads its own padded state and params and its
    domain-mask plane once and writes its state.
    """
    ntx, nty = spec.ntiles
    wx, wy, wz = spec.window
    mod = {"acoustic": ac, "elastic": el, "tti": tt}[physics.name]
    stencil_flops = mod.model_flops_per_step((1, 1, 1), spec.order)
    needed = (tt.needed_flops_per_step((1, 1, 1), spec.order)
              if physics.name == "tti" else stencil_flops)
    window_pts = wx * wy * wz
    sparse_flops = (len(physics.inject_fields) * spec.src_cap
                    + 2 * physics.rec_channels * spec.rec_cap)
    flops = ntx * nty * spec.T * (window_pts * stencil_flops + sparse_flops)
    itemsize = spec.dtype.itemsize
    nw = physics.num_windows
    ns = len(physics.state_fields)
    grid_pts = spec.nx * spec.ny * spec.nz
    hbm_read = ntx * nty * window_pts * nw * itemsize
    hbm_write = grid_pts * ns * itemsize
    # per shot: its state in and out; once: the shared params
    fields_moved = shots * 2 * ns + (nw - ns)
    min_bytes = grid_pts * fields_moved * itemsize
    if shard_rows:
        pad_plane = (spec.nx + 2 * spec.halo) * (spec.ny + 2 * spec.halo)
        min_bytes = shots * itemsize * (pad_plane * (nw * spec.nz + 1)
                                        + ns * grid_pts)
    return {"flops": float(shots * flops),
            "hbm_bytes": float(shots * (hbm_read + hbm_write)),
            "useful_flops": float(shots * grid_pts * spec.T * stencil_flops),
            "needed_flops": float(shots * grid_pts * spec.T * needed),
            "min_bytes": float(min_bytes),
            "window_bytes": spec.window_bytes(nw)}
