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
``csrc/stencil_tb_elastic.cu`` elastic; float32, and bf16 for acoustic
without `dom`: kernel B1a-bf16) or raise.  `launches`
counts kernel launches, so a run can show it went through the kernel.
"""
from __future__ import annotations

import ctypes
import dataclasses
from typing import Callable, Optional, Tuple

import numpy as np
import torch

from repro_torch.core import stencil as st
from repro_torch.core.propagators import acoustic as ac
from repro_torch.core.propagators import elastic as el
from repro_torch.core.propagators import tti as tt
from repro_torch.kernels import tb_physics as phys

# kernel launches made by `tb_time_tile` (set it to 0 before a counted run)
launches = 0


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
                       r_w, dom=None):
    """Plain PyTorch version of `tb_time_tile`: the same per-window
    trapezoid, looped over the shots and the (ti, tj) tiles.  Runs on any
    device.  A param with a leading axis is one per row; `dom` (B,
    nx + 2H, ny + 2H) replaces the grid predicate, as in `tb_time_tile`.

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


@dataclasses.dataclass(frozen=True)
class _CudaKernel:
    source: str                 # csrc/<source>.cu
    scratch_windows: int        # window buffers per tile in its scratch
    weights: Callable[[int], np.ndarray]   # order -> one axis' FD weights
    deriv: int                  # derivative order of those weights


# physics name -> its hand-written kernel; all share one C entry point
_KERNELS = {
    "acoustic": _CudaKernel("stencil_tb", 2, st.second_derivative_weights,
                            2),
    "tti": _CudaKernel("stencil_tb_tti", 7, st.first_derivative_weights, 1),
    "elastic": _CudaKernel(
        "stencil_tb_elastic", 9,
        lambda order: st.staggered_first_derivative_weights(order)[1], 1),
}


def _bind(source: str):
    from repro_torch.kernels import _build
    lib = _build.load(source)
    if lib.repro_tb_tile.argtypes is None:
        p, i = ctypes.c_void_p, ctypes.c_int
        entries = [lib.repro_tb_tile]
        if source == _KERNELS["acoustic"].source:
            entries.append(lib.repro_tb_tile_bf16)
        for fn in entries:
            fn.argtypes = ([i] + [p] * 9 + [i] * 12 + [p]
                           + [ctypes.c_float] * 2 + [p])
            fn.restype = i
        lib.repro_cuda_error_string.argtypes = [i]
        lib.repro_cuda_error_string.restype = ctypes.c_char_p
        if lib.repro_max_radius() != _MAX_RADIUS:
            raise RuntimeError(f"csrc/{source}.cu MAX_RADIUS disagrees with "
                               "the wrapper")
    return lib


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
                       r_w, dom):
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
    if dtype == torch.bfloat16:
        # B1a-bf16 is the single-device and shot-batched acoustic tile
        if physics.name != "acoustic":
            raise TypeError(f"{physics.name}: the bfloat16 TB kernel is "
                            "acoustic only (B1a-bf16); the TTI and elastic "
                            "kernels take float32")
        if dom is not None:
            raise TypeError("the sharded path's kernel (B1c, with dom) "
                            "takes float32, not bfloat16")
    elif dtype != f32:
        raise TypeError(f"spec.dtype {dtype}: the TB kernels take float32 "
                        "(and bfloat16 for acoustic)")
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

    outs = tuple(torch.empty((B, spec.nx, spec.ny, spec.nz), dtype=dtype,
                             device=dev) for _ in physics.state_fields)
    rec = torch.zeros((B, ntx, nty, spec.T, capr, chan), dtype=dtype,
                      device=dev)
    scratch = torch.empty((B, ntiles, kern.scratch_windows, wx * wy * nz),
                          dtype=dtype, device=dev)
    lib = _bind(kern.source)
    entry = lib.repro_tb_tile if dtype == f32 else lib.repro_tb_tile_bf16
    ptr = lambda t: ctypes.c_void_p(t.data_ptr())  # noqa: E731
    stream = torch.cuda.current_stream(dev).cuda_stream
    rc = entry(
        dev.index if dev.index is not None else torch.cuda.current_device(),
        _ptrs(fields), ptr(s_coords), ptr(s_vals), ptr(r_coords), ptr(r_w),
        _ptrs(outs), ptr(rec), ptr(scratch),
        ctypes.c_void_p(dom.data_ptr() if dom is not None else None),
        int(param_rows), B,
        spec.nx, spec.ny, spec.nz, spec.tile[0], spec.tile[1], spec.T, h,
        cap, capr, r, (ctypes.c_float * len(coefs))(*coefs), dt, dt2,
        ctypes.c_void_p(stream))
    if rc != 0:
        raise RuntimeError(f"{kern.source} CUDA launch failed: "
                           + lib.repro_cuda_error_string(rc).decode())
    global launches
    launches += 1
    return outs, rec


def launch_bytes(spec: TBKernelSpec, physics: phys.TBPhysics) -> int:
    """Device bytes one shot of a CUDA launch allocates: its output fields,
    its receiver partials and its per-tile window scratch."""
    ntx, nty = spec.ntiles
    wx, wy, nz = spec.window
    elems = (len(physics.state_fields) * spec.nx * spec.ny * spec.nz
             + ntx * nty * spec.T * spec.rec_cap * physics.rec_channels
             + ntx * nty * _KERNELS[physics.name].scratch_windows
             * wx * wy * nz)
    return elems * spec.dtype.itemsize


def tb_time_tile(spec: TBKernelSpec, physics: phys.TBPhysics,
                 state_pads, param_pads, src_coords, src_vals, rec_coords,
                 rec_w, dom=None):
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
    Returns (new_states tuple, rec_partials) with fields (B, nx, ny, nz)
    and rec_partials (B, ntx, nty, T, capr, rec_channels).

    CPU tensors run `tb_time_tile_plain`; CUDA tensors launch the physics'
    kernel once for all B shots (contiguous; float32, or bfloat16 for
    acoustic without `dom`) or raise.  The launch
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
                                  dom)
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
