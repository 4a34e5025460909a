"""Temporally-blocked time tile: the hand-written CUDA kernel for Hopper and
its plain PyTorch version (port of `repro.kernels.stencil_tb`).

One call advances the whole grid by one depth-T time tile on a grid of
(ntx, nty) spatial tiles.  Each tile takes a ``(tx + 2H, ty + 2H, nz)``
window of every state and param field (H = T * step_radius), runs T steps
of the physics update with the x/y domain mask, adds the per-tile source
values at window-local points, records ``rec_w``-weighted receiver
samples, and writes back only its centre.

`tb_time_tile` dispatches on where its tensors lie: CPU tensors run
`tb_time_tile_plain`; CUDA tensors launch the kernel of
``csrc/stencil_tb.cu`` (acoustic, float32) or raise.  `launches` counts
kernel launches, so a run can show it went through the kernel.
"""
from __future__ import annotations

import ctypes
import dataclasses
from typing import Optional, Tuple

import torch

from repro_torch.core import stencil as st
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
    update / mask / inject / record sequence as the kernel.  `sspec`
    exposes `dt`/`spacing`/`order`; `dom` broadcasts against the window.

    Returns (cropped centre tuple, rec partials (T, capr, rec_channels)).
    """
    state = dict(zip(physics.state_fields, state_pads))
    params = dict(zip(physics.param_fields, param_pads))
    sidx = tuple(s_coords.long().T)
    ridx = tuple(r_coords.long().T)
    recs = []
    for k in range(T):
        new = physics.update(state, params, sspec)
        for f in physics.evolved_fields:
            new[f] = new[f] * dom
        # fused grid-aligned injection (paper Listing 4); padding slots
        # carry val = 0 and add harmlessly onto window point (0, 0, 0)
        for f in physics.inject_fields:
            new[f] = new[f].index_put(sidx, s_vals[k].to(new[f].dtype),
                                      accumulate=True)
        recs.append(torch.stack(
            [(arr[ridx] * r_w).to(arr.dtype) for arr in physics.record(new)],
            dim=-1))
        state = new
    wx, wy = state_pads[0].shape[0], state_pads[0].shape[1]
    crop = (slice(h, wx - h), slice(h, wy - h), slice(None))
    return (tuple(state[f][crop] for f in physics.state_fields),
            torch.stack(recs, dim=0))


def tb_time_tile_plain(spec: TBKernelSpec, physics: phys.TBPhysics,
                       state_pads, param_pads, s_coords, s_vals, r_coords,
                       r_w):
    """Plain PyTorch version of `tb_time_tile`: the same per-window
    trapezoid, looped over the (ti, tj) tiles.  Runs on any device.

    Returns (state tuple (nx, ny, nz), rec partials
    (ntx, nty, T, capr, chan))."""
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
            gx = torch.arange(ti * tx - h, (ti + 1) * tx + h, device=dev)
            gy = torch.arange(tj * ty - h, (tj + 1) * ty + h, device=dev)
            dom = (((gx >= 0) & (gx < spec.nx))[:, None, None]
                   & ((gy >= 0) & (gy < spec.ny))[None, :, None])
            out_w, rec = window_tile_plain(
                physics, spec, spec.T, h,
                tuple(p[slx, sly] for p in state_pads),
                tuple(p[slx, sly] for p in param_pads),
                dom.to(spec.dtype), s_coords[k], s_vals[k], r_coords[k],
                r_w[k])
            for i, centre in enumerate(out_w):
                outs[i][ti * tx:(ti + 1) * tx, tj * ty:(tj + 1) * ty] = centre
            row.append(rec)
        rec_rows.append(torch.stack(row, dim=0))
    return tuple(outs), torch.stack(rec_rows, dim=0)


# ---------------------------------------------------------------------------
# CUDA kernel wrapper
# ---------------------------------------------------------------------------

_MAX_RADIUS = 8         # MAX_RADIUS in csrc/stencil_tb.cu


def _bind():
    from repro_torch.kernels import _build
    lib = _build.load("stencil_tb")
    fn = lib.repro_tb_acoustic_tile
    if fn.argtypes is None:
        p, i = ctypes.c_void_p, ctypes.c_int
        fn.argtypes = ([i] + [p] * 12 + [i] * 10 + [p]
                       + [ctypes.c_float] * 2 + [p])
        fn.restype = i
        lib.repro_cuda_error_string.argtypes = [i]
        lib.repro_cuda_error_string.restype = ctypes.c_char_p
        if lib.repro_max_radius() != _MAX_RADIUS:
            raise RuntimeError("csrc/stencil_tb.cu MAX_RADIUS disagrees "
                               "with the wrapper")
    return lib


def _dtype_error(name, got, want) -> TypeError:
    if got == torch.bfloat16:
        return TypeError(f"{name}: bfloat16 has no CUDA TB kernel yet "
                         "(ROADMAP B1a-bf16); use float32")
    return TypeError(f"{name} has dtype {got}, expected {want}")


def _check(name, t, shape, dtype, dev):
    if t.device != dev:
        raise ValueError(f"{name} is on {t.device}, expected {dev}")
    if t.dtype != dtype:
        raise _dtype_error(name, t.dtype, dtype)
    if tuple(t.shape) != tuple(shape):
        raise ValueError(f"{name} has shape {tuple(t.shape)}, expected "
                         f"{tuple(shape)}")
    if not t.is_contiguous():
        raise ValueError(f"{name} must be contiguous")


def _tb_time_tile_cuda(spec: TBKernelSpec, physics: phys.TBPhysics,
                       state_pads, param_pads, s_coords, s_vals, r_coords,
                       r_w):
    if physics.name != "acoustic":
        raise NotImplementedError(
            f"no CUDA TB kernel for {physics.name!r} yet (ROADMAP B1b)")
    dev = state_pads[0].device
    f32 = torch.float32
    h = spec.halo
    ntx, nty = spec.ntiles
    ntiles = ntx * nty
    wx, wy, nz = spec.window
    if spec.dtype != f32:
        raise _dtype_error("spec.dtype", spec.dtype, f32)
    pad_shape = (spec.nx + 2 * h, spec.ny + 2 * h, spec.nz)
    for name, t in zip(("u_prev", "u", "m", "damp"),
                       (*state_pads, *param_pads)):
        _check(name, t, pad_shape, f32, dev)
    cap, capr = s_coords.shape[1], r_coords.shape[1]
    _check("src_coords", s_coords, (ntiles, cap, 3), torch.int32, dev)
    _check("src_vals", s_vals, (ntiles, spec.T, cap), f32, dev)
    _check("rec_coords", r_coords, (ntiles, capr, 3), torch.int32, dev)
    _check("rec_w", r_w, (ntiles, capr), f32, dev)
    if wx * wy * nz >= 2 ** 31:
        raise ValueError(f"window {spec.window} too large for the kernel")

    r = spec.radius
    if not 1 <= r <= _MAX_RADIUS:
        raise ValueError(f"order {spec.order}: the kernel takes space orders "
                         f"2..{2 * _MAX_RADIUS}")
    # every tap, x then y then z, w * h**-2 rounded as apply_axis_stencil
    w = st.second_derivative_weights(spec.order)
    coefs = (ctypes.c_float * (3 * (2 * r + 1)))(
        *(st.round_to(wk * float(hh) ** -2, f32)
          for hh in spec.spacing for wk in w))
    dt = st.round_to(spec.dt, f32)
    dt2 = st.round_to(dt * dt, f32)

    out0 = torch.empty((spec.nx, spec.ny, spec.nz), dtype=f32, device=dev)
    out1 = torch.empty_like(out0)
    rec = torch.zeros((ntx, nty, spec.T, capr, 1), dtype=f32, device=dev)
    scratch = torch.empty((ntiles, 2, wx * wy * nz), dtype=f32, device=dev)
    lib = _bind()
    ptr = lambda t: ctypes.c_void_p(t.data_ptr())  # noqa: E731
    stream = torch.cuda.current_stream(dev).cuda_stream
    rc = lib.repro_tb_acoustic_tile(
        dev.index if dev.index is not None else torch.cuda.current_device(),
        ptr(state_pads[0]), ptr(state_pads[1]), ptr(param_pads[0]),
        ptr(param_pads[1]), ptr(s_coords), ptr(s_vals), ptr(r_coords),
        ptr(r_w), ptr(out0), ptr(out1), ptr(rec), ptr(scratch),
        spec.nx, spec.ny, spec.nz, spec.tile[0], spec.tile[1], spec.T, h,
        cap, capr, r, coefs, dt, dt2, ctypes.c_void_p(stream))
    if rc != 0:
        raise RuntimeError("stencil_tb CUDA launch failed: "
                           + lib.repro_cuda_error_string(rc).decode())
    global launches
    launches += 1
    return (out0, out1), rec


def tb_time_tile(spec: TBKernelSpec, physics: phys.TBPhysics,
                 state_pads, param_pads, src_coords, src_vals, rec_coords,
                 rec_w):
    """One depth-T time tile over the whole grid.

    Args:
      state_pads: one (nx + 2H, ny + 2H, nz) tensor per
                  physics.state_fields (zero-padded).
      param_pads: one padded tensor per physics.param_fields (edge-padded).
      src_coords: (ntiles, cap, 3) window-local int32.
      src_vals:   (ntiles, T, cap), scale folded in, 0 on padding.
      rec_coords: (ntiles, capr, 3) int32; rec_w: (ntiles, capr).
    Returns (new_states tuple, rec_partials) with fields (nx, ny, nz) and
    rec_partials (ntx, nty, T, capr, rec_channels).

    CPU tensors run `tb_time_tile_plain`; CUDA tensors launch the kernel
    (acoustic, float32, contiguous) or raise.  The launch goes on the
    current stream and does not synchronise.
    """
    dev = state_pads[0].device
    if dev.type == "cpu":
        return tb_time_tile_plain(spec, physics, state_pads, param_pads,
                                  src_coords, src_vals, rec_coords, rec_w)
    if dev.type == "cuda":
        return _tb_time_tile_cuda(spec, physics, state_pads, param_pads,
                                  src_coords, src_vals, rec_coords, rec_w)
    raise ValueError(f"no TB time tile for device {dev}")


def kernel_cost(spec: TBKernelSpec,
                physics: phys.TBPhysics = phys.ACOUSTIC) -> dict:
    """Analytic per-call cost of one time tile.

    ``flops``/``hbm_bytes`` price the kernel's schedule (every window
    computed in full, each field's window read once per call, as the
    reference prices it); ``useful_flops`` is the stencil work on the grid;
    ``min_bytes`` the least traffic of the function (each unpadded input
    field read once, each output field written once) — the numerator of
    the roofline bound.
    """
    if physics.name != "acoustic":
        raise NotImplementedError(f"no cost model for {physics.name!r} yet")
    ntx, nty = spec.ntiles
    wx, wy, wz = spec.window
    stencil_flops = st.stencil_flops_per_point(spec.order, 3) + 9
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
    return {"flops": float(flops),
            "hbm_bytes": float(hbm_read + hbm_write),
            "useful_flops": float(grid_pts * spec.T * stencil_flops),
            "min_bytes": float(grid_pts * (nw + ns) * itemsize),
            "window_bytes": spec.window_bytes(nw)}
