"""Isotropic elastic velocity-stress propagator (paper §III.C), port of
`repro.core.propagators.elastic`.

First-order-in-time coupled system on a staggered grid (Virieux 1986):

    rho v_t = div(tau)
    tau_t   = lam tr(grad v) I + mu (grad v + grad v^T)

Nine state fields in 3-D (3 velocities + 6 stresses).  Staggering (bits =
half-cell offsets per axis):
    txx/tyy/tzz: (0,0,0);  vx: (1,0,0); vy: (0,1,0); vz: (0,0,1);
    txy: (1,1,0); txz: (1,0,1); tyz: (0,1,1).
A d/d(axis) application is forward when the operand's bit on that axis is
0 and backward when it is 1.  `propagate` is a Python loop over t.
"""
from __future__ import annotations

from typing import NamedTuple, Optional, Tuple

import numpy as np
import torch

from repro_torch._device import resolve_device
from repro_torch.core import sources as src_mod
from repro_torch.core import stencil as st
from repro_torch.core.grid import Grid
from repro_torch.core.propagators.acoustic import divide_scalar


class ElasticParams(NamedTuple):
    lam: torch.Tensor   # Lame lambda
    mu: torch.Tensor    # Lame mu
    b: torch.Tensor     # buoyancy 1/rho
    damp: torch.Tensor


class ElasticState(NamedTuple):
    vx: torch.Tensor
    vy: torch.Tensor
    vz: torch.Tensor
    txx: torch.Tensor
    tyy: torch.Tensor
    tzz: torch.Tensor
    txy: torch.Tensor
    txz: torch.Tensor
    tyz: torch.Tensor


def init_state(shape: Tuple[int, ...], dtype=torch.float32,
               device="cuda") -> ElasticState:
    """Zero fields on `device` (default ``"cuda"``, which raises without a
    card; pass ``"cpu"`` to build them on the CPU)."""
    dev = resolve_device(device)
    return ElasticState(*(torch.zeros(shape, dtype=dtype, device=dev)
                          for _ in range(9)))


def _d(u, axis, h, order, operand_bit):
    """Staggered derivative; forward if the operand sits on integers."""
    shift = +1 if operand_bit == 0 else -1
    return st.staggered_derivative(u, axis, h, order, shift)


def stencil_update(state: ElasticState, params: ElasticParams, dt: float,
                   spacing: Tuple[float, ...], order: int,
                   mask_fn=None) -> ElasticState:
    """One velocity-stress leapfrog step.

    `mask_fn` (optional) is applied to the new velocities before the
    stress update reads them: the TB driver passes a domain mask that
    re-zeroes a window's out-of-domain rim.
    """
    hx, hy, hz = spacing
    dt = st.round_to(dt, state.vx.dtype)
    dmp = divide_scalar(1.0, 1.0 + params.damp * dt)

    # velocity update: rho v_t = div(tau)
    vx = dmp * (state.vx + dt * params.b * (
        _d(state.txx, 0, hx, order, 0) + _d(state.txy, 1, hy, order, 1)
        + _d(state.txz, 2, hz, order, 1)))
    vy = dmp * (state.vy + dt * params.b * (
        _d(state.txy, 0, hx, order, 1) + _d(state.tyy, 1, hy, order, 0)
        + _d(state.tyz, 2, hz, order, 1)))
    vz = dmp * (state.vz + dt * params.b * (
        _d(state.txz, 0, hx, order, 1) + _d(state.tyz, 1, hy, order, 1)
        + _d(state.tzz, 2, hz, order, 0)))

    if mask_fn is not None:
        vx, vy, vz = mask_fn(vx), mask_fn(vy), mask_fn(vz)

    # stress update (leapfrog: uses the new velocities)
    dvx_dx = _d(vx, 0, hx, order, 1)
    dvy_dy = _d(vy, 1, hy, order, 1)
    dvz_dz = _d(vz, 2, hz, order, 1)
    div_v = dvx_dx + dvy_dy + dvz_dz
    lam, mu = params.lam, params.mu
    txx = dmp * (state.txx + dt * (lam * div_v + 2.0 * mu * dvx_dx))
    tyy = dmp * (state.tyy + dt * (lam * div_v + 2.0 * mu * dvy_dy))
    tzz = dmp * (state.tzz + dt * (lam * div_v + 2.0 * mu * dvz_dz))
    txy = dmp * (state.txy + dt * mu * (_d(vx, 1, hy, order, 0)
                                        + _d(vy, 0, hx, order, 0)))
    txz = dmp * (state.txz + dt * mu * (_d(vx, 2, hz, order, 0)
                                        + _d(vz, 0, hx, order, 0)))
    tyz = dmp * (state.tyz + dt * mu * (_d(vy, 2, hz, order, 0)
                                        + _d(vz, 1, hy, order, 0)))
    return ElasticState(vx, vy, vz, txx, tyy, tzz, txy, txz, tyz)


def pressure(txx, tyy, tzz) -> torch.Tensor:
    """The pressure proxy -(txx + tyy + tzz) / 3 the receivers record."""
    return -(txx + tyy + tzz) / 3.0


def step(state: ElasticState, t: int, params: ElasticParams,
         g: Optional[src_mod.GriddedSources], dt: float,
         spacing: Tuple[float, ...], order: int) -> ElasticState:
    nxt = stencil_update(state, params, dt, spacing, order)
    if g is not None:
        # explosive source: the wavelet times dt into the diagonal stresses
        scale = torch.full((g.npts,), st.round_to(dt, nxt.txx.dtype),
                           dtype=nxt.txx.dtype, device=nxt.txx.device)
        nxt = nxt._replace(txx=src_mod.inject(nxt.txx, g, t, scale=scale),
                           tyy=src_mod.inject(nxt.tyy, g, t, scale=scale),
                           tzz=src_mod.inject(nxt.tzz, g, t, scale=scale))
    return nxt


def propagate(nt: int, state: ElasticState, params: ElasticParams,
              g: Optional[src_mod.GriddedSources], dt: float, grid: Grid,
              order: int,
              receivers: Optional[src_mod.GriddedReceivers] = None):
    """Listing-1 driver.  Receivers record particle velocity vz and the
    pressure proxy -(txx+tyy+tzz)/3, stacked on the last axis: returns
    (final ElasticState, rec (nt, nrec, 2) | None)."""
    recs = []
    for t in range(nt):
        state = step(state, t, params, g, dt, grid.spacing, order)
        if receivers is not None:
            pr = pressure(state.txx, state.tyy, state.tzz)
            recs.append(torch.stack(
                [src_mod.interpolate(state.vz, receivers),
                 src_mod.interpolate(pr, receivers)], dim=-1))
    if receivers is None:
        return state, None
    if not recs:
        return state, torch.zeros((0, receivers.num, 2),
                                  dtype=state.vx.dtype,
                                  device=state.vx.device)
    return state, torch.stack(recs)


def model_flops_per_step(shape: Tuple[int, ...], order: int) -> int:
    taps = order  # staggered: `order` taps
    d1 = 2 * taps - 1
    nderiv = 9 + 6  # 9 in velocity updates (3x3), 6+3 reused in stress
    pointwise = 60
    return int(np.prod(shape)) * (nderiv * d1 + pointwise)
