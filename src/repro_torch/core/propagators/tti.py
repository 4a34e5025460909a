"""Anisotropic acoustic (TTI) pseudo-acoustic propagator (paper §III.B),
port of `repro.core.propagators.tti`.

Coupled system of two scalar PDEs (p, r) with a rotated anisotropic
Laplacian parametrized by the tilt theta and azimuth phi and the Thomsen
parameters epsilon, delta:

    m p_tt + damp p_t = (1 + 2 eps) H0(p) + sqrt(1 + 2 dlt) Hz(r) + q
    m r_tt + damp r_t = sqrt(1 + 2 dlt) H0(p) +             Hz(r) + q

with the rotated second-derivative operators built from rotated first
derivatives (paper Eq. 2):

    Dx~ = cos(th)cos(ph) dx + cos(th)sin(ph) dy - sin(th) dz
    Dy~ = -sin(ph) dx + cos(ph) dy
    Dz~ = sin(th)cos(ph) dx + sin(th)sin(ph) dy + cos(th) dz
    Gxx = Dx~(Dx~ .), Gyy = Dy~(Dy~ .), Gzz = Dz~(Dz~ .)
    H0 = Gxx + Gyy,  Hz = Gzz

Terms are summed in the reference's order.  `propagate` is a Python loop
over t (the reference's `lax.scan`).
"""
from __future__ import annotations

from typing import NamedTuple, Optional, Tuple

import numpy as np
import torch

from repro_torch._device import resolve_device
from repro_torch.core import sources as src_mod
from repro_torch.core import stencil as st
from repro_torch.core.grid import Grid
from repro_torch.core.propagators.acoustic import injection_scale


class TTIParams(NamedTuple):
    m: torch.Tensor        # squared slowness
    damp: torch.Tensor
    epsilon: torch.Tensor  # Thomsen epsilon
    delta: torch.Tensor    # Thomsen delta
    theta: torch.Tensor    # tilt
    phi: torch.Tensor      # azimuth


class TTIState(NamedTuple):
    p: torch.Tensor
    p_prev: torch.Tensor
    r: torch.Tensor
    r_prev: torch.Tensor


def init_state(shape: Tuple[int, ...], dtype=torch.float32,
               device="cuda") -> TTIState:
    """Zero fields on `device` (default ``"cuda"``, which raises without a
    card; pass ``"cpu"`` to build them on the CPU)."""
    dev = resolve_device(device)
    return TTIState(*(torch.zeros(shape, dtype=dtype, device=dev)
                      for _ in range(4)))


def _rotated_dirs(params: TTIParams):
    ct, sth = torch.cos(params.theta), torch.sin(params.theta)
    cp, sph = torch.cos(params.phi), torch.sin(params.phi)
    dx_w = (ct * cp, ct * sph, -sth)     # Dx~ direction cosines
    dy_w = (-sph, cp, torch.zeros_like(cp))
    dz_w = (sth * cp, sth * sph, ct)
    return dx_w, dy_w, dz_w


def _combine(w3, derivs):
    """sum over axes of w * d, in axis order."""
    out = None
    for wd, d in zip(w3, derivs):
        term = wd * d
        out = term if out is None else out + term
    return out


def _dir_derivative(u, w3, spacing, order):
    return _combine(w3, (st.first_derivative(u, ax, h, order)
                         for ax, h in enumerate(spacing)))


def _second_derivatives(u, dirs, spacing, order, mask_fn=None):
    """The rotated second derivatives of `u` along each direction of
    `dirs`: the outer directional derivative of the (masked) inner one.
    The inner pass's three axis derivatives of `u` serve every direction
    (the reference computes them once a direction: the same values)."""
    mask = (lambda a: a) if mask_fn is None else mask_fn
    du = [st.first_derivative(u, ax, h, order)
          for ax, h in enumerate(spacing)]
    return [_dir_derivative(mask(_combine(w, du)), w, spacing, order)
            for w in dirs]


def rotated_laplacians(u: torch.Tensor, params: TTIParams,
                       spacing: Tuple[float, ...], order: int,
                       mask_fn=None):
    """(H0, Hz)(u) — the rotated horizontal/vertical Laplacians.

    `mask_fn` (optional) is applied to the inner first-derivative pass
    before the outer pass reads it: the TB driver passes a domain mask that
    re-zeroes the inner field on a window's out-of-domain rim.
    """
    gxx, gyy, gzz = _second_derivatives(u, _rotated_dirs(params), spacing,
                                        order, mask_fn)
    return gxx + gyy, gzz


def stencil_update(state: TTIState, params: TTIParams, dt: float,
                   spacing: Tuple[float, ...], order: int,
                   mask_fn=None):
    """(p_next, r_next) before injection, `dt` rounded to the field dtype
    as ``jnp.asarray(dt, p.dtype)`` does."""
    p, p_prev, r, r_prev = state
    dt = st.round_to(dt, p.dtype)
    dt2 = st.round_to(dt * dt, p.dtype)
    # the update reads H0(p) and Hz(r) only: Hz(p) and H0(r), which the
    # reference's compiler drops unread, are not computed
    dx_w, dy_w, dz_w = _rotated_dirs(params)
    gxx, gyy = _second_derivatives(p, (dx_w, dy_w), spacing, order,
                                   mask_fn)
    h0_p = gxx + gyy
    hz_r, = _second_derivatives(r, (dz_w,), spacing, order, mask_fn)
    e_fac = 1.0 + 2.0 * params.epsilon
    d_fac = torch.sqrt(1.0 + 2.0 * params.delta)
    den = params.m + params.damp * dt

    rhs_p = e_fac * h0_p + d_fac * hz_r
    rhs_r = d_fac * h0_p + hz_r
    p_next = (dt2 * rhs_p + params.m * (2.0 * p - p_prev)
              + params.damp * dt * p) / den
    r_next = (dt2 * rhs_r + params.m * (2.0 * r - r_prev)
              + params.damp * dt * r) / den
    return p_next, r_next


def step(state: TTIState, t: int, params: TTIParams,
         g: Optional[src_mod.GriddedSources], dt: float,
         spacing: Tuple[float, ...], order: int) -> TTIState:
    p_next, r_next = stencil_update(state, params, dt, spacing, order)
    if g is not None:
        scale = injection_scale(params.m, g, dt)
        p_next = src_mod.inject(p_next, g, t, scale=scale)
        r_next = src_mod.inject(r_next, g, t, scale=scale)
    return TTIState(p_next, state.p, r_next, state.r)


def propagate(nt: int, state: TTIState, params: TTIParams,
              g: Optional[src_mod.GriddedSources], dt: float, grid: Grid,
              order: int,
              receivers: Optional[src_mod.GriddedReceivers] = None):
    """Listing-1 driver.  Returns (final TTIState, rec (nt, nrec) | None),
    the receivers sampling p."""
    recs = []
    for t in range(nt):
        state = step(state, t, params, g, dt, grid.spacing, order)
        if receivers is not None:
            recs.append(src_mod.interpolate(state.p, receivers))
    if receivers is None:
        return state, None
    if not recs:
        return state, torch.zeros((0, receivers.num), dtype=state.p.dtype,
                                  device=state.p.device)
    return state, torch.stack(recs)


_POINTWISE_FLOPS = 40


def _flops_per_g(order: int) -> int:
    """One rotated second derivative (Gxx, Gyy or Gzz): 2 passes x 3
    dir-derivs x (stencil + 2 muladd for direction weights)."""
    taps = order + 1
    d1 = 2 * taps - 1                       # one first-derivative stencil
    return 2 * 3 * (d1 + 4)


def model_flops_per_step(shape: Tuple[int, ...], order: int) -> int:
    """The reference's count: per field, the 3 rotated second derivatives
    of `rotated_laplacians`; 2 fields + pointwise."""
    per_field = 3 * _flops_per_g(order)
    return int(np.prod(shape)) * (2 * per_field + _POINTWISE_FLOPS)


def needed_flops_per_step(shape: Tuple[int, ...], order: int) -> int:
    """The operations the update's output needs: Gxx(p), Gyy(p), Gzz(r)
    and the pointwise terms.  `model_flops_per_step` also prices Gzz(p) and
    Gxx(r) + Gyy(r), which the reference's `stencil_update` computes and
    its compiler drops (this port's does not compute them)."""
    return int(np.prod(shape)) * (3 * _flops_per_g(order) + _POINTWISE_FLOPS)
