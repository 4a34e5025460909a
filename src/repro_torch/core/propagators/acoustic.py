"""Isotropic acoustic wave propagator (paper §III.A), port of
`repro.core.propagators.acoustic`.

    m(x) u_tt + damp u_t - lap(u) = q(t, x_s)

2nd-order in time, arbitrary even space order, absorbing sponge:

    u+ = [ dt^2 lap(u) + m (2u - u-) + damp dt u ] / (m + damp dt)

followed by grid-aligned source injection  u+ += (dt^2 / m) * q  and receiver
interpolation d(t) = u+[x_r] — the paper's Listing-1 semantics.  `propagate`
is a Python loop over t (the reference's `lax.scan`).
"""
from __future__ import annotations

import math
from typing import NamedTuple, Optional, Tuple

import numpy as np
import torch

from repro_torch._device import resolve_device
from repro_torch.core import sources as src_mod
from repro_torch.core import stencil as st
from repro_torch.core.grid import Grid


class AcousticParams(NamedTuple):
    """Physical fields on the padded grid."""

    m: torch.Tensor      # squared slowness 1/c^2
    damp: torch.Tensor   # absorbing sponge coefficient


class AcousticState(NamedTuple):
    u: torch.Tensor       # u[t]
    u_prev: torch.Tensor  # u[t-1]


def init_state(shape: Tuple[int, ...], dtype=torch.float32,
               device="cuda") -> AcousticState:
    """Zero fields on `device` (default ``"cuda"``, which raises without a
    card; pass ``"cpu"`` to build them on the CPU)."""
    dev = resolve_device(device)
    return AcousticState(*(torch.zeros(shape, dtype=dtype, device=dev)
                           for _ in range(2)))


def update_terms(u: torch.Tensor, u_prev: torch.Tensor, m: torch.Tensor,
                 damp: torch.Tensor, dt: float, spacing: Tuple[float, ...],
                 order: int) -> torch.Tensor:
    """The update formula in the reference's operation order, with `dt`
    rounded to the field dtype as ``jnp.asarray(dt, u.dtype)`` does."""
    lap = st.laplacian(u, spacing, order)
    dt = st.round_to(dt, u.dtype)
    dt2 = st.round_to(dt * dt, u.dtype)
    num = dt2 * lap + m * (2.0 * u - u_prev) + damp * dt * u
    return num / (m + damp * dt)


def stencil_update(state: AcousticState, params: AcousticParams, dt: float,
                   spacing: Tuple[float, ...], order: int) -> torch.Tensor:
    """One PDE stencil update (the `A(t, x, y, z)` of Listing 1)."""
    return update_terms(state.u, state.u_prev, params.m, params.damp, dt,
                        spacing, order)


def divide_scalar(c: float, t: torch.Tensor) -> torch.Tensor:
    """c / t as a true division (``float / tensor`` in torch multiplies by
    the reciprocal, which is not the reference's division)."""
    return torch.full_like(t, c) / t


def injection_scale(m: torch.Tensor, g: src_mod.GriddedSources,
                    dt: float) -> torch.Tensor:
    """dt^2 / m at the affected points, with dt^2 rounded to m's dtype
    first (the reference divides a weakly typed scalar by the array)."""
    return divide_scalar(st.round_to(dt * dt, m.dtype),
                         src_mod.point_scale(m, g))


def step(state: AcousticState, t: int, params: AcousticParams,
         g: Optional[src_mod.GriddedSources], dt: float,
         spacing: Tuple[float, ...], order: int,
         inject_fn=None) -> AcousticState:
    """Stencil update + grid-aligned injection for timestep `t`.

    `inject_fn(u_next, t)` defaults to the scatter form (`sources.inject`);
    the z-compressed form (`sources.inject_zcompressed`) is a drop-in
    equivalent (tested).
    """
    u_next = stencil_update(state, params, dt, spacing, order)
    if g is not None:
        if inject_fn is None:
            scale = injection_scale(params.m, g, dt)
            u_next = src_mod.inject(u_next, g, t, scale=scale)
        else:
            u_next = inject_fn(u_next, t)
    return AcousticState(u=u_next, u_prev=state.u)


def propagate(nt: int, state: AcousticState, params: AcousticParams,
              g: Optional[src_mod.GriddedSources], dt: float, grid: Grid,
              order: int,
              receivers: Optional[src_mod.GriddedReceivers] = None,
              inject_fn=None):
    """Listing-1 reference driver: loop over timesteps, interpolate receivers.

    Returns (final_state, rec) with rec (nt, nrec) or None.
    """
    recs = []
    for t in range(nt):
        state = step(state, t, params, g, dt, grid.spacing, order,
                     inject_fn=inject_fn)
        if receivers is not None:
            recs.append(src_mod.interpolate(state.u, receivers))
    if receivers is None:
        return state, None
    if not recs:
        return state, torch.zeros((0, receivers.num), dtype=state.u.dtype,
                                  device=state.u.device)
    return state, torch.stack(recs)


def max_velocity(params: AcousticParams) -> float:
    """sqrt(1 / min m), in m's dtype as the reference computes it."""
    return float(np.sqrt(1.0 / params.m.min().cpu().numpy()))


def model_flops_per_step(shape: Tuple[int, ...], order: int) -> int:
    """FLOPs of one acoustic timestep as the reference counts them: the
    Laplacian plus 9 for the update formula."""
    return math.prod(shape) * (st.stencil_flops_per_point(order, len(shape))
                               + 9)


def hbm_bytes_per_step(shape: Tuple[int, ...], dtype_bytes: int = 4) -> int:
    """Minimum device-memory traffic per step without temporal blocking:
    read u, u_prev, m, damp; write u+ (5 fields)."""
    return math.prod(shape) * dtype_bytes * 5
