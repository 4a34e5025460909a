"""Per-physics step specs for the temporally-blocked kernel (port of
`repro.kernels.tb_physics`; acoustic only so far — TTI and elastic are
the next slice of the port).

The schedule (window, T in-window steps, fused injection, receiver
partials, centre write-back) is physics-agnostic; a :class:`TBPhysics`
value carries what is physics-specific.  `update` works on window-shaped
tensors and calls the same update formula as the Listing-1 propagator in
`core/propagators/`.
"""
from __future__ import annotations

import dataclasses
from typing import Callable, Dict, Tuple

import numpy as np

from repro_torch.core import sources as src_mod
from repro_torch.core import stencil as st
from repro_torch.core.propagators import acoustic as ac


@dataclasses.dataclass(frozen=True)
class TBPhysics:
    """Everything the generic TB driver needs to advance one physics."""

    name: str
    state_fields: Tuple[str, ...]
    param_fields: Tuple[str, ...]
    # state fields computed each step (the rest are carried copies)
    evolved_fields: Tuple[str, ...]
    inject_fields: Tuple[str, ...]
    rec_channels: int
    radius_mult: int
    # update(state, params, spec) -> new state (same keys)
    update: Callable[[Dict, Dict, object], Dict]
    # record(state) -> rec_channels window-shaped tensors
    record: Callable[[Dict], Tuple]
    # inject_scale(params, g, dt) -> (npts,) per-point injection factor
    inject_scale: Callable[[Dict, src_mod.GriddedSources, float], np.ndarray]

    @property
    def num_windows(self) -> int:
        return len(self.state_fields) + len(self.param_fields)

    def step_radius(self, order: int) -> int:
        """Per-in-window-step halo consumption (grid points per side)."""
        return self.radius_mult * (order // 2)


def _acoustic_update(state, params, spec):
    u = state["u"]
    u_next = ac.update_terms(u, state["u_prev"], params["m"], params["damp"],
                             spec.dt, spec.spacing, spec.order)
    return {"u": u_next, "u_prev": u}


def _acoustic_scale(params, g, dt):
    # dt**2 / m at the affected points, in m's dtype, handed to the host
    # table build as float32 numpy (as the reference's eager build does)
    m_pts = src_mod.point_scale(params["m"], g)
    return src_mod.to_numpy(
        ac.divide_scalar(st.round_to(dt ** 2, m_pts.dtype), m_pts).float())


ACOUSTIC = TBPhysics(
    name="acoustic",
    state_fields=("u_prev", "u"),
    param_fields=("m", "damp"),
    evolved_fields=("u",),
    inject_fields=("u",),
    rec_channels=1,
    radius_mult=1,
    update=_acoustic_update,
    record=lambda s: (s["u"],),
    inject_scale=_acoustic_scale,
)
