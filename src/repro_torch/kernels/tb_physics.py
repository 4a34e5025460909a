"""Per-physics step specs for the temporally-blocked kernel (port of
`repro.kernels.tb_physics`: acoustic, TTI and elastic).

The schedule (window, T in-window steps, fused injection, receiver
partials, centre write-back) is physics-agnostic; a :class:`TBPhysics`
value carries what is physics-specific.  `update` works on window-shaped
tensors and calls the same update formula as the Listing-1 propagator in
`core/propagators/`, with a domain-mask hook (`mask_fn`) that re-zeroes
intermediate fields on the window's out-of-domain rim — on a tile window
the counterpart of the zero padding the reference applies at the physical
boundary.

`param_fills` and `halo_lags` serve the sharded driver
(`distributed/halo.py`): the values out-of-domain param cells take in an
exchanged halo, and how much shallower each state field's exchange may be.
"""
from __future__ import annotations

import dataclasses
from typing import Callable, Dict, Tuple

import torch

from repro_torch.core import sources as src_mod
from repro_torch.core import stencil as st
from repro_torch.core.propagators import acoustic as ac
from repro_torch.core.propagators import elastic as el
from repro_torch.core.propagators import tti as tt


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
    # update(state, params, spec, mask_fn) -> new state (same keys)
    update: Callable[[Dict, Dict, object, Callable], Dict]
    # record(state) -> rec_channels window-shaped tensors
    record: Callable[[Dict], Tuple]
    # inject_scale(params, g, dt) -> (npts,) per-point injection factor,
    # float32, on the params' device (read on the device, no host sync)
    inject_scale: Callable[[Dict, src_mod.GriddedSources, float],
                           torch.Tensor]
    # evolved fields the update already domain-masked itself (via mask_fn);
    # the driver skips its own mask for these
    premasked_fields: Tuple[str, ...] = ()
    # (field, value) pairs: what out-of-domain param cells must hold so the
    # update stays finite there (everything it computes is re-masked)
    param_fills: Tuple[Tuple[str, float], ...] = ()
    # per-state-field exchange-depth reduction in units of order // 2 for
    # the sharded deep-halo exchange: a field the update reads only
    # pointwise at the rim needs a shallower exchanged strip.  Depth per
    # field is max(T * step_radius - lag * (order // 2), 0); () means every
    # field ships the full depth.  Numeric mirror:
    # core.temporal_blocking.PHYSICS_COSTS[...].halo_lag_units
    halo_lags: Tuple[int, ...] = ()

    @property
    def num_windows(self) -> int:
        return len(self.state_fields) + len(self.param_fields)

    def step_radius(self, order: int) -> int:
        """Per-in-window-step halo consumption (grid points per side)."""
        return self.radius_mult * (order // 2)

    def field_halo_depths(self, T: int, order: int) -> Tuple[int, ...]:
        """Per-state-field exchange depth for a depth-T outer tile."""
        h = T * self.step_radius(order)
        r0 = order // 2
        lags = self.halo_lags or (0,) * len(self.state_fields)
        return tuple(max(h - lag * r0, 0) for lag in lags)


def _acoustic_update(state, params, spec, mask_fn):
    # no intermediate field: the driver's mask after the step is enough
    u = state["u"]
    u_next = ac.update_terms(u, state["u_prev"], params["m"], params["damp"],
                             spec.dt, spec.spacing, spec.order)
    return {"u": u_next, "u_prev": u}


def _acoustic_scale(params, g, dt):
    # dt**2 / m at the affected points, in m's dtype, then float32 (as the
    # reference's table build rounds it)
    m_pts = src_mod.point_scale(params["m"], g)
    return ac.divide_scalar(st.round_to(dt ** 2, m_pts.dtype), m_pts).float()


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
    param_fills=(("m", 1.0),),   # update divides by m + damp * dt
    halo_lags=(1, 0),            # u_prev is only read pointwise
)


# ---------------------------------------------------------------------------
# TTI pseudo-acoustic (paper §III.B): coupled p/r, rotated Laplacian
# ---------------------------------------------------------------------------

_TTI_PARAMS = ("m", "damp", "epsilon", "delta", "theta", "phi")


def _tti_update(state, params, spec, mask_fn):
    tst = tt.TTIState(p=state["p"], p_prev=state["p_prev"],
                      r=state["r"], r_prev=state["r_prev"])
    tpar = tt.TTIParams(**{k: params[k] for k in _TTI_PARAMS})
    p_next, r_next = tt.stencil_update(tst, tpar, spec.dt, spec.spacing,
                                       spec.order, mask_fn=mask_fn)
    return {"p": p_next, "p_prev": state["p"],
            "r": r_next, "r_prev": state["r"]}


TTI = TBPhysics(
    name="tti",
    state_fields=("p", "p_prev", "r", "r_prev"),
    param_fields=_TTI_PARAMS,
    evolved_fields=("p", "r"),
    inject_fields=("p", "r"),
    rec_channels=1,
    radius_mult=2,   # rotated Laplacian: two first-derivative passes
    update=_tti_update,
    record=lambda s: (s["p"],),
    inject_scale=_acoustic_scale,   # same dt^2/m factor as acoustic
    param_fills=(("m", 1.0),),   # update divides by m + damp * dt
    halo_lags=(0, 2, 0, 2),      # p_prev / r_prev only read pointwise
)


# ---------------------------------------------------------------------------
# Isotropic elastic (paper §III.C): 9-field velocity-stress, staggered
# ---------------------------------------------------------------------------

_EL_STATE = ("vx", "vy", "vz", "txx", "tyy", "tzz", "txy", "txz", "tyz")
_EL_PARAMS = ("lam", "mu", "b", "damp")


def _elastic_update(state, params, spec, mask_fn):
    est = el.ElasticState(**{k: state[k] for k in _EL_STATE})
    epar = el.ElasticParams(**{k: params[k] for k in _EL_PARAMS})
    nxt = el.stencil_update(est, epar, spec.dt, spec.spacing, spec.order,
                            mask_fn=mask_fn)
    return dict(zip(_EL_STATE, nxt))


def _elastic_scale(params, g, dt):
    # explosive source: wavelet * dt into the diagonal stresses
    return torch.full((g.npts,), float(dt), dtype=torch.float32,
                      device=params["b"].device)


ELASTIC = TBPhysics(
    name="elastic",
    state_fields=_EL_STATE,
    param_fields=_EL_PARAMS,
    evolved_fields=_EL_STATE,   # 1st order in time: every field is new
    inject_fields=("txx", "tyy", "tzz"),
    rec_channels=2,  # vz and the pressure proxy -(txx+tyy+tzz)/3
    radius_mult=2,   # stress update reads the new velocities
    update=_elastic_update,
    record=lambda s: (s["vz"], el.pressure(s["txx"], s["tyy"], s["tzz"])),
    inject_scale=_elastic_scale,
    premasked_fields=("vx", "vy", "vz"),  # stencil_update masks mid-step
    # v-first update order: the initial stresses feed the step-1 velocity
    # derivatives (full depth); the initial velocities are read pointwise
    # and first differentiated one half-step later, one r0 shallower
    halo_lags=(1, 1, 1, 0, 0, 0, 0, 0, 0),
)


PHYSICS = {p.name: p for p in (ACOUSTIC, TTI, ELASTIC)}
