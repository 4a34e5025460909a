"""Plain oracles for the TB kernel (port of `repro.kernels.ref`).

The wave-propagation oracle is the Listing-1 reference driver of
`repro_torch.core.propagators` — naive full-grid timestepping with
grid-aligned injection and receiver interpolation.  The temporally-blocked
path must match it to float32 tolerance for every (shape, order, T, tile).
"""
from __future__ import annotations

from typing import Optional, Tuple

from repro_torch._device import as_tensor, resolve_device
from repro_torch.core import sources as src_mod
from repro_torch.core.grid import Grid
from repro_torch.core.propagators import acoustic


def acoustic_reference(nt: int, u0, u1, m, damp, dt: float,
                       spacing: Tuple[float, ...], order: int,
                       g: Optional[src_mod.GriddedSources] = None,
                       receivers: Optional[src_mod.GriddedReceivers] = None,
                       device="cuda"):
    """Run nt acoustic steps from state (u_prev=u0, u=u1) on `device`
    (default ``"cuda"``; fields may be numpy arrays or tensors).

    Returns ((u_prev, u) after nt steps, rec (nt, nrec) or None).
    """
    dev = resolve_device(device)
    u0, u1, m, damp = (as_tensor(a, dev) for a in (u0, u1, m, damp))
    g = g.to(dev) if g is not None else None
    receivers = receivers.to(dev) if receivers is not None else None
    grid = Grid(shape=tuple(u1.shape), spacing=spacing)
    params = acoustic.AcousticParams(m=m, damp=damp)
    state = acoustic.AcousticState(u=u1, u_prev=u0)
    final, recs = acoustic.propagate(nt, state, params, g, dt, grid, order,
                                     receivers=receivers)
    return (final.u_prev, final.u), recs
