"""Plain oracles for the TB kernel (port of `repro.kernels.ref`).

The wave-propagation oracles are the Listing-1 reference drivers of
`repro_torch.core.propagators` — naive full-grid timestepping with
grid-aligned injection and receiver interpolation, one per physics
(acoustic, TTI, elastic).  The temporally-blocked path must match them to
float32 tolerance for every (shape, order, T, tile).  The SSD scan's
oracle is the naive per-step recurrence (`ssd_chunked_reference`).
"""
from __future__ import annotations

from typing import Optional, Tuple

import torch

from repro_torch._device import as_tensor, resolve_device
from repro_torch.core import sources as src_mod
from repro_torch.core.grid import Grid
from repro_torch.core.propagators import acoustic, elastic, tti


def _reference(mod, state, params, nt, dt, spacing, order, g, receivers,
               device):
    """`mod.propagate` of nt steps from `state` with `params` (NamedTuples
    whose fields may be numpy arrays or tensors) on `device`."""
    dev = resolve_device(device)
    state = type(state)(*(as_tensor(a, dev) for a in state))
    params = type(params)(*(as_tensor(a, dev) for a in params))
    g = g.to(dev) if g is not None else None
    receivers = receivers.to(dev) if receivers is not None else None
    grid = Grid(shape=tuple(state[0].shape), spacing=spacing)
    return mod.propagate(nt, state, params, g, dt, grid, order,
                         receivers=receivers)


def acoustic_reference(nt: int, u0, u1, m, damp, dt: float,
                       spacing: Tuple[float, ...], order: int,
                       g: Optional[src_mod.GriddedSources] = None,
                       receivers: Optional[src_mod.GriddedReceivers] = None,
                       device="cuda"):
    """Run nt acoustic steps from state (u_prev=u0, u=u1) on `device`
    (default ``"cuda"``; fields may be numpy arrays or tensors).

    Returns ((u_prev, u) after nt steps, rec (nt, nrec) or None).
    """
    final, recs = _reference(
        acoustic, acoustic.AcousticState(u=u1, u_prev=u0),
        acoustic.AcousticParams(m=m, damp=damp), nt, dt, spacing, order, g,
        receivers, device)
    return (final.u_prev, final.u), recs


def tti_reference(nt: int, state, params, dt: float,
                  spacing: Tuple[float, ...], order: int,
                  g: Optional[src_mod.GriddedSources] = None,
                  receivers: Optional[src_mod.GriddedReceivers] = None,
                  device="cuda"):
    """Run nt TTI steps from a `tti.TTIState` with `tti.TTIParams` on
    `device` (fields may be numpy arrays or tensors).

    Returns (TTIState after nt steps, rec (nt, nrec) or None)."""
    return _reference(tti, tti.TTIState(*state), tti.TTIParams(*params), nt,
                      dt, spacing, order, g, receivers, device)


def elastic_reference(nt: int, state, params, dt: float,
                      spacing: Tuple[float, ...], order: int,
                      g: Optional[src_mod.GriddedSources] = None,
                      receivers: Optional[src_mod.GriddedReceivers] = None,
                      device="cuda"):
    """Run nt elastic steps from an `elastic.ElasticState` with
    `elastic.ElasticParams` on `device`.

    Returns (ElasticState after nt steps, rec (nt, nrec, 2) or None) —
    receiver channels are (vz, pressure proxy)."""
    return _reference(elastic, elastic.ElasticState(*state),
                      elastic.ElasticParams(*params), nt, dt, spacing, order,
                      g, receivers, device)


def ssd_chunked_reference(x, a, b, c, chunk: int = None):
    """Oracle for the Mamba2 SSD scan kernel: the naive sequential linear
    recurrence h[t] = a[t] * h[t-1] + b[t] * x[t]; y[t] = <c[t], h[t]>
    (the reference's `lax.scan` as a loop over t).

    Shapes: x (T, P), a (T,), b (T, N), c (T, N); h (N, P); y (T, P).
    `chunk` is unused, as in the reference.
    """
    T, P = x.shape
    h = torch.zeros((b.shape[1], P), dtype=x.dtype, device=x.device)
    ys = []
    for t in range(T):
        h = a[t] * h + b[t][:, None] * x[t][None, :]
        ys.append(c[t] @ h)
    return torch.stack(ys)
