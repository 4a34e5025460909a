"""Finite-difference stencil machinery (port of `repro.core.stencil`).

Arbitrary-(even)-order central and staggered FD weights, plus the shifted
array application used by every propagator.  Weights are computed once in
float64 with numpy; applications are torch slicing of zero-padded tensors,
in the reference's term order: taps in order, zero weights skipped, each
coefficient ``w * h**-deriv`` rounded to the field dtype.

Boundary convention: all operators act on arrays zero-padded by the stencil
radius (homogeneous Dirichlet halo) — the same convention the TB kernel
uses, so the oracle and the kernel agree.
"""
from __future__ import annotations

import functools
import math
from typing import Sequence, Tuple

import numpy as np
import torch
import torch.nn.functional as F


# ---------------------------------------------------------------------------
# Weight generation (numpy, float64)
# ---------------------------------------------------------------------------

def fd_weights(offsets: Sequence[float], deriv: int) -> np.ndarray:
    """FD weights for the `deriv`-th derivative on arbitrary point offsets.

    Solves the Vandermonde moment system sum_k w_k off_k^i / i! = delta(i,
    deriv); exact for polynomials up to degree len(offsets)-1.  Offsets are
    in units of the grid spacing; resulting weights must be scaled by
    h**-deriv by the caller.
    """
    offsets = np.asarray(offsets, dtype=np.float64)
    n = offsets.size
    if deriv >= n:
        raise ValueError(f"need more than {n} points for derivative {deriv}")
    A = np.vander(offsets, n, increasing=True).T  # A[i, k] = off_k**i
    b = np.zeros(n)
    b[deriv] = math.factorial(deriv)
    return np.linalg.solve(A, b)


@functools.lru_cache(maxsize=None)
def second_derivative_weights(order: int) -> np.ndarray:
    """Central weights for d2/dx2, half-width r = order//2 (2r+1 taps)."""
    if order % 2 != 0 or order < 2:
        raise ValueError(f"space order must be even >= 2, got {order}")
    r = order // 2
    return fd_weights(tuple(range(-r, r + 1)), 2)


@functools.lru_cache(maxsize=None)
def first_derivative_weights(order: int) -> np.ndarray:
    """Central weights for d/dx, half-width r = order//2 (2r+1 taps)."""
    if order % 2 != 0 or order < 2:
        raise ValueError(f"space order must be even >= 2, got {order}")
    r = order // 2
    return fd_weights(tuple(range(-r, r + 1)), 1)


@functools.lru_cache(maxsize=None)
def staggered_first_derivative_weights(order: int
                                       ) -> Tuple[np.ndarray, np.ndarray]:
    """Staggered d/dx weights evaluated at half-points.

    Returns (offsets, weights) with offsets at ±1/2, ±3/2, ... — the
    classic velocity–stress leapfrog taps.  `order` is the number of taps.
    """
    if order % 2 != 0 or order < 2:
        raise ValueError(f"staggered order must be even >= 2, got {order}")
    half = order // 2
    offs = np.array([k + 0.5 for k in range(-half, half)])
    return offs, fd_weights(tuple(offs), 1)


def radius(order: int) -> int:
    return order // 2


def round_to(x: float, dtype: torch.dtype) -> float:
    """`x` rounded to `dtype`, as a Python float that holds it exactly —
    the torch counterpart of ``jnp.asarray(x, dtype)`` for a constant."""
    return float(torch.tensor(x, dtype=torch.float64).to(dtype))


def axis_taps(weights: np.ndarray, h: float, deriv: int,
              dtype: torch.dtype) -> Tuple[Tuple[int, float], ...]:
    """(offset, coefficient) per non-zero tap of a centred stencil, in tap
    order, coefficients ``w * h**-deriv`` rounded to `dtype` — the terms
    `apply_axis_stencil` sums."""
    r = (len(weights) - 1) // 2
    scale = float(h) ** (-deriv)
    return tuple((k - r, round_to(w * scale, dtype))
                 for k, w in enumerate(weights) if w != 0.0)


# ---------------------------------------------------------------------------
# Shifted-slice application (Dirichlet halo)
# ---------------------------------------------------------------------------

def _pad_axis(u: torch.Tensor, axis: int, pad: int) -> torch.Tensor:
    """Zero-pad `u` by `pad` on both sides of `axis`."""
    spec = [0] * (2 * u.ndim)
    k = 2 * (u.ndim - 1 - axis)      # F.pad lists the last axis first
    spec[k] = spec[k + 1] = pad
    return F.pad(u, spec)


def shifted(u: torch.Tensor, shift: int, axis: int, pad: int) -> torch.Tensor:
    """`u` shifted by `shift` along `axis`, zero-filled outside the domain."""
    if shift == 0:
        return u
    return _pad_axis(u, axis, pad).narrow(axis, pad + shift, u.shape[axis])


def apply_axis_stencil(u: torch.Tensor, weights: np.ndarray, axis: int,
                       h: float, deriv: int) -> torch.Tensor:
    """Apply a 1-D stencil with integer offsets centred at 0 along `axis`."""
    r = (len(weights) - 1) // 2
    up = _pad_axis(u, axis, r)
    acc = None
    for shift, c in axis_taps(weights, h, deriv, u.dtype):
        term = up.narrow(axis, r + shift, u.shape[axis]) * c
        acc = term if acc is None else acc + term
    return acc


def laplacian(u: torch.Tensor, spacing: Sequence[float],
              order: int) -> torch.Tensor:
    """order-`order` Laplacian over all dims of `u` (the paper's A(t,x,y,z))."""
    w = second_derivative_weights(order)
    out = None
    for ax, h in enumerate(spacing):
        term = apply_axis_stencil(u, w, ax, h, 2)
        out = term if out is None else out + term
    return out


def first_derivative(u: torch.Tensor, axis: int, h: float,
                     order: int) -> torch.Tensor:
    """Central first derivative along one axis."""
    return apply_axis_stencil(u, first_derivative_weights(order), axis, h, 1)


def staggered_derivative(u: torch.Tensor, axis: int, h: float, order: int,
                         shift: int) -> torch.Tensor:
    """Staggered first derivative along `axis`, evaluated at points offset by
    `shift` ∈ {+1, -1} half-cells (forward / backward staggering)."""
    offs, w = staggered_first_derivative_weights(order)
    int_offsets = np.round(offs + 0.5 * shift).astype(int)
    r = int(np.max(np.abs(int_offsets)))
    up = _pad_axis(u, axis, r)
    acc = None
    scale = float(h) ** (-1)
    for off, wk in zip(int_offsets, w):
        term = (up.narrow(axis, r + int(off), u.shape[axis])
                * round_to(wk * scale, u.dtype))
        acc = term if acc is None else acc + term
    return acc


def stencil_flops_per_point(order: int, ndim: int = 3) -> int:
    """FLOPs of one Laplacian application per grid point (for rooflines)."""
    taps = order + 1
    return ndim * (2 * taps - 1)
