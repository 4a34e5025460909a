"""Absorbing boundary layers (damping sponge), port of `repro.core.boundary`.

The standard Devito-style damping profile: zero in the physical interior
and growing like a cubic polynomial of the normalized depth into the
sponge, scaled by 1/h.  The per-axis profiles are computed in float64
numpy exactly as the reference does; the full-grid maximum is taken in
float64 on the target device (so a 512^3 model is built on the card) and
rounded once to `dtype`.
"""
from __future__ import annotations

from typing import Tuple

import numpy as np
import torch

from repro_torch._device import resolve_device


def damping_field(shape: Tuple[int, ...], nbl: int, spacing: Tuple[float, ...],
                  coeff: float = 1.5, dtype=torch.float32,
                  free_surface_axis: int | None = None,
                  device="cuda") -> torch.Tensor:
    """Damping coefficient field, zero in the interior.

    Args:
      shape: full grid shape (including the `nbl`-deep sponge on every face).
      nbl: number of absorbing boundary layers.
      coeff: log(1/R)-style strength coefficient.
      free_surface_axis: if set, the *low* face of this axis gets no sponge.
      device: where the field is built (default ``"cuda"``).
    """
    dev = resolve_device(device)
    if nbl == 0:
        return torch.zeros(shape, dtype=dtype, device=dev)
    damp = torch.zeros(shape, dtype=torch.float64, device=dev)
    for ax, n in enumerate(shape):
        pos = np.arange(n, dtype=np.float64)
        lo = np.clip((nbl - pos) / nbl, 0.0, 1.0)
        hi = np.clip((pos - (n - 1 - nbl)) / nbl, 0.0, 1.0)
        if free_surface_axis is not None and ax == free_surface_axis:
            lo = np.zeros_like(lo)
        prof = coeff * (lo ** 3 + hi ** 3) / min(spacing)
        shape_b = [1] * len(shape)
        shape_b[ax] = n
        damp = torch.maximum(
            damp, torch.as_tensor(prof, device=dev).reshape(shape_b))
    return damp.to(dtype)


def pad_model(field: np.ndarray, nbl: int, mode: str = "edge") -> np.ndarray:
    """Extend a physical model (e.g. velocity) into the sponge by edge copy."""
    if nbl == 0:
        return field
    return np.pad(field, [(nbl, nbl)] * field.ndim, mode=mode)
