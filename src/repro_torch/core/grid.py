"""Cartesian FD grid description (port of `repro.core.grid`, numpy only).

A :class:`Grid` is the static geometry every other component (stencils,
sources, propagators, kernels) agrees on.  It is a frozen dataclass, so it
is hashable.  The code is a copy of the reference module: the port imports
nothing of `repro`.
"""
from __future__ import annotations

import dataclasses
from typing import Tuple

import numpy as np

Coord = Tuple[float, ...]


@dataclasses.dataclass(frozen=True)
class Grid:
    """A regular Cartesian grid.

    Attributes:
      shape:   number of grid points per dimension (interior, no halo).
      spacing: physical distance between adjacent points per dimension.
      origin:  physical coordinate of grid index (0, ..., 0).
    """

    shape: Tuple[int, ...]
    spacing: Tuple[float, ...]
    origin: Tuple[float, ...] = None  # type: ignore[assignment]

    def __post_init__(self):
        if self.origin is None:
            object.__setattr__(self, "origin", (0.0,) * len(self.shape))
        if not (len(self.shape) == len(self.spacing) == len(self.origin)):
            raise ValueError(
                f"rank mismatch: shape={self.shape} spacing={self.spacing} "
                f"origin={self.origin}")

    @property
    def ndim(self) -> int:
        return len(self.shape)

    @property
    def extent(self) -> Coord:
        """Physical size of the domain along each dimension."""
        return tuple((n - 1) * h for n, h in zip(self.shape, self.spacing))

    @property
    def npoints(self) -> int:
        return int(np.prod(self.shape))

    def physical_to_index(self, coords: np.ndarray) -> np.ndarray:
        """Map physical coordinates (..., ndim) to fractional grid indices."""
        coords = np.asarray(coords, dtype=np.float64)
        origin = np.asarray(self.origin, dtype=np.float64)
        spacing = np.asarray(self.spacing, dtype=np.float64)
        return (coords - origin) / spacing

    def index_to_physical(self, idx: np.ndarray) -> np.ndarray:
        idx = np.asarray(idx, dtype=np.float64)
        origin = np.asarray(self.origin, dtype=np.float64)
        spacing = np.asarray(self.spacing, dtype=np.float64)
        return origin + idx * spacing

    def contains(self, coords: np.ndarray) -> np.ndarray:
        """True where physical coordinates fall inside the domain."""
        fi = self.physical_to_index(coords)
        hi = np.asarray(self.shape, dtype=np.float64) - 1.0
        return np.all((fi >= 0.0) & (fi <= hi), axis=-1)

    def cfl_dt(self, vmax: float, order: int = 2) -> float:
        """A stable explicit time step per the CFL condition (paper §IV.B).

        dt <= coeff * h_min / vmax, with the standard conservative
        coefficient for 2nd-order-in-time explicit schemes in `ndim`
        dimensions.  Higher space orders shrink the bound through the sum of
        |FD weights|; we use the usual safety factor employed by Devito.
        """
        from repro_torch.core import stencil as _st

        h_min = float(min(self.spacing))
        w = _st.second_derivative_weights(order)
        a = float(np.sum(np.abs(w)))  # per-dimension weight mass
        coeff = 2.0 / np.sqrt(self.ndim * a)
        return 0.9 * coeff * h_min / float(vmax)
