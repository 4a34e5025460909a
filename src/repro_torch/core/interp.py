"""Precomputed per-axis interpolation coefficient operators (port of
`repro.core.interp`, numpy only — a copy, since the port imports nothing
of `repro`).

One representation backs every sparse source/receiver path (the
single-device tile tables here; the reference also feeds its sharded
tables and survey bucket caps from it).  The idiom is
Devito's ``PrecomputedSparseFunction`` / ``MatrixSparseTimeFunction``
("Architecture and performance of Devito", Luporini et al.): instead of
materializing the full ``(2r)**ndim`` tensor-product weights everywhere,
each off-grid point stores

  * a per-axis *base* grid index (first support point along that axis),
  * a ``(ndim, 2r)`` block of per-axis kernel coefficients,

computed ONCE per geometry.  The full stencil is the outer product of the
per-axis rows, expanded on demand by `InterpCoeffs.expand`; everything
downstream (table builders, caps, injection/gather) is kernel-agnostic
and sized by ``(2r)**ndim`` instead of a baked-in 8.

Kernels
-------
``linear`` (radius 1)
    Multilinear hat weights ``[1 - frac, frac]`` — the paper's Fig. 3
    interpolation.
``sinc`` (radius 1..8)
    Kaiser-windowed sinc (Hicks, Geophysics 2002 — the kernel behind
    Devito's ``PrecomputedSparseTimeFunction``): per-axis coefficients
    ``sinc(x) * I0(b sqrt(1 - (x/r)^2)) / I0(b)`` over the ``2r`` support
    points, normalized per axis to sum to 1 so a constant field is
    reproduced exactly.

Edge policy
-----------
Zeroing out-of-bounds corner weights without renormalizing would inject
a coordinate 0.3 cells past the edge with row sum 0.7, quietly
attenuating amplitudes, so the policy is explicit:

``edge="raise"`` (default)
    Coordinates outside the physical domain raise ``ValueError``.
``edge="clip"``
    Out-of-domain support weights are dropped and the surviving weights
    are renormalized to sum to 1 (nearest-boundary-value semantics).

Either way, *in-domain* points whose wider sinc support overhangs the
boundary get the drop-and-renormalize treatment; for the linear kernel an
in-domain point never loses weight mass (boundary-exact points carry an
exactly-zero outer weight), so its weights are exactly the plain
trilinear ones.

`InterpCoeffs` is a cacheable geometry artifact: `to_dict`/`from_dict`
round-trip it as JSON.
"""
from __future__ import annotations

import dataclasses
from typing import NamedTuple, Tuple

import numpy as np

KERNELS = ("linear", "sinc")
EDGES = ("raise", "clip")

# Kaiser window shape parameter b per support radius r, from Hicks
# (Geophysics 2002, Table 1) — the values Devito ships for its
# precomputed sinc interpolation.
_KAISER_B = {1: 1.24, 2: 2.94, 3: 4.53, 4: 6.31,
             5: 7.91, 6: 9.52, 7: 11.11, 8: 12.52}


@dataclasses.dataclass(frozen=True)
class InterpSpec:
    """Which interpolation kernel to precompute, and how edges behave.

    kernel: "linear" (multilinear, radius fixed at 1) or "sinc"
            (Kaiser-windowed sinc, radius 1..8).
    radius: support radius r — each axis uses 2r points, a point touches
            (2r)**ndim grid points (the paper's trilinear case is r=1,
            footprint 8).
    edge:   "raise" (out-of-domain coordinates are an error, default) or
            "clip" (drop out-of-domain weights, renormalize to sum 1).
    """

    kernel: str = "linear"
    radius: int = 1
    edge: str = "raise"

    def __post_init__(self):
        if self.kernel not in KERNELS:
            raise ValueError(f"kernel must be one of {KERNELS}, "
                             f"got {self.kernel!r}")
        if self.edge not in EDGES:
            raise ValueError(f"edge must be one of {EDGES}, "
                             f"got {self.edge!r}")
        if self.kernel == "linear" and self.radius != 1:
            raise ValueError("linear kernel has radius 1 "
                             f"(got radius={self.radius}); use kernel='sinc' "
                             "for wider supports")
        if not 1 <= self.radius <= 8:
            raise ValueError(f"radius must be in 1..8, got {self.radius}")

    @property
    def width(self) -> int:
        """Support points per axis (2r)."""
        return 2 * self.radius

    def footprint(self, ndim: int) -> int:
        """Grid points touched per off-grid point: (2r)**ndim."""
        return self.width ** ndim

    def to_dict(self) -> dict:
        return {"kernel": self.kernel, "radius": self.radius,
                "edge": self.edge}

    @classmethod
    def from_dict(cls, d: dict) -> "InterpSpec":
        return cls(**d)


LINEAR = InterpSpec()


def spec_for(kernel: str = "linear", order=None,
             edge: str = "raise") -> InterpSpec:
    """Resolve the CLI-level ``--interp`` / ``--interp-order`` knobs.

    `order` is the support radius r (``interp_order`` in launcher flags);
    defaults to 1 for linear and 4 for sinc (Hicks' accuracy sweet spot).
    """
    if order is None:
        order = 1 if kernel == "linear" else 4
    return InterpSpec(kernel=kernel, radius=int(order), edge=edge)


def _axis_coeffs(frac: np.ndarray, spec: InterpSpec) -> np.ndarray:
    """(num, ndim) fractional offsets -> (num, ndim, 2r) per-axis rows.

    Support point j (j = 0..2r-1) sits at grid index ``lo - (r-1) + j``,
    i.e. at signed distance ``x_j = frac + (r-1) - j`` from the point.
    """
    r = spec.radius
    if spec.kernel == "linear":
        # Exactly the corner factors [1-frac, frac] — NOT 1-|x|, which is
        # not bit-identical to them for tiny fractions.
        return np.stack([1.0 - frac, frac], axis=-1)
    j = np.arange(2 * r, dtype=np.float64)
    x = frac[..., None] + (r - 1) - j                    # (num, ndim, 2r)
    b = _KAISER_B[r]
    inside = np.abs(x) < r
    arg = np.sqrt(np.maximum(1.0 - (x / r) ** 2, 0.0))
    c = np.where(inside, np.sinc(x) * np.i0(b * arg) / np.i0(b), 0.0)
    # Normalize each axis row to sum 1 (constant-field reproduction).
    return c / c.sum(axis=-1, keepdims=True)


class InterpCoeffs(NamedTuple):
    """Precomputed per-axis coefficient operator for one point set.

    base:   (num, ndim) int64 — grid index of the FIRST support point per
            axis (lo - (r-1); may poke past the boundary near edges —
            `expand` clips and renormalizes).
    coeffs: (num, ndim, 2r) float64 — per-axis kernel rows, each summing
            to 1.
    shape:  grid shape the operator was built for.
    spec:   the `InterpSpec` that produced it.
    """

    base: np.ndarray
    coeffs: np.ndarray
    shape: Tuple[int, ...]
    spec: InterpSpec

    @property
    def num(self) -> int:
        return self.base.shape[0]

    @property
    def ndim(self) -> int:
        return self.base.shape[1]

    @property
    def footprint(self) -> int:
        return self.spec.footprint(self.ndim)

    def expand(self) -> Tuple[np.ndarray, np.ndarray]:
        """Outer-product expansion to full tensor-product stencils.

        Returns (indices (num, (2r)**ndim, ndim) int32 — clipped to the
        grid, weights (num, (2r)**ndim) float64 — rows sum to 1).  Corner
        ordering is meshgrid-ij over per-axis offsets (axis 0 most
        significant), and weights are accumulated by sequential per-axis
        multiplication — both as the reference's, so the tables agree
        bit-for-bit.
        """
        num, nd = self.base.shape
        w2 = self.coeffs.shape[-1]
        offs = np.stack(np.meshgrid(*([np.arange(w2)] * nd),
                                    indexing="ij"), axis=-1).reshape(-1, nd)
        idx = self.base[:, None, :] + offs[None, :, :]   # (num, fp, nd)
        w = np.ones((num, offs.shape[0]), np.float64)
        for d in range(nd):
            w = w * self.coeffs[:, d, :][:, offs[:, d]]
        hi = np.asarray(self.shape) - 1
        clipped = np.clip(idx, 0, hi)
        oob = np.any(clipped != idx, axis=-1)            # (num, fp)
        dropped = np.where(oob, w, 0.0).sum(axis=1)
        w = np.where(oob, 0.0, w)
        # Renormalize ONLY rows that actually lost weight mass — rows that
        # merely zeroed exactly-zero outer corners (linear boundary-exact
        # points) keep their bits.
        lost = dropped != 0.0
        if np.any(lost):
            keep = w.sum(axis=1)
            if np.any(keep[lost] == 0.0):
                p = int(np.argmax(lost & (keep == 0.0)))
                raise ValueError(
                    f"point {p} has no in-domain interpolation support "
                    f"left after clipping to grid shape {self.shape}")
            w = np.where(lost[:, None], w / np.where(keep == 0.0, 1.0,
                                                     keep)[:, None], w)
        return clipped.astype(np.int32), w

    def to_dict(self) -> dict:
        """JSON-able form (plan-cache pattern) for persisting the geometry
        artifact alongside autotuned plans."""
        return {"base": self.base.tolist(),
                "coeffs": self.coeffs.tolist(),
                "shape": list(self.shape),
                "spec": self.spec.to_dict()}

    @classmethod
    def from_dict(cls, d: dict) -> "InterpCoeffs":
        return cls(base=np.asarray(d["base"], np.int64),
                   coeffs=np.asarray(d["coeffs"], np.float64),
                   shape=tuple(d["shape"]),
                   spec=InterpSpec.from_dict(d["spec"]))


def precompute_coeffs(coords: np.ndarray, grid,
                      spec: InterpSpec = LINEAR) -> InterpCoeffs:
    """Build the per-axis coefficient operator for off-grid `coords`.

    coords: (num, ndim) physical coordinates.  Out-of-domain points raise
    `ValueError` under ``spec.edge == "raise"`` (the default); under
    ``"clip"`` they survive and `expand` renormalizes what the boundary
    leaves standing.
    """
    coords = np.atleast_2d(np.asarray(coords, np.float64))
    fi = grid.physical_to_index(coords)                  # (num, ndim)
    hi = np.asarray(grid.shape, np.float64) - 1.0
    oob = np.any((fi < 0.0) | (fi > hi), axis=-1)
    if spec.edge == "raise" and np.any(oob):
        p = int(np.argmax(oob))
        raise ValueError(
            f"point {p} at {coords[p].tolist()} (fractional index "
            f"{fi[p].tolist()}) is outside grid shape {tuple(grid.shape)}; "
            "pass an InterpSpec with edge='clip' to clamp to the boundary "
            "(weights renormalize to sum 1)")
    lo = np.floor(fi).astype(np.int64)
    frac = fi - lo
    return InterpCoeffs(base=lo - (spec.radius - 1),
                        coeffs=_axis_coeffs(frac, spec),
                        shape=tuple(grid.shape), spec=spec)
