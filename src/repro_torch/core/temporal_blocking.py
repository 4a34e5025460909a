"""Temporal blocking plan (port of `repro.core.temporal_blocking.TBPlan`).

Only the plan type the single-device driver needs is ported so far; the
autotuner, pass geometry and cost registry are later slices of the port.
"""
from __future__ import annotations

import dataclasses
from typing import Tuple


@dataclasses.dataclass(frozen=True)
class TBPlan:
    """A (tile_x, tile_y, T) choice for the TB kernel."""

    tile: Tuple[int, int]
    T: int
    radius: int

    def to_dict(self) -> dict:
        """JSON-safe form (the survey plan cache's on-disk format)."""
        return {"tile": [int(t) for t in self.tile], "T": int(self.T),
                "radius": int(self.radius)}

    @classmethod
    def from_dict(cls, d: dict) -> "TBPlan":
        return cls(tile=tuple(int(t) for t in d["tile"]), T=int(d["T"]),
                   radius=int(d["radius"]))

    @property
    def halo(self) -> int:
        return self.T * self.radius

    def window(self, nz: int) -> Tuple[int, int, int]:
        tx, ty = self.tile
        return (tx + 2 * self.halo, ty + 2 * self.halo, nz)

    def overlap_factor(self) -> float:
        """Redundant-compute multiplier of the trapezoid: window area over
        tile area, averaged over the T steps actually computed
        (sum_k prod_d (tile_d + 2*(T-k)*r) / (T * prod_d tile_d))."""
        tx, ty = self.tile
        r = self.radius
        tot = 0.0
        for k in range(self.T):
            m = (self.T - k) * r
            tot += (tx + 2 * m) * (ty + 2 * m)
        return tot / (self.T * tx * ty)

    def hbm_bytes_per_point_step(self, nz: int, read_fields: int = 4,
                                 write_fields: int = 1,
                                 dtype_bytes: int = 4) -> float:
        """Device-memory bytes moved per grid-point-timestep: the window is
        read and the centre written once per T steps."""
        tx, ty = self.tile
        wx, wy, _ = self.window(nz)
        read = wx * wy * nz * read_fields * dtype_bytes
        write = tx * ty * nz * write_fields * dtype_bytes
        return (read + write) / (tx * ty * nz * self.T)
