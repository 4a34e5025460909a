"""The paper's own experimental configurations (§IV.B), port of
`repro.configs.paper_stencil`.

512^3 grid, single Ricker source, space orders 4/8/12, three propagators.
`full_case` reproduces the paper's setup; `reduced_case` is the CPU-sized
variant the tests run.
"""
from __future__ import annotations

import dataclasses
from typing import Tuple

import numpy as np


@dataclasses.dataclass(frozen=True)
class StencilCase:
    name: str
    propagator: str               # acoustic | tti | elastic
    shape: Tuple[int, int, int]
    spacing: Tuple[float, float, float]
    space_order: int
    time_ms: float                # simulated physical time
    f0: float = 10.0              # Ricker peak frequency (Hz)
    nbl: int = 10                 # absorbing layers
    vmin: float = 1500.0
    vmax: float = 3500.0

    def nt(self, dt: float) -> int:
        return max(int(np.ceil(self.time_ms / 1000.0 / dt)), 1)


def full_case(propagator: str, space_order: int) -> StencilCase:
    """Paper §IV.B: 512^3, spacing 10 m (20 m for TTI), 512 ms."""
    spacing = 20.0 if propagator == "tti" else 10.0
    return StencilCase(
        name=f"{propagator}-O{space_order}-512",
        propagator=propagator,
        shape=(512, 512, 512),
        spacing=(spacing,) * 3,
        space_order=space_order,
        time_ms=512.0,
    )


def reduced_case(propagator: str, space_order: int,
                 n: int = 48, time_ms: float = 24.0) -> StencilCase:
    spacing = 20.0 if propagator == "tti" else 10.0
    return StencilCase(
        name=f"{propagator}-O{space_order}-{n}",
        propagator=propagator,
        shape=(n, n, n),
        spacing=(spacing,) * 3,
        space_order=space_order,
        time_ms=time_ms,
        nbl=4,
    )


PAPER_CASES = tuple(
    full_case(p, so)
    for p in ("acoustic", "tti", "elastic")
    for so in (4, 8, 12)
)
