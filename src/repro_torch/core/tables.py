"""Window-grid binning and slot packing for sparse-point tables (port of
`repro.core.tables`, numpy only — a copy, since the port imports nothing
of `repro`).

Given sparse grid points (affected source points or receiver gather
entries), bin them into a regular grid of tile *windows* (centre region +
halo overhang) and pack each bin into fixed-`cap` padded arrays a kernel
can index:

  * `axis_tile_range` — the O(pairs) enumeration of tiles along one axis
    whose window contains a coordinate;
  * `WindowGrid` — a tile grid's geometry (origin of tile (0,0)'s window,
    tile pitch, counts, halo pad) with centre/window binning;
  * `pack_slots` — bin -> slot assignment with one overflow contract:
    auto-size the cap when the caller passes none, otherwise raise an
    error naming the offending tile, the supplied cap, and the required
    cap.
"""
from __future__ import annotations

from typing import Iterable, List, NamedTuple, Optional, Sequence, Tuple

import numpy as np


def axis_tile_range(v: int, lo0: int, pitch: int, n: int,
                    span: int) -> Tuple[int, int]:
    """Inclusive index range [k_lo, k_hi] of tiles along ONE axis whose
    window ``[lo0 + k*pitch, lo0 + k*pitch + span)`` contains coordinate
    `v`, clamped to ``0..n-1``.  Empty when k_lo > k_hi.

    O(1); callers iterate only the (usually 1-2) covering tiles instead
    of scanning all windows.
    """
    k_lo = max(0, -(-(v - lo0 - span + 1) // pitch))
    k_hi = min(n - 1, (v - lo0) // pitch)
    return k_lo, k_hi


class WindowGrid(NamedTuple):
    """A 2-D grid of tile windows over the leading (x, y) grid axes.

    origin:  global (x, y) of tile (0, 0)'s WINDOW lo corner (centre
             origin minus `pad`).
    tile:    (tx, ty) centre-region pitch.
    ntiles:  (ntx, nty) tile counts.
    pad:     window overhang past the centre on every side (the TB halo).
    """

    origin: Tuple[int, int]
    tile: Tuple[int, int]
    ntiles: Tuple[int, int]
    pad: int

    @property
    def n_tiles(self) -> int:
        return self.ntiles[0] * self.ntiles[1]

    def window_origin(self, ti: int, tj: int) -> Tuple[int, int]:
        """Global (x, y) of tile (ti, tj)'s window lo corner — subtract
        from a global point to get kernel-local coordinates."""
        return (self.origin[0] + ti * self.tile[0],
                self.origin[1] + tj * self.tile[1])

    def tiles_covering(self, x: int, y: int,
                       mode: str) -> Iterable[Tuple[int, int]]:
        """(ti, tj) pairs whose region contains global point (x, y).

        mode "window": the full window (centre + pad) — points get
        deliberately duplicated across overlapping windows (paper
        Fig. 4b: a source in a neighbour's centre must be injected into
        this tile's halo during the in-window steps).
        mode "centre": the pad-stripped centre regions, which partition —
        at most one tile per axis.
        """
        pad = self.pad if mode == "window" else 0
        (ox, oy), (tx, ty), (ntx, nty) = self.origin, self.tile, self.ntiles
        shift = self.pad - pad                 # centre binning starts deeper
        i_lo, i_hi = axis_tile_range(x, ox + shift, tx, ntx, tx + 2 * pad)
        j_lo, j_hi = axis_tile_range(y, oy + shift, ty, nty, ty + 2 * pad)
        for ti in range(i_lo, i_hi + 1):
            for tj in range(j_lo, j_hi + 1):
                yield ti, tj


def bin_points(pts_xy: np.ndarray, wg: WindowGrid,
               mode: str) -> List[Tuple[int, int]]:
    """Flat ``(tile_id, point_idx)`` assignment pairs, point-major (every
    point's covering tiles in ascending (ti, tj)) — the reference's
    deterministic slot order."""
    nty = wg.ntiles[1]
    pairs = []
    for p in range(pts_xy.shape[0]):
        x, y = int(pts_xy[p, 0]), int(pts_xy[p, 1])
        for ti, tj in wg.tiles_covering(x, y, mode):
            pairs.append((ti * nty + tj, p))
    return pairs


def overflow_message(label: str, tile_id, cap: int, required: int) -> str:
    """The one cap-overflow error format: names the tile, the supplied
    cap, and the cap that would have sufficed."""
    return (f"{label}: tile {tile_id} overflows cap={cap} "
            f"(requires cap={required}); raise cap to >= {required} "
            f"or pass cap=None to auto-size")


def pack_slots(pairs: Sequence[Tuple[int, int]], n_tiles: int,
               cap: Optional[int], label: str,
               tile_name=None) -> Tuple[np.ndarray, np.ndarray, int]:
    """Assign each (tile_id, payload) pair a slot k in its tile's bin.

    Returns (fill (n_tiles,) int32 — entries per tile, slot (len(pairs),)
    int32 — k for each pair in order, cap).  ``cap=None`` auto-sizes to
    the fullest bin (>= 1 so downstream shapes never collapse); a
    supplied cap that any bin exceeds raises `overflow_message`.
    `tile_name` maps a flat tile id to a display id for the error (the
    sharded builders report (shard, tile) tuples).
    """
    tids = np.fromiter((t for t, _ in pairs), np.int64, len(pairs))
    counts = np.bincount(tids, minlength=n_tiles) if len(pairs) else \
        np.zeros(n_tiles, np.int64)
    required = int(counts.max(initial=0))
    if cap is None:
        cap = max(required, 1)
    elif required > cap:
        bad = int(np.argmax(counts))
        disp = tile_name(bad) if tile_name is not None else bad
        raise ValueError(overflow_message(label, disp, cap,
                                          int(counts[bad])))
    fill = np.zeros(n_tiles, np.int32)
    slot = np.zeros(len(pairs), np.int32)
    for i, (tt, _) in enumerate(pairs):
        slot[i] = fill[tt]
        fill[tt] += 1
    return fill, slot, int(cap)
