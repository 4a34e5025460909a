"""Shard meshes for the sharded layer (port of `repro.launch.mesh`'s
`make_xy_mesh`; `make_production_mesh` and the multi-pod dry-run are not
ported yet).

The reference runs one program over a JAX device mesh (`shard_map`), one
shard a device.  The port is single-controller too: one process holds
every shard as a tensor on its mesh device, and a neighbour exchange is a
copy between shard tensors.  `ShardMesh` maps shard (i, j) of a
(px, py) grid to ``devices[(i * py + j) % len(devices)]``: with one card
every shard sits on it, with several the same code copies between cards.
"""
from __future__ import annotations

from typing import Dict, List, Sequence, Tuple

import torch

from repro_torch._device import resolve_device


class ShardMesh:
    """A (px, py) grid of shards over `devices`; grid x is the first axis
    ("data"), grid y the second ("model").

    `exchange_rounds` counts the 2-D halo exchanges of one field each
    (`distributed.halo.halo_exchange_2d`) run for this mesh; set it to 0
    before a counted run.
    """

    def __init__(self, shape: Tuple[int, int],
                 axes: Tuple[str, str] = ("data", "model"),
                 devices: Sequence = ("cuda",)):
        if len(shape) != 2 or min(shape) < 1:
            raise ValueError(f"mesh shape {shape} must be two counts >= 1")
        if len(axes) != 2:
            raise ValueError(f"mesh axes {axes} must name the two grid axes")
        if not devices:
            raise ValueError("a mesh needs at least one device")
        self.shape = {axes[0]: int(shape[0]), axes[1]: int(shape[1])}
        self.axes = tuple(axes)
        self.devices = tuple(resolve_device(d) for d in devices)
        self.exchange_rounds = 0

    @property
    def pgrid(self) -> Tuple[int, int]:
        return self.shape[self.axes[0]], self.shape[self.axes[1]]

    @property
    def size(self) -> int:
        px, py = self.pgrid
        return px * py

    def device_of(self, k: int) -> torch.device:
        """The device of flat shard k = i * py + j."""
        return self.devices[k % len(self.devices)]

    def groups(self) -> List[Tuple[torch.device, List[int]]]:
        """(device, its flat shard ids in order) for every device holding a
        shard: the shards of one group go in one kernel launch."""
        out: Dict[torch.device, List[int]] = {}
        for k in range(self.size):
            out.setdefault(self.device_of(k), []).append(k)
        return list(out.items())

    def __repr__(self):
        return (f"ShardMesh({self.pgrid}, axes={self.axes}, "
                f"devices={[str(d) for d in self.devices]})")


def make_xy_mesh(n_shards: int, devices: Sequence = ("cuda",)) -> ShardMesh:
    """(data, model) mesh of `n_shards` shards for the x/y grid
    decomposition, the reference's heuristic applied to the shard count
    (4 -> 2x2, 8 -> 4x2; fewer than 4 -> n x 1)."""
    n = int(n_shards)
    px = n // 2 if n >= 4 else n
    py = n // px
    return ShardMesh((px, py), devices=devices)


__all__ = ["ShardMesh", "make_xy_mesh"]
