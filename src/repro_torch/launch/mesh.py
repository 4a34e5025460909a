"""Shard meshes for the sharded layer (port of `repro.launch.mesh`:
`make_production_mesh`, `make_mesh`, `make_host_mesh`, `make_xy_mesh`).

The reference runs one program over a JAX device mesh (`shard_map`), one
shard a device.  The port runs a mesh two ways:

  single controller  one process holds every shard as a tensor on its mesh
                     device, and a neighbour exchange is a copy between
                     shard tensors.  `ShardMesh` maps shard (i, j) of a
                     (px, py) grid to ``devices[(i * py + j) %
                     len(devices)]``: with one card every shard sits on it,
                     with several the same code copies between cards;
  one shard a rank   a rank's view of a mesh over a process group
                     (`make_rank_mesh`): the mesh
                     counts every rank, shard k = i * py + j belongs to
                     rank k, and the exchange goes between ranks
                     (`distributed.process_group.DataParallel.exchange`).

A mesh on the ``meta`` device holds shapes only: the production meshes
of a dry run, built without a card.  `make_rank_view` is one rank's view
of such a mesh over a `distributed.process_group.RecordingGroup`: no
process runs, and each collective of the rank's step is recorded with
the shape of its result (`launch.dryrun`).
"""
from __future__ import annotations

from typing import Dict, List, Optional, Sequence, Tuple

import torch

from repro_torch._device import resolve_device


class ShardMesh:
    """A (px, py) grid of shards over `devices`; grid x is the
    second-to-last axis ("data"), grid y the last ("model").  Leading
    axes (the multi-pod mesh's "pod") hold copies of that grid: the
    stencil's sharded layer decomposes its grid over the last two only.

    A mesh over a process group (`make_host_mesh(group=)`,
    `make_rank_mesh`) is one rank's view: its shape counts every rank,
    `devices` holds this rank's one device, and `process_group` (a
    `distributed.process_group.DataParallel`; None on a single-controller
    mesh) runs the collectives; this rank holds shard `rank` alone
    (`groups`).  `axis_groups` holds this rank's sub-group along each
    axis ({"data": ..., "model": ...}; empty on a single-controller
    mesh and on `make_rank_mesh`'s).

    `exchange_rounds` counts the 2-D halo exchanges of one field each
    (`distributed.halo.halo_exchange_2d`) run for this mesh (by this rank
    on a rank's view); set it to 0 before a counted run.
    """

    def __init__(self, shape: Tuple[int, ...],
                 axes: Tuple[str, ...] = ("data", "model"),
                 devices: Sequence = ("cuda",)):
        if len(shape) < 2 or min(shape) < 1:
            raise ValueError(f"mesh shape {shape} must be two or more "
                             "counts >= 1")
        if len(axes) != len(shape):
            raise ValueError(f"mesh axes {axes} must name each of the "
                             f"{len(shape)} axes of {shape}")
        if not devices:
            raise ValueError("a mesh needs at least one device")
        self.shape = {a: int(n) for a, n in zip(axes, shape)}
        self.axes = tuple(axes)
        self.devices = tuple(resolve_device(d) for d in devices)
        self.process_group = None
        self.axis_groups = {}
        self.exchange_rounds = 0

    @property
    def pgrid(self) -> Tuple[int, int]:
        return self.shape[self.axes[-2]], self.shape[self.axes[-1]]

    @property
    def size(self) -> int:
        px, py = self.pgrid
        return px * py

    @property
    def rank(self) -> Optional[int]:
        """The shard this process holds on a rank's view (its rank in the
        group); None on a single-controller mesh."""
        group = self.process_group
        return None if group is None else group.rank

    def device_of(self, k: int) -> torch.device:
        """The device of flat shard k = i * py + j (on a rank's view, of
        this rank's shard only: the others live in other processes)."""
        if self.rank is not None:
            if k != self.rank:
                raise ValueError(f"shard {k} belongs to rank {k}; this is "
                                 f"rank {self.rank}")
            return self.devices[0]
        return self.devices[k % len(self.devices)]

    def groups(self) -> List[Tuple[torch.device, List[int]]]:
        """(device, its flat shard ids in order) for every device of this
        process holding a shard: the shards of one group go in one kernel
        launch.  On a rank's view, this rank's device and shard."""
        if self.rank is not None:
            return [(self.devices[0], [self.rank])]
        out: Dict[torch.device, List[int]] = {}
        for k in range(self.size):
            out.setdefault(self.device_of(k), []).append(k)
        return list(out.items())

    def __repr__(self):
        return (f"ShardMesh({self.pgrid}, axes={self.axes}, "
                f"devices={[str(d) for d in self.devices]})")


def mesh_devices(device="cuda") -> List[torch.device]:
    """The devices a mesh spreads its shards over: every visible card for
    ``cuda``, else the one device named."""
    dev = resolve_device(device)
    if dev.type == "cuda" and dev.index is None:
        return [torch.device("cuda", i)
                for i in range(torch.cuda.device_count())]
    return [dev]


def make_production_mesh(*, multi_pod: bool = False,
                         devices: Sequence = ("meta",)) -> ShardMesh:
    """16x16 = 256 shards a pod; multi_pod adds a leading pod=2 axis (512).
    On the ``meta`` device by default: a shape-only mesh, which a dry run
    builds without a card (one process cannot hold 256 cards' shards)."""
    shape = (2, 16, 16) if multi_pod else (16, 16)
    axes = ("pod", "data", "model") if multi_pod else ("data", "model")
    return make_mesh(shape, axes, devices)


def make_mesh(shape, axes, devices: Sequence = ("cuda",)) -> ShardMesh:
    return ShardMesh(tuple(shape), tuple(axes), devices)


def make_host_mesh(model: int = 1, device="cuda", group=None) -> ShardMesh:
    """Tiny (data, model) mesh over however many devices this host has
    (`mesh_devices`): tests, examples.  Over a process group (a
    `distributed.process_group.DataParallel`) it counts the group's ranks,
    as the reference counts `jax.devices()` across processes: (world //
    model, model), on this rank's device, with the group's sub-groups
    along each axis (`DataParallel.axis_groups`: every rank of the group
    must make the mesh, at the same point)."""
    if group is None:
        devices = mesh_devices(device)
        return make_mesh((len(devices) // model, model), ("data", "model"),
                         devices)
    if group.world % model:
        raise ValueError(f"model axis {model} does not divide the "
                         f"{group.world} ranks")
    mesh = make_mesh((group.world // model, model), ("data", "model"),
                     [group.device])
    mesh.process_group = group
    mesh.axis_groups = group.axis_groups(mesh)
    return mesh


def make_rank_mesh(pgrid: Tuple[int, int], group) -> ShardMesh:
    """This rank's view of a (px, py) shard mesh over `group` (a
    `distributed.process_group.DataParallel`), one shard a rank: shard k
    = i * py + j is rank k's, on its device.  Every rank of the group
    makes it; px * py must be the group's rank count."""
    px, py = (int(v) for v in pgrid)
    if px * py != group.world:
        raise ValueError(f"a {px}x{py} mesh has {px * py} shards, the "
                         f"process group {group.world} ranks: the sharded "
                         "layer runs one shard a rank")
    mesh = make_mesh((px, py), ("data", "model"), [group.device])
    mesh.process_group = group
    return mesh


def make_rank_view(shape: Optional[Sequence[int]] = None,
                   axes: Optional[Sequence[str]] = None, *,
                   multi_pod: bool = False, rank: int = 0) -> ShardMesh:
    """Rank `rank`'s view (default rank 0's coordinates) of a mesh of
    `shape` over `axes` (default `make_production_mesh(multi_pod=)`'s:
    (16, 16) data x model, or (2, 16, 16) pod x data x model) on
    ``meta``, over a `distributed.process_group.RecordingGroup` of every
    rank: its `axis_groups` hold this rank's group along each axis and,
    where there are several data axes, the group over them all (keyed by
    the tuple of their names, the multi-pod mesh's ("pod", "data")),
    each a recorder sharing the world's counters."""
    from repro_torch.distributed.process_group import RecordingGroup
    from repro_torch.distributed.sharding import all_coords

    if shape is None:
        shape = (2, 16, 16) if multi_pod else (16, 16)
        axes = ("pod", "data", "model") if multi_pod else ("data", "model")
    mesh = make_mesh(tuple(shape), tuple(axes), ("meta",))
    world = RecordingGroup(rank, mesh_size(mesh))
    mesh.process_group = world
    mesh.axis_groups = world.axis_groups(mesh)
    data = tuple(a for a in mesh.axes if a != "model")
    if len(data) > 1:
        coords = all_coords(mesh)
        mine = coords[rank]
        members = [r for r, c in enumerate(coords)
                   if c["model"] == mine["model"]]
        mesh.axis_groups[data] = world._sub(members, None)
    return mesh


def mesh_size(mesh) -> int:
    """The number of devices (ranks) the mesh counts."""
    n = 1
    for v in mesh.shape.values():
        n *= v
    return n


def make_xy_mesh(n_shards: int, devices: Sequence = ("cuda",)) -> ShardMesh:
    """(data, model) mesh of `n_shards` shards for the x/y grid
    decomposition, the reference's heuristic applied to the shard count
    (4 -> 2x2, 8 -> 4x2; fewer than 4 -> n x 1)."""
    n = int(n_shards)
    px = n // 2 if n >= 4 else n
    py = n // px
    return ShardMesh((px, py), devices=devices)


__all__ = ["ShardMesh", "make_host_mesh", "make_mesh",
           "make_production_mesh", "make_rank_mesh", "make_rank_view",
           "make_xy_mesh", "mesh_devices", "mesh_size"]
