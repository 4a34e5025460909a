"""Fault-tolerant checkpointing (port of `repro.checkpoint.manager`), in
the reference's on-disk format, so a checkpoint written by either package
restores in the other.

  * **format**: one ``<host:05d>__<name>.npy`` a leaf, the name the leaf's
    path joined with ``/`` as the reference's `jax.tree_util` key paths
    name it (dict keys sorted, a NamedTuple's fields by name:
    ``opt/master/blocks/in_x``, ``opt/step``), with
    characters outside ``[A-Za-z0-9_.-]`` replaced by ``_`` in the file
    name; bf16 stored as its raw bits (``uint16``), the logical dtype in
    the manifest.  bf16 goes through `torch` views: no `ml_dtypes`.
  * **atomic commit**: state is written into ``step_<n>.tmp/``, the
    ``MANIFEST.json`` (leaf index, shapes, dtypes, metadata) LAST, then
    the directory is renamed to ``step_<n>/``.  A reader trusts only
    directories holding a manifest; a ``.tmp`` left by a crash is
    removed at the next save.
  * **async commit**: ``save(..., blocking=False)`` copies the state from
    the device to the host first, inside `save`, then hands the host
    arrays to a writer thread, so the loop may go on.
  * **retention**: the newest `keep` committed checkpoints stay.
  * **under a process group** (`group=`, a `distributed.process_group.
    DataParallel`): the content stays global (the caller gathers the
    ranks' model-axis and ZeRO-1 shards, `DataParallel.gather`) and is
    written once, by rank 0, in the same format; the other ranks wait for
    its commit (`wait`, a collective every rank calls at the same saves).
  * **elastic restore**: `restore_sharded` reads each leaf's slice that
    a rank holds under a spec (`distributed.ShardingRules`) on every axis
    of the mesh, so a checkpoint written at one data-parallel or
    model-parallel size resumes at another.
"""
from __future__ import annotations

import json
import os
import re
import shutil
import threading
from typing import Any, Optional

import numpy as np
import torch

from repro_torch.tree import map_named

MANIFEST = "MANIFEST.json"


def _sanitize(name: str) -> str:
    return re.sub(r"[^A-Za-z0-9_.\-]", "_", name)


def _to_host(leaf):
    """(numpy array to store, logical dtype name) of one leaf: a tensor is
    copied to the host (bf16 as its raw bits)."""
    if torch.is_tensor(leaf):
        t = leaf.detach().to("cpu", copy=True)
        if t.dtype == torch.bfloat16:
            return t.view(torch.int16).numpy().view(np.uint16), "bfloat16"
        arr = t.numpy()
        return arr, str(arr.dtype)
    arr = np.asarray(leaf)
    return arr, str(arr.dtype)


def _host_leaves(tree) -> list:
    """[(name, host array, logical dtype)] of every leaf, in order."""
    out = []
    map_named(lambda name, leaf: out.append((name, *_to_host(leaf))), tree)
    return out


def _write(path: str, host_leaves, metadata: Optional[dict], host: int):
    tmp = path + ".tmp"
    if os.path.exists(tmp):
        shutil.rmtree(tmp)
    os.makedirs(tmp, exist_ok=True)
    index = []
    for name, arr, logical_dtype in host_leaves:
        fname = f"{host:05d}__{_sanitize(name)}.npy"
        np.save(os.path.join(tmp, fname), arr)
        index.append({"name": name, "file": fname,
                      "shape": list(arr.shape), "dtype": logical_dtype})
    manifest = {"leaves": index, "metadata": metadata or {}, "host": host}
    # manifest LAST = commit marker
    with open(os.path.join(tmp, MANIFEST), "w") as f:
        json.dump(manifest, f)
    if os.path.exists(path):
        shutil.rmtree(path)
    os.rename(tmp, path)


def save_pytree(path: str, tree: Any, metadata: Optional[dict] = None,
                host: int = 0):
    """Atomic write of a tree of tensors (or arrays) to `path/`."""
    _write(path, _host_leaves(tree), metadata, host)


def _as_tensor(arr: np.ndarray, entry: dict) -> torch.Tensor:
    """A stored array as a tensor of the entry's logical dtype."""
    if str(arr.dtype) == entry["dtype"]:
        return torch.from_numpy(arr)
    # bf16's raw bits: uint16 as the port writes them, or the two-byte
    # void numpy saves an `ml_dtypes` bfloat16 array as (the reference's
    # files on numpy 2, where its `isbuiltin` test lets them through)
    if entry["dtype"] == "bfloat16" and arr.dtype.itemsize == 2 \
            and arr.dtype.kind in "uV":
        return torch.from_numpy(arr.view(np.int16)).view(torch.bfloat16)
    raise TypeError(f"leaf {entry['name']!r}: stored as {arr.dtype}, "
                    f"logical dtype {entry['dtype']} is not readable here")


def _load_tree(path: str, like: Any, place):
    """`like`'s structure with each leaf place(name, stored array (numpy,
    memory-mapped), like's leaf) -> tensor; shapes checked against
    `like`."""
    with open(os.path.join(path, MANIFEST)) as f:
        manifest = json.load(f)
    by_name = {e["name"]: e for e in manifest["leaves"]}

    def get(name, leaf):
        if name not in by_name:
            raise KeyError(f"checkpoint missing leaf {name!r}")
        entry = by_name[name]
        arr = np.load(os.path.join(path, entry["file"]), mmap_mode="r")
        want = tuple(getattr(leaf, "shape", arr.shape))
        if tuple(arr.shape) != want:
            raise ValueError(f"leaf {name!r}: checkpoint shape "
                             f"{tuple(arr.shape)} != expected {want}")
        return place(name, _Stored(arr, entry), leaf)

    return map_named(get, like)


class _Stored:
    """A stored leaf: its array (memory-mapped) and manifest entry; `read`
    copies a slice of it into a tensor of the logical dtype."""

    def __init__(self, arr, entry):
        self.arr, self.entry = arr, entry

    def read(self, index=()) -> torch.Tensor:
        return _as_tensor(np.array(self.arr[index], order="C"), self.entry)


def load_pytree(path: str, like: Any):
    """Restore into the structure of `like`: each leaf a tensor on the
    device of `like`'s leaf (the CPU for a leaf that is not a tensor),
    with the checkpoint's dtype; shapes checked against `like`."""
    def place(name, stored, leaf):
        t = stored.read()
        return t.to(leaf.device) if torch.is_tensor(leaf) else t

    return _load_tree(path, like, place)


def load_metadata(path: str) -> dict:
    with open(os.path.join(path, MANIFEST)) as f:
        return json.load(f)["metadata"]


class CheckpointManager:
    """Step-indexed checkpoint directory with retention + async commit.
    Under a process group (`group`) every rank calls `save` and `wait` at
    the same points with the same global tree; rank 0 writes."""

    def __init__(self, directory: str, keep: int = 3, group=None):
        self.directory = directory
        self.keep = keep
        self.group = group
        os.makedirs(directory, exist_ok=True)
        self._thread: Optional[threading.Thread] = None
        self._error: Optional[BaseException] = None
        self._pending = False      # a save whose commit the ranks await

    @property
    def _writer(self) -> bool:
        return self.group is None or self.group.rank == 0

    # -- paths ---------------------------------------------------------------
    def _path(self, step: int) -> str:
        return os.path.join(self.directory, f"step_{step:010d}")

    def steps(self):
        out = []
        for d in os.listdir(self.directory):
            m = re.fullmatch(r"step_(\d+)", d)
            if m and os.path.exists(os.path.join(self.directory, d, MANIFEST)):
                out.append(int(m.group(1)))
        return sorted(out)

    def latest_step(self) -> Optional[int]:
        s = self.steps()
        return s[-1] if s else None

    # -- save / restore --------------------------------------------------
    def wait(self):
        """Until the last save is committed; raises its writer's error.
        Under a group every rank waits for rank 0's commit and raises if
        it failed."""
        if self._thread is not None:
            self._thread.join()
            self._thread = None
        failed = self._error is not None
        if self.group is not None and self._pending:
            self._pending = False
            failed = bool(self.group.max(float(failed)) > 0)
        if self._error is not None:
            err, self._error = self._error, None
            raise err
        if failed:
            raise RuntimeError(f"checkpoint commit failed on rank 0 "
                               f"({self.directory})")

    def save(self, step: int, tree: Any, metadata: Optional[dict] = None,
             blocking: bool = True):
        self.wait()  # one in-flight save at a time
        if not self._writer:
            self._pending = True
            if blocking:
                self.wait()
            return
        self._pending = self.group is not None
        # device -> host copy happens here so the caller may go on
        host_leaves = _host_leaves(tree)

        def _do():
            try:
                _write(self._path(step), host_leaves,
                       {**(metadata or {}), "step": step}, 0)
                self._gc()
            except Exception as e:  # surfaces on next wait()
                self._error = e

        if blocking:
            _do()
            self.wait()
        else:
            self._thread = threading.Thread(target=_do, daemon=True)
            self._thread.start()

    def restore(self, like: Any, step: Optional[int] = None):
        step = step if step is not None else self.latest_step()
        if step is None:
            return None, None
        tree = load_pytree(self._path(step), like)
        return step, tree

    def restore_sharded(self, like: Any, specs: Any, mesh, rank: int,
                        step: Optional[int] = None):
        """Elastic restore: each leaf as the slice the rank at flat `rank`
        of `mesh` holds under its spec (`specs`, a tree matching `like`;
        `distributed.sharding.shard_of`'s slice), read from the stored
        array alone, on the device of `like`'s leaf.  `like` gives the
        global shapes.  A checkpoint written under one mesh loads onto any
        other, because its content is global."""
        from repro_torch.distributed.sharding import (mesh_coords,
                                                      shard_slices)

        step = step if step is not None else self.latest_step()
        if step is None:
            return None, None
        spec_of = {}
        map_named(lambda name, s: spec_of.__setitem__(name, s), specs)
        coords = mesh_coords(mesh, rank)

        def place(name, stored, leaf):
            sl = shard_slices(stored.arr.shape, spec_of[name], coords, mesh)
            return stored.read(sl).to(leaf.device)

        return step, _load_tree(self._path(step), like, place)

    def _gc(self):
        steps = self.steps()
        for s in steps[:-self.keep] if self.keep else []:
            shutil.rmtree(self._path(s), ignore_errors=True)
        # clean stale tmp dirs from crashed writers
        for d in os.listdir(self.directory):
            if d.endswith(".tmp"):
                shutil.rmtree(os.path.join(self.directory, d),
                              ignore_errors=True)
