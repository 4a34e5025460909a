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

The reference's `restore_sharded` (placing leaves on a mesh's shardings)
waits for the port's sharding layer (ROADMAP A9b) and is left out.
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

MANIFEST = "MANIFEST.json"


def _map_named(fn, tree, prefix=()):
    """`tree` with each leaf replaced by fn(name, leaf), visiting leaves
    in the reference's flattening order."""
    if isinstance(tree, dict):
        out = {k: _map_named(fn, tree[k], prefix + (str(k),))
               for k in sorted(tree)}
        return {k: out[k] for k in tree}
    if isinstance(tree, tuple) and hasattr(tree, "_fields"):
        return type(tree)(*(_map_named(fn, getattr(tree, f), prefix + (f,))
                            for f in tree._fields))
    return fn("/".join(prefix), tree)


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
    _map_named(lambda name, leaf: out.append((name, *_to_host(leaf))), tree)
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


def _load_leaf(path: str, entry: dict) -> torch.Tensor:
    arr = np.load(os.path.join(path, entry["file"]))
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


def load_pytree(path: str, like: Any):
    """Restore into the structure of `like`: each leaf a tensor on the
    device of `like`'s leaf (the CPU for a leaf that is not a tensor),
    with the checkpoint's dtype; shapes checked against `like`."""
    with open(os.path.join(path, MANIFEST)) as f:
        manifest = json.load(f)
    by_name = {e["name"]: e for e in manifest["leaves"]}

    def get(name, leaf):
        if name not in by_name:
            raise KeyError(f"checkpoint missing leaf {name!r}")
        t = _load_leaf(path, by_name[name])
        want = tuple(getattr(leaf, "shape", t.shape))
        if tuple(t.shape) != want:
            raise ValueError(f"leaf {name!r}: checkpoint shape "
                             f"{tuple(t.shape)} != expected {want}")
        return t.to(leaf.device) if torch.is_tensor(leaf) else t

    return _map_named(get, like)


def load_metadata(path: str) -> dict:
    with open(os.path.join(path, MANIFEST)) as f:
        return json.load(f)["metadata"]


class CheckpointManager:
    """Step-indexed checkpoint directory with retention + async commit."""

    def __init__(self, directory: str, keep: int = 3):
        self.directory = directory
        self.keep = keep
        os.makedirs(directory, exist_ok=True)
        self._thread: Optional[threading.Thread] = None
        self._error: Optional[BaseException] = None

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
        if self._thread is not None:
            self._thread.join()
            self._thread = None
        if self._error is not None:
            err, self._error = self._error, None
            raise err

    def save(self, step: int, tree: Any, metadata: Optional[dict] = None,
             blocking: bool = True):
        self.wait()  # one in-flight save at a time
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

    def _gc(self):
        steps = self.steps()
        for s in steps[:-self.keep] if self.keep else []:
            shutil.rmtree(self._path(s), ignore_errors=True)
        # clean stale tmp dirs from crashed writers
        for d in os.listdir(self.directory):
            if d.endswith(".tmp"):
                shutil.rmtree(os.path.join(self.directory, d),
                              ignore_errors=True)
