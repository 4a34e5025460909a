"""Data parallelism across processes: the port's counterpart of the
reference's multi-process start (`jax.distributed.initialize` in
`repro.launch.train`) and of the collectives that GSPMD inserts for data
parallelism.

    torchrun --nproc-per-node 2 -m repro_torch.launch.train ... \
        --dist-backend gloo

`DataParallel.start` reads `torch.distributed.run`'s environment
(``RANK``, ``WORLD_SIZE``, ``LOCAL_RANK``, ``LOCAL_WORLD_SIZE``,
``MASTER_ADDR``, ``MASTER_PORT``) and joins the group with the backend
asked for; nothing is switched quietly.  Rank r runs on
``cuda:LOCAL_RANK``; where a host has more ranks than cards they share
them (``LOCAL_RANK % device_count``), which only ``gloo`` accepts:
``nccl`` needs one card a rank and raises.  A CPU run needs ``gloo``.

The collectives a data-parallel step needs, each in as few calls as the
data allows:
  * `all_reduce_grads`: the gradients summed over the ranks in float32,
    bucketed (one flat buffer a bucket of at most `BUCKET_BYTES`, not one
    call a leaf);
  * `broadcast_`: rank 0's params to every rank at start, one flat buffer
    a dtype (as bytes);
  * `gather`: ZeRO-1's all-gather of the params from every rank's shard.
    ``gloo`` gives CUDA tensors only ``all_reduce`` and ``broadcast``, so
    it is one broadcast from each owner of its shards (as bytes): each
    shard moves once and no value is added to another, so the whole
    tensor is bit-equal to the shards;
  * `mean_over_ranks`: a statistic averaged over the ranks inside the
    model (the MoE's load-balancing terms, `models.moe.route`).
"""
from __future__ import annotations

import contextlib
import math
import os
from typing import Optional

import torch
import torch.distributed as dist

from repro_torch._device import resolve_device
from repro_torch.distributed.sharding import (_axes_of, all_coords,
                                              shard_slices)
from repro_torch.tree import map_named, named_leaves

BACKENDS = ("nccl", "gloo")
BUCKET_BYTES = 2 ** 28


def world_size() -> int:
    """``WORLD_SIZE`` of the environment (1 when unset)."""
    return int(os.environ.get("WORLD_SIZE", "1"))


def rank_device(local_rank: int, local_world: int, backend: str,
                device="cuda") -> torch.device:
    """The device of the rank with `local_rank` among `local_world` ranks
    of its host: ``cuda:local_rank % device_count``, or the CPU when asked
    for.  Raises where the backend cannot run there: ``nccl`` on the CPU,
    or with more ranks than cards on the host."""
    if backend not in BACKENDS:
        raise ValueError(f"backend {backend!r}: expected one of {BACKENDS}")
    dev = resolve_device(device)
    if dev.type == "cpu":
        if backend == "nccl":
            raise ValueError("nccl runs on cards only; a CPU run takes "
                             "--dist-backend gloo")
        return dev
    if dev.type != "cuda":
        raise ValueError(f"device {str(device)!r}: ranks run on cuda or cpu")
    n = torch.cuda.device_count()
    if backend == "nccl" and local_world > n:
        raise ValueError(
            f"nccl needs one card a rank: {local_world} ranks on this host, "
            f"{n} card(s); gloo lets ranks share a card "
            "(--dist-backend gloo)")
    return torch.device("cuda", local_rank % n)


def spawn_ranks(fn, world: int, args=(), rank_args=None, env=None,
                timeout: float = 600.0) -> list:
    """[fn(rank, *args, *rank_args[rank]) for each of `world` ranks], each
    in a process of its own (spawn) with `torch.distributed.run`'s
    environment for one host (``RANK``, ``WORLD_SIZE``, ``LOCAL_RANK``,
    ``LOCAL_WORLD_SIZE``) and `env` set; `fn` joins the group itself
    (`DataParallel.start`).  Raises the first failed rank's traceback, or
    after `timeout` seconds without a result; ends every process it
    started."""
    import multiprocessing as mp
    import queue

    ctx = mp.get_context("spawn")
    q = ctx.Queue()
    procs = [ctx.Process(target=_spawned, args=(
        fn, r, world, dict(env or {}),
        tuple(args) + tuple((rank_args or {}).get(r, ())), q))
        for r in range(world)]
    for p in procs:
        p.start()
    results, done = {}, False
    try:
        while len(results) < world:
            try:
                rank, ok, out = q.get(timeout=timeout)
            except queue.Empty:
                raise TimeoutError(f"{getattr(fn, '__name__', fn)}: "
                                   f"{world - len(results)} rank(s) silent "
                                   f"after {timeout:g} s") from None
            if not ok:
                raise RuntimeError(f"{getattr(fn, '__name__', fn)} rank "
                                   f"{rank} failed:\n{out}")
            results[rank] = out
        done = True
    finally:
        for p in procs:
            p.join(timeout=60 if done else 1)
            if p.is_alive():
                p.terminate()
                p.join(timeout=30)
    return [results[r] for r in range(world)]


def _spawned(fn, rank, world, env, args, q):
    """One rank of `spawn_ranks`: (rank, ok, result or traceback) on
    `q`."""
    import traceback

    os.environ.update(RANK=str(rank), WORLD_SIZE=str(world),
                      LOCAL_RANK=str(rank), LOCAL_WORLD_SIZE=str(world),
                      **env)
    try:
        q.put((rank, True, fn(rank, *args)))
    except BaseException:
        q.put((rank, False, traceback.format_exc()))


def _flat_bytes(tensors) -> torch.Tensor:
    """The tensors' bytes end to end, one uint8 tensor."""
    return torch.cat([t.contiguous().reshape(-1).view(torch.uint8)
                      for t in tensors])


class DataParallel:
    """This process's place in a data-parallel group (`rank` of `world`,
    on `device`) and the collectives over it.  `start` joins a group, or
    takes the one already started in this process (then `close` leaves it
    to its owner)."""

    def __init__(self, rank: int, world: int, device: torch.device,
                 backend: str, owned: bool = False):
        self.rank, self.world = rank, world
        self.device, self.backend, self.owned = device, backend, owned

    @classmethod
    def start(cls, backend: str = "nccl", device="cuda"):
        env = os.environ
        world = world_size()
        rank = int(env.get("RANK", "0"))
        local_rank = int(env.get("LOCAL_RANK", str(rank)))
        local_world = int(env.get("LOCAL_WORLD_SIZE", str(world)))
        dev = rank_device(local_rank, local_world, backend, device)
        if dev.type == "cuda":
            torch.cuda.set_device(dev)
        owned = not dist.is_initialized()
        if owned:
            dist.init_process_group(backend, rank=rank, world_size=world)
        elif (dist.get_rank(), dist.get_world_size()) != (rank, world) or \
                dist.get_backend() != backend:
            raise RuntimeError(
                f"a process group is running as rank {dist.get_rank()} of "
                f"{dist.get_world_size()} over {dist.get_backend()}, not "
                f"rank {rank} of {world} over {backend}")
        return cls(rank, world, dev, backend, owned)

    def close(self):
        if self.owned and dist.is_initialized():
            dist.destroy_process_group()

    # -- small collectives ------------------------------------------------
    def sum(self, x) -> torch.Tensor:
        """x (a number or a tensor on this rank's device) summed over the
        ranks, float32."""
        t = torch.as_tensor(x, dtype=torch.float32,
                            device=self.device).detach().clone()
        dist.all_reduce(t)
        return t

    def max(self, x) -> torch.Tensor:
        t = torch.as_tensor(x, dtype=torch.float32,
                            device=self.device).detach().clone()
        dist.all_reduce(t, op=dist.ReduceOp.MAX)
        return t

    # -- trees ------------------------------------------------------------
    def all_reduce_grads(self, grads: dict) -> dict:
        """`grads` summed over the ranks, each leaf float32: the leaves go
        in order into flat float32 buckets of at most `BUCKET_BYTES` (a
        larger leaf alone), one all-reduce a bucket; the sum is rounded
        once, to float32 (ROADMAP C2)."""
        leaves = named_leaves(grads)
        out, bucket, size = {}, [], 0

        def flush():
            flat = torch.cat([g.reshape(-1).float() for _, g in bucket])
            dist.all_reduce(flat)
            for (name, g), part in zip(bucket, flat.split(
                    [g.numel() for _, g in bucket])):
                out[name] = part.view(g.shape)

        for name, g in leaves:
            if bucket and size + 4 * g.numel() > BUCKET_BYTES:
                flush()
                bucket, size = [], 0
            bucket.append((name, g))
            size += 4 * g.numel()
        if bucket:
            flush()
        return map_named(lambda name, g: out[name], grads)

    def broadcast_(self, tree, src: int = 0):
        """Every leaf of `tree` (tensors on this rank's device) set to
        rank `src`'s, in place: one broadcast a dtype, as bytes."""
        by_dtype = {}
        for _, t in named_leaves(tree):
            by_dtype.setdefault(t.dtype, []).append(t)
        for ts in by_dtype.values():
            flat = _flat_bytes(ts)
            dist.broadcast(flat, src=src)
            for t, part in zip(ts, flat.split(
                    [t.numel() * t.element_size() for t in ts])):
                t.copy_(part.view(t.dtype).view(t.shape))
        return tree

    def gather(self, shards, specs, mesh, shapes) -> dict:
        """The whole tree from every rank's shards: `shards` this rank's
        (a tree), `specs` and `shapes` (whole shapes) trees of the same
        structure.  A leaf whose spec splits over no axis of size > 1 is
        the same on every rank and stays as it is; the others come in one
        broadcast from each owner of its shards (the first rank holding
        each distinct slice), as bytes."""
        spec_of = dict(named_leaves(specs))
        shape_of = dict(named_leaves(shapes))
        mine = named_leaves(shards)
        mine_of = dict(mine)
        coords = all_coords(mesh)
        out = {}

        def split(name):
            return any(mesh.shape[a] > 1 for a in _axes_of_spec(
                spec_of[name]))

        for name, s in mine:
            out[name] = (s.new_empty(tuple(shape_of[name])) if split(name)
                         else s)
        for owner, c in enumerate(coords):
            held = [n for n, _ in mine if split(n) and _first_holder(
                spec_of[n], c, mesh)]
            if not held:
                continue
            slices = [shard_slices(shape_of[n], spec_of[n], c, mesh)
                      for n in held]
            dims = [[s.stop - s.start for s in sl] for sl in slices]
            nbytes = [math.prod(d) * out[n].element_size()
                      for d, n in zip(dims, held)]
            flat = (_flat_bytes([mine_of[n] for n in held])
                    if owner == self.rank else
                    torch.empty(sum(nbytes), dtype=torch.uint8,
                                device=self.device))
            dist.broadcast(flat, src=owner)
            for n, sl, d, part in zip(held, slices, dims,
                                      flat.split(nbytes)):
                out[n][sl] = part.view(out[n].dtype).view(d)
        return map_named(lambda name, _: out[name], shards)


def _axes_of_spec(spec) -> tuple:
    return tuple(a for e in spec for a in _axes_of(e))


def _first_holder(spec, coords: dict, mesh) -> bool:
    """Whether the rank at `coords` is the first to hold its slice of a
    leaf with `spec`: its index is 0 on every axis the spec does not
    split over."""
    used = set(_axes_of_spec(spec))
    return all(coords[a] == 0 for a in mesh.shape if a not in used)


# ---------------------------------------------------------------------------
# Statistics averaged inside the model
# ---------------------------------------------------------------------------

# The group whose ranks `mean_over_ranks` averages over, set by
# `reducing` for a data-parallel step.  A process-wide setting, not a
# context variable: remat's recompute runs the forward again inside the
# backward, on autograd's own thread for a card, and must average there
# too.  The reference keeps its MoE group count the same way
# (`runtime.MOE_DP_GROUPS`).
_REDUCING: Optional[DataParallel] = None


@contextlib.contextmanager
def reducing(group: Optional[DataParallel]):
    """`mean_over_ranks` averages over `group` inside the block."""
    global _REDUCING
    prev, _REDUCING = _REDUCING, group
    try:
        yield
    finally:
        _REDUCING = prev


class _MeanOverRanks(torch.autograd.Function):
    """The mean over the ranks of x.  Every rank holds the same mean and
    gets the same gradient of it, and the ranks' gradients are summed
    afterwards (`all_reduce_grads`); so each rank's x gets the mean's
    gradient over the rank count, with no collective in the backward."""

    @staticmethod
    def forward(ctx, x, group):
        ctx.world = group.world
        out = x.detach().float().clone()
        dist.all_reduce(out)
        return (out / group.world).to(x.dtype)

    @staticmethod
    def backward(ctx, grad):
        return grad / ctx.world, None


def mean_over_ranks(x: torch.Tensor) -> torch.Tensor:
    """x averaged over the ranks of the group `reducing` set (x itself
    outside one).  Each rank's x is its own tokens' statistic, so with
    equal token counts the mean is the global batch's."""
    group = _REDUCING
    if group is None or group.world == 1:
        return x
    return _MeanOverRanks.apply(x, group)


__all__ = ["BACKENDS", "BUCKET_BYTES", "DataParallel", "mean_over_ranks",
           "rank_device", "reducing", "spawn_ranks", "world_size"]
