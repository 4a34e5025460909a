"""Data, tensor and expert parallelism across processes: the port's
counterpart of the reference's multi-process start
(`jax.distributed.initialize` in `repro.launch.train`) and of the
collectives that GSPMD inserts for a (data, model) mesh.

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
    model (the MoE's load-balancing terms, `models.moe.route`);
  * `exchange`: point-to-point messages with chosen ranks in one batch
    (`dist.batch_isend_irecv`), the sharded stencil layer's halo
    transport (`distributed.halo` on a rank's mesh).  ``nccl`` sends the
    device tensors themselves; ``gloo`` on a card stages them through
    pinned host buffers (`p2p_route` says which).

A mesh with a model axis (`launch.mesh.make_host_mesh(model=)`) cuts the
world into sub-groups (`DataParallel.axis_groups`): the ranks that differ
on the data axis alone (the gradient sum, ZeRO-1) and those that differ on
the model axis alone.  Over the latter the models run the Megatron
collectives that GSPMD inserts from the reference's specs, written out
(`model_parallel` sets the group for a step; with none set each is the
identity):
  * `copy_to_model` (Megatron's f): the identity forward, the gradient
    all-reduced backward, at the input of a column-parallel product;
  * `reduce_from_model` (g): the rank's partial sum all-reduced forward,
    the identity backward, at a row-parallel output;
  * `gather_from_model`: the ranks' blocks of a dimension put together
    (an all-reduce of a zero-padded buffer: ``gloo`` gives CUDA tensors
    no all-gather), the gradient all-reduced and cut backward;
  * `sum_over_model`: all-reduced both ways, for a sum that the ranks'
    own blocks consume (the gated RMSNorm's sum of squares);
  * `max_over_model`: a detached maximum (the vocabulary-parallel
    softmax's shift).
They reduce in the tensor's dtype: ``gloo`` reduces bf16 on the CPU and on
CUDA tensors (PERF.md).  Where a block's heads do not divide the model
axis (mamba2-130m's 24 heads on 16 ranks), `whole_from_model` gathers its
split leaves whole and every rank runs the block alike.

FSDP over the data axis (`fsdp`): a param the rules split over the data
axes as well is gathered whole where a layer starts (`fsdp_whole`, from
`models.layers.index`, inside `maybe_remat`, so a full remat gathers again
in the recompute), by `gather_from_data`: an all-gather forward, the
gradient reduce-scattered backward (each rank's part of the sum over the
data axis).  On ``gloo`` with CUDA tensors both are all-reduces of
zero-padded buffers, as `gather_from_model` is (exact).

Serving with the cache's sequence split over the data axis (a batch that
does not divide it; `kv_sequence` sets the group) takes decode attention
as a softmax split over the group (`models.layers.attention_decode`).

Every collective is counted by its logical class, the reference's
`launch.dryrun.COLLECTIVE_OPS` (all-reduce, all-gather, reduce-scatter,
all-to-all, collective-permute), with the bytes of its result on this
rank, in `DataParallel.collectives` (shared by a group's sub-groups);
`broadcast_`, the start's copy of rank 0's params, is not counted.
`RecordingGroup` is a stand-in with no processes: each collective
returns its result's shape and records it, so the dry run
(`launch.dryrun`) traces a rank of a 256- or 512-device mesh on ``meta``
tensors.
"""
from __future__ import annotations

import contextlib
import math
import os
import time
from typing import Optional

import torch
import torch.distributed as dist

from repro_torch._device import resolve_device
from repro_torch.distributed.sharding import (_axes_of_spec, all_coords,
                                              shard_slices)
from repro_torch.tree import map_named, named_leaves

BACKENDS = ("nccl", "gloo")
BUCKET_BYTES = 2 ** 28
# the reference's collective classes (`repro.launch.dryrun.COLLECTIVE_OPS`)
COLLECTIVE_OPS = ("all-gather", "all-reduce", "reduce-scatter", "all-to-all",
                  "collective-permute")


def collective_counts() -> dict:
    """Zeroed counters of the collectives by class: ``bytes`` (of each
    result on this rank) and ``counts``."""
    return {"bytes": {k: 0 for k in COLLECTIVE_OPS},
            "counts": {k: 0 for k in COLLECTIVE_OPS}}


def collective_summary(counts: dict) -> dict:
    """`counts` as the dry run reports them: ``bytes``, ``counts`` and
    ``total_bytes`` (the reference's `collective_bytes` keys)."""
    return {"bytes": dict(counts["bytes"]), "counts": dict(counts["counts"]),
            "total_bytes": int(sum(counts["bytes"].values()))}


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


def p2p_counts() -> dict:
    """Zeroed counters of `DataParallel.exchange`: bytes this rank sent
    and received, messages, calls, and (with `timing`) the host seconds
    of the wait at the barrier and of the transfer after it."""
    return {"bytes_sent": 0, "bytes_recv": 0, "messages": 0, "calls": 0,
            "wait_s": 0.0, "transfer_s": 0.0}


def _flat_bytes(tensors) -> torch.Tensor:
    """The tensors' bytes end to end, one uint8 tensor."""
    return torch.cat([t.contiguous().reshape(-1).view(torch.uint8)
                      for t in tensors])


class DataParallel:
    """This process's place in a group of ranks (`rank` of `world`, on
    `device`) and the collectives over it.  `start` joins the world's
    group, or takes the one already started in this process (then `close`
    leaves it to its owner); `axis_groups` makes its sub-groups, each
    over the global `ranks` of its members through `pg` (None: the
    world's).  A group of one rank runs no collective."""

    def __init__(self, rank: int, world: int, device: torch.device,
                 backend: str, owned: bool = False, pg=None, ranks=None):
        self.rank, self.world = rank, world
        self.device, self.backend, self.owned = device, backend, owned
        self.pg = pg
        self.ranks = list(range(world)) if ranks is None else list(ranks)
        self.timing = False
        self.p2p = p2p_counts()
        self.collectives = collective_counts()

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

    def axis_groups(self, mesh) -> dict:
        """{axis: this rank's group along `axis` of `mesh`} (this group
        the world's, `mesh.shape` counting its ranks row-major): the ranks
        whose coordinates differ from this rank's on that axis alone, in
        that axis's order.  Every rank creates every group of more than
        one rank and fewer than all (`dist.new_group`), in the same order,
        as torch.distributed requires."""
        coords = all_coords(mesh)
        if len(coords) != self.world:
            raise ValueError(f"mesh {dict(mesh.shape)} counts {len(coords)} "
                             f"ranks, the group {self.world}")
        out = {}
        for axis in mesh.shape:
            lines = {}
            for r, c in enumerate(coords):
                key = tuple(c[a] for a in mesh.shape if a != axis)
                lines.setdefault(key, []).append(r)
            for ranks in lines.values():
                pg = self.pg
                if 1 < len(ranks) < self.world:
                    pg = self._new_group(ranks)
                if self.rank in ranks:
                    out[axis] = self._sub(ranks, pg)
        return out

    def _new_group(self, ranks):
        return dist.new_group(ranks, backend=self.backend)

    def _sub(self, ranks, pg):
        """This rank's sub-group over `ranks` (counted in this group),
        sharing this group's collective counters."""
        sub = type(self)(ranks.index(self.rank), len(ranks), self.device,
                         self.backend, pg=pg,
                         ranks=[self.ranks[r] for r in ranks])
        sub.collectives = self.collectives
        return sub

    def _record(self, kind: str, nbytes: int):
        self.collectives["bytes"][kind] += int(nbytes)
        self.collectives["counts"][kind] += 1

    def _record_recvs(self, recvs):
        """An `exchange`'s messages, as one collective-permute of the bytes
        this rank receives."""
        if recvs:
            self._record("collective-permute", sum(
                math.prod(shape) * dtype.itemsize for _, shape, dtype in recvs))

    def _all_reduce(self, t: torch.Tensor, op):
        """The transport of `all_reduce_`."""
        dist.all_reduce(t, op=op, group=self.pg)

    def all_reduce_(self, t: torch.Tensor, op=dist.ReduceOp.SUM,
                    kind: str = "all-reduce", nbytes=None):
        """t reduced over the ranks in place (as it is in a group of one
        rank); returns t.  Counted as one collective of class `kind`
        moving `nbytes` (default t's) on this rank: `all_gather` and
        `reduce_scatter` go through it."""
        if self.world > 1:
            self._record(kind, t.numel() * t.element_size()
                         if nbytes is None else nbytes)
            self._all_reduce(t, op)
        return t

    def all_gather(self, x: torch.Tensor, dim: int) -> torch.Tensor:
        """The ranks' blocks of `x` along `dim` put together in rank order:
        each rank's block in a zero buffer of the whole, all-reduced
        (exact: every element is one value plus zeros; ``gloo`` gives CUDA
        tensors no all-gather).  Counted as an all-gather of the whole."""
        if self.world == 1:
            return x
        n = x.shape[dim]
        shape = list(x.shape)
        shape[dim] = n * self.world
        out = x.new_zeros(shape)
        out.narrow(dim, self.rank * n, n).copy_(x)
        return self.all_reduce_(out, kind="all-gather")

    def reduce_scatter(self, x: torch.Tensor, dim: int) -> torch.Tensor:
        """This rank's block along `dim` of `x` summed over the ranks (an
        all-reduce, then the block cut out: ``gloo`` gives CUDA tensors no
        reduce-scatter).  Counted as a reduce-scatter of the block."""
        if self.world == 1:
            return x
        full = x.contiguous().clone()
        n = full.shape[dim] // self.world
        self.all_reduce_(full, kind="reduce-scatter",
                         nbytes=full.numel() // self.world
                         * full.element_size())
        return full.narrow(dim, self.rank * n, n)

    # -- small collectives ------------------------------------------------
    def sum(self, x) -> torch.Tensor:
        """x (a number or a tensor on this rank's device) summed over the
        ranks, float32."""
        t = torch.as_tensor(x, dtype=torch.float32,
                            device=self.device).detach().clone()
        return self.all_reduce_(t)

    def max(self, x) -> torch.Tensor:
        t = torch.as_tensor(x, dtype=torch.float32,
                            device=self.device).detach().clone()
        return self.all_reduce_(t, op=dist.ReduceOp.MAX)

    # -- point to point ---------------------------------------------------
    @property
    def p2p_route(self) -> str:
        """How `exchange` moves a tensor: ``"device"`` (the tensors
        themselves: nccl on a card, gloo on the CPU) or ``"host"`` (gloo on
        a card: through pinned host buffers, since gloo sends and receives
        CPU tensors only)."""
        staged = self.backend == "gloo" and self.device.type == "cuda"
        return "host" if staged else "device"

    def exchange(self, sends, recvs, tag: int = 0) -> list:
        """One batch of point-to-point messages with other ranks of this
        group (`dist.batch_isend_irecv`): `sends` [(rank, tensor)],
        `recvs` [(rank, shape, dtype)], ranks counted in this group.
        Returns the received tensors on this rank's device, in `recvs`'
        order.  Every message of one call carries `tag`; a pair of ranks
        exchanges at most one message each way a call, or several in the
        same order on both sides, so they cannot cross.

        Counts bytes and messages in `p2p`; with `timing` set, also the
        host seconds of the wait at a barrier of the group (the other ranks'
        work before it) apart from the transfer after it, to the received
        data on the device: then every rank of the group must call, at the
        same points, as the halo exchange's callers do."""
        stats = self.p2p
        staged = self.p2p_route == "host"
        if self.timing:
            self._sync()
            t0 = time.perf_counter()
            self.max(0.0)
            t1 = time.perf_counter()
            stats["wait_s"] += t1 - t0
        self._record_recvs(recvs)
        ops, bufs = [], []
        for peer, shape, dtype in recvs:
            buf = torch.empty(tuple(shape), dtype=dtype,
                              device="cpu" if staged else self.device,
                              pin_memory=staged)
            bufs.append(buf)
            ops.append(dist.P2POp(dist.irecv, buf, self.ranks[peer],
                                  self.pg, tag))
        for peer, t in sends:
            t = t.contiguous()
            if staged:
                host = torch.empty(t.shape, dtype=t.dtype, pin_memory=True)
                host.copy_(t)
                t = host
            stats["bytes_sent"] += t.numel() * t.element_size()
            ops.append(dist.P2POp(dist.isend, t, self.ranks[peer], self.pg,
                                  tag))
        if ops:
            for req in dist.batch_isend_irecv(ops):
                req.wait()
        out = [b.to(self.device) if staged else b for b in bufs]
        stats["bytes_recv"] += sum(b.numel() * b.element_size()
                                   for b in bufs)
        stats["messages"] += len(ops)
        stats["calls"] += 1
        if self.timing:
            self._sync()
            stats["transfer_s"] += time.perf_counter() - t1
        return out

    def _broadcast(self, flat: torch.Tensor, src: int):
        """The transport of `broadcast_` and `gather`: rank `src`'s (in this
        group) `flat` to every rank."""
        dist.broadcast(flat, src=self.ranks[src], group=self.pg)

    def _sync(self):
        if self.device.type == "cuda":
            torch.cuda.synchronize(self.device)

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
            self.all_reduce_(flat)
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
        if self.world == 1:
            return tree
        by_dtype = {}
        for _, t in named_leaves(tree):
            by_dtype.setdefault(t.dtype, []).append(t)
        for ts in by_dtype.values():
            flat = _flat_bytes(ts)
            self._broadcast(flat, src)
            for t, part in zip(ts, flat.split(
                    [t.numel() * t.element_size() for t in ts])):
                t.copy_(part.view(t.dtype).view(t.shape))
        return tree

    def gather(self, shards, specs, mesh, shapes) -> dict:
        """The whole tree from every rank's shards: `shards` this rank's
        (a tree), `specs` and `shapes` (whole shapes) trees of the same
        structure, `mesh` this group's (its ranks row-major).  A leaf whose
        spec splits over no axis of size > 1 is the same on every rank and
        stays as it is; the others come in one broadcast from each owner
        of its shards (the first rank holding each distinct slice), as
        bytes."""
        if self.world == 1:
            return shards
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
            self._record("all-gather", flat.numel())
            self._broadcast(flat, owner)
            for n, sl, d, part in zip(held, slices, dims,
                                      flat.split(nbytes)):
                out[n][sl] = part.view(out[n].dtype).view(d)
        return map_named(lambda name, _: out[name], shards)


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
        out = group.all_reduce_(x.detach().float().clone())
        return (out / group.world).to(x.dtype)

    @staticmethod
    def backward(ctx, grad):
        return grad / ctx.world, None


def reducing_world() -> int:
    """The ranks of the group `reducing` set (1 outside one)."""
    return 1 if _REDUCING is None else _REDUCING.world


def mean_over_ranks(x: torch.Tensor) -> torch.Tensor:
    """x averaged over the ranks of the group `reducing` set (x itself
    outside one).  Each rank's x is its own tokens' statistic, so with
    equal token counts the mean is the global batch's."""
    group = _REDUCING
    if group is None or group.world == 1:
        return x
    return _MeanOverRanks.apply(x, group)


# ---------------------------------------------------------------------------
# Tensor and expert parallelism: the collectives over the model axis
# ---------------------------------------------------------------------------

# The model-axis group of the step running (`model_parallel`): process-wide
# for the same reason as `_REDUCING` (remat's recompute runs the forward,
# and its collectives, on autograd's thread).
_MODEL: Optional[DataParallel] = None


@contextlib.contextmanager
def model_parallel(group: Optional[DataParallel]):
    """The models' model-axis collectives run over `group` inside the
    block (None, or a group of one rank: no model axis)."""
    global _MODEL
    prev, _MODEL = _MODEL, group
    try:
        yield
    finally:
        _MODEL = prev


def model_block(local: int, whole: int) -> tuple:
    """(index, count): this rank's block of a dimension of `whole` that a
    leaf holds `local` of.  (0, 1) where it holds all of it; else the
    dimension is split over the model axis (`distributed.ShardingRules`
    cut it: block index = the rank's model coordinate), which needs the
    model group to be set and of that many ranks."""
    if local == whole:
        return 0, 1
    group = _MODEL
    if group is None or whole != local * group.world:
        raise ValueError(
            f"a leaf holds {local} of a dimension of {whole}: it is split "
            f"over a model axis, but the model group running is "
            f"{'none' if group is None else f'of {group.world} ranks'} "
            "(process_group.model_parallel)")
    return group.rank, group.world


def _model() -> Optional[DataParallel]:
    group = _MODEL
    return group if group is not None and group.world > 1 else None


class _CopyToModel(torch.autograd.Function):
    """Megatron's f: x as it is; its gradient summed over the model axis
    (each rank's is its own block's part)."""

    @staticmethod
    def forward(ctx, x, group):
        ctx.group = group
        return x.view_as(x)

    @staticmethod
    def backward(ctx, grad):
        return ctx.group.all_reduce_(grad.contiguous().clone()), None


class _ReduceFromModel(torch.autograd.Function):
    """Megatron's g: the ranks' partial sums all-reduced; the gradient as
    it is (every rank's consumer of the sum is the same)."""

    @staticmethod
    def forward(ctx, x, group):
        return group.all_reduce_(x.contiguous().clone())

    @staticmethod
    def backward(ctx, grad):
        return grad, None


class _SumOverModel(torch.autograd.Function):
    """All-reduced forward and backward: a sum each rank's own block
    consumes, so each rank's gradient of it is a part."""

    @staticmethod
    def forward(ctx, x, group):
        ctx.group = group
        return group.all_reduce_(x.contiguous().clone())

    @staticmethod
    def backward(ctx, grad):
        return ctx.group.all_reduce_(grad.contiguous().clone()), None


class _Gather(torch.autograd.Function):
    """The ranks' blocks along `dim` put together in rank order
    (`DataParallel.all_gather`).  Backward: the whole gradient summed over
    the ranks, this rank's block cut out (`reduce_scatter`): each rank's
    consumer of the whole is its own (its heads, or its rows of the
    batch)."""

    @staticmethod
    def forward(ctx, x, group, dim):
        ctx.group, ctx.dim = group, dim
        return group.all_gather(x.contiguous(), dim)

    @staticmethod
    def backward(ctx, grad):
        return ctx.group.reduce_scatter(grad, ctx.dim), None, None


class _Whole(torch.autograd.Function):
    """The ranks' blocks along `dim` put together, for a computation that
    every rank then runs alike on the whole: backward, this rank's block
    of the gradient, which every rank holds whole already (no sum)."""

    @staticmethod
    def forward(ctx, x, group, dim):
        ctx.group, ctx.dim, ctx.n = group, dim, x.shape[dim]
        return group.all_gather(x.contiguous(), dim)

    @staticmethod
    def backward(ctx, grad):
        n = ctx.n
        return grad.narrow(ctx.dim, ctx.group.rank * n, n), None, None


def copy_to_model(x: torch.Tensor) -> torch.Tensor:
    group = _model()
    return x if group is None else _CopyToModel.apply(x, group)


def reduce_from_model(x: torch.Tensor) -> torch.Tensor:
    group = _model()
    return x if group is None else _ReduceFromModel.apply(x, group)


def sum_over_model(x: torch.Tensor) -> torch.Tensor:
    group = _model()
    return x if group is None else _SumOverModel.apply(x, group)


def gather_from_model(x: torch.Tensor, dim: int) -> torch.Tensor:
    group = _model()
    return x if group is None else _Gather.apply(x, group, dim % x.dim())


def whole_from_model(x: torch.Tensor, dim: int) -> torch.Tensor:
    """x's blocks along `dim` over the model axis put together, for a
    block that every rank runs alike on the whole leaf (where its heads do
    not divide the model axis); its gradient is this rank's block of the
    whole one, with no sum."""
    group = _model()
    return x if group is None else _Whole.apply(x, group, dim % x.dim())


def max_over_model(x: torch.Tensor) -> torch.Tensor:
    """x's elementwise maximum over the model axis, detached."""
    group = _model()
    x = x.detach()
    return x if group is None else group.all_reduce_(
        x.contiguous().clone(), op=dist.ReduceOp.MAX)


# ---------------------------------------------------------------------------
# FSDP over the data axis
# ---------------------------------------------------------------------------

# The data group and the leaves it splits of the step running (`fsdp`):
# {id(storage): (weakref to it, the leaf's rank, its split dim)}.  Keyed
# by storage, so a layer's view of a stacked leaf (`layers.index`) and a
# detached copy for the gradient are found; process-wide, as `_MODEL`.
_FSDP = None


@contextlib.contextmanager
def fsdp(group: Optional[DataParallel], split):
    """Inside the block, `fsdp_whole` gathers over `group` every view of
    the leaves in `split` ([(tensor, dim)]: each split over the data axis
    along dim)."""
    import weakref

    global _FSDP
    table = {}
    for t, dim in split:
        s = t.untyped_storage()
        table[id(s)] = (weakref.ref(s), t.dim(), dim)
    prev, _FSDP = _FSDP, (group, table) if group is not None \
        and group.world > 1 and table else None
    try:
        yield
    finally:
        _FSDP = prev


def fsdp_whole(t: torch.Tensor) -> torch.Tensor:
    """`t` whole: gathered over the FSDP group where it is (a view of) a
    leaf that `fsdp` marks, as it is otherwise.  A view indexing the
    leading (layer) axes keeps the split dim less those axes."""
    state = _FSDP
    if state is None:
        return t
    group, table = state
    s = t.untyped_storage()
    entry = table.get(id(s))
    if entry is None or entry[0]() is not s:
        return t
    _, ndim, dim = entry
    return gather_from_data(t, dim - (ndim - t.dim()), group)


def gather_from_data(x: torch.Tensor, dim: int,
                     group: DataParallel) -> torch.Tensor:
    """FSDP's gather: x's blocks along `dim` over the data `group` put
    together; the gradient reduce-scattered back (each rank's rows'
    gradient of the whole leaf summed over the ranks, this rank's block
    kept)."""
    if group is None or group.world == 1:
        return x
    return _Gather.apply(x, group, dim % x.dim())


# ---------------------------------------------------------------------------
# A KV cache with its sequence split over the data axis
# ---------------------------------------------------------------------------

_KV_SEQ: Optional[DataParallel] = None


@contextlib.contextmanager
def kv_sequence(group: Optional[DataParallel]):
    """Inside the block, the attention caches hold this rank's block of
    the positions over `group` (None: all of them): position p sits on
    rank p // (capacity / ranks)."""
    global _KV_SEQ
    prev, _KV_SEQ = _KV_SEQ, group
    try:
        yield
    finally:
        _KV_SEQ = prev


def kv_sequence_group() -> Optional[DataParallel]:
    group = _KV_SEQ
    return group if group is not None and group.world > 1 else None


# ---------------------------------------------------------------------------
# A rank of a mesh with no processes: the dry run's collectives
# ---------------------------------------------------------------------------

class RecordingGroup(DataParallel):
    """A stand-in for this rank's group of `world` ranks that runs no
    process: every collective records its class and the bytes of its
    result on this rank (`collectives`, as `DataParallel` counts its own)
    and returns a tensor of its result's shape (on ``meta`` tensors:
    shapes only).  The dry run (`launch.dryrun`) traces one rank's step of
    a production mesh over it (`launch.mesh.make_rank_view`)."""

    def __init__(self, rank: int, world: int, device="meta",
                 backend: str = "record", owned: bool = False, pg=None,
                 ranks=None):
        super().__init__(rank, world, torch.device(device), backend, owned,
                         pg, ranks)

    def _new_group(self, ranks):
        return None

    def _all_reduce(self, t, op):
        pass

    def _broadcast(self, flat, src):
        pass

    def close(self):
        pass

    def exchange(self, sends, recvs, tag: int = 0) -> list:
        self._record_recvs(recvs)
        self.p2p["calls"] += 1
        self.p2p["messages"] += len(sends) + len(recvs)
        return [torch.empty(tuple(shape), dtype=dtype, device=self.device)
                for _, shape, dtype in recvs]


__all__ = ["BACKENDS", "BUCKET_BYTES", "COLLECTIVE_OPS", "DataParallel",
           "RecordingGroup", "collective_counts", "collective_summary",
           "copy_to_model", "fsdp", "fsdp_whole", "gather_from_data",
           "gather_from_model", "kv_sequence", "kv_sequence_group",
           "max_over_model", "mean_over_ranks", "model_block",
           "model_parallel", "p2p_counts", "rank_device",
           "reduce_from_model", "reducing", "reducing_world", "spawn_ranks", "sum_over_model",
           "whole_from_model", "world_size"]
