"""Rank processes for `tests/test_torch_dp.py`: `run_ranks` starts
`world` CPU processes (spawn), each joining one ``gloo`` group through a
rendezvous file, and runs a function of this module in each.  This
module imports no JAX, so a rank starts with torch and the port only.
"""
import datetime

import torch
import torch.distributed as dist

from repro_torch.distributed.process_group import spawn_ranks

F32 = dict(param_dtype="float32", activation_dtype="float32")


def run_ranks(fn, world: int, rdzv: str, args=(), rank_args=None,
              timeout: float = 120.0) -> list:
    """[fn(rank, world, *args, *rank_args[rank]) for each rank], each run
    in its own spawned process (`process_group.spawn_ranks`) with one
    intra-op thread; raises the first rank's error, or after `timeout`
    seconds."""
    return spawn_ranks(_in_group, world, (fn, world, rdzv), {
        r: (tuple(args) + tuple((rank_args or {}).get(r, ())),)
        for r in range(world)}, timeout=timeout)


def _in_group(rank, fn, world, rdzv, args):
    """fn(rank, world, *args) in the gloo group at the file `rdzv`."""
    torch.set_num_threads(1)
    dist.init_process_group("gloo", init_method=f"file://{rdzv}",
                            rank=rank, world_size=world,
                            timeout=datetime.timedelta(seconds=60))
    try:
        return fn(rank, world, *args)
    finally:
        dist.destroy_process_group()


def _np(tree):
    """A tree of tensors as numpy (dicts kept, NamedTuples as dicts)."""
    if isinstance(tree, dict):
        return {k: _np(v) for k, v in tree.items()}
    if isinstance(tree, tuple) and hasattr(tree, "_fields"):
        return {f: _np(getattr(tree, f)) for f in tree._fields}
    return tree.detach().float().numpy() if tree.dtype == torch.bfloat16 \
        else tree.detach().numpy()


def f32_reduced(name):
    """The REDUCED config of `name` in float32."""
    import dataclasses

    from repro_torch import configs
    return dataclasses.replace(configs.get_reduced(name), **F32)


def dp_steps(rank, world, names, seq, batch, n_steps, lr):
    """For each arch in `names` (float32 REDUCED, params `api.init(0)`):
    `n_steps` data-parallel steps (`launch.steps.make_train_step` with
    rules over the group) on the global batch (seq x batch, this rank's
    rows); per step the metrics, and on rank 0 the reduced gradient and
    the ZeRO-1 state gathered whole; then the data-parallel eval step's
    CE on the batch of step `n_steps`.  Also the bucketed all-reduce of a
    random tree at a 64-byte bucket and at the default against its
    plain sum."""
    from repro_torch.configs.base import ShapeConfig
    from repro_torch.data.pipeline import rank_batch
    from repro_torch.distributed import ShardingRules
    from repro_torch.distributed import process_group
    from repro_torch.distributed.process_group import DataParallel
    from repro_torch.launch import steps
    from repro_torch.launch.mesh import make_host_mesh
    from repro_torch.models import api
    from repro_torch.optim import AdamWConfig
    from repro_torch.optim.adamw import zero1_gather_state, zero1_init
    from repro_torch.tree import tree_leaves, tree_map

    group = DataParallel.start("gloo", "cpu")
    mesh = make_host_mesh(group=group)
    reduced = []
    record = DataParallel.all_reduce_grads

    def recording(self, grads, *a, **kw):
        out = record(self, grads, *a, **kw)
        reduced.append(out)
        return out

    DataParallel.all_reduce_grads = recording
    out = {}
    for name in names:
        cfg = f32_reduced(name)
        shape = ShapeConfig("t", seq, batch, "train")
        rules = ShardingRules(mesh=mesh, cfg=cfg)
        params = api.init(0, cfg, shape, device="cpu")
        specs = steps.zero1_specs(rules, params)
        shapes = tree_map(lambda p: tuple(p.shape), params)
        opt = zero1_init(params, specs, mesh, rank)
        step = steps.make_train_step(
            cfg, AdamWConfig(lr=lr, warmup_steps=1, total_steps=10), rules)
        runs = []
        for s in range(n_steps):
            reduced.clear()
            batch_ = rank_batch(cfg, shape, s, rank, world, device="cpu")
            params, opt, m = step(params, opt, batch_)
            full = zero1_gather_state(opt, specs, group, mesh, shapes)
            runs.append({"metrics": {k: float(v) for k, v in m.items()},
                         "grads": _np(reduced[0]) if rank == 0 else None,
                         "state": _np(full) if rank == 0 else None,
                         "params": _np(params) if rank == 0 else None,
                         "shard_numel": sum(t.numel() for t in
                                            tree_leaves(opt.master))})
        ev = steps.make_eval_step(cfg, rules)(
            params, rank_batch(cfg, shape, n_steps, rank, world,
                               device="cpu"))
        out[name] = {"runs": runs, "eval": float(ev)}
    DataParallel.all_reduce_grads = record
    gen = torch.Generator().manual_seed(rank)
    tree = {"a": torch.randn(3, 5, generator=gen),
            "b": {"c": torch.randn(7, generator=gen),
                  "d": torch.randn(2, 2, generator=gen)}}
    default = _np(group.all_reduce_grads(tree))
    process_group.BUCKET_BYTES = 64
    out["buckets"] = {"tree": _np(tree), "default": default,
                      "small": _np(group.all_reduce_grads(tree))}
    return out


def cli(rank, world, argv, f32=True):
    """`launch.train.main(argv)` in this rank (REDUCED configs in float32
    when `f32`); its exit code."""
    import dataclasses

    from repro_torch import configs
    from repro_torch.launch import train

    if f32:
        get = configs.get_reduced
        configs.get_reduced = lambda n: dataclasses.replace(get(n), **F32)
    return train.main(argv)
