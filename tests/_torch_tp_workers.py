"""Rank processes for `tests/test_torch_tp.py`: tensor and expert
parallelism on a (data, model) mesh of ``gloo`` CPU ranks, started by
`_torch_dp_workers.run_ranks`.  This module imports no JAX, so a rank
starts with torch and the port only.
"""
import dataclasses

import torch

from _torch_dp_workers import _np, f32_reduced, run_ranks  # noqa: F401


def tp_steps(rank, world, model, cases, seq, batch, n_steps, lr):
    """On a (world / model, model) mesh, for each case (key, arch,
    config overrides): the float32 REDUCED model from `api.init(0)`
    (whole, then each rank's `shard_of` it), `n_steps` train steps
    (`launch.steps.make_train_step` with rules) on the global batch (seq
    x batch, the rows of this rank's data coordinate); per step the
    metrics, and for step 0 the summed gradient gathered whole; the
    params after the steps gathered whole; the eval step's CE on the
    batch of step `n_steps`; and the MoE's dropped (token, choice)
    entries in the steps' first dispatch.  Rank 0's arrays only."""
    from repro_torch.configs.base import ShapeConfig
    from repro_torch.data.pipeline import rank_batch
    from repro_torch.distributed import ShardingRules
    from repro_torch.distributed.process_group import DataParallel
    from repro_torch.distributed.sharding import mesh_coords, shard_of
    from repro_torch.launch import steps
    from repro_torch.launch.mesh import make_host_mesh
    from repro_torch.models import api, moe
    from repro_torch.optim import AdamWConfig
    from repro_torch.optim.adamw import zero1_init
    from repro_torch.tree import tree_leaves, tree_map

    group = DataParallel.start("gloo", "cpu")
    mesh = make_host_mesh(model=model, group=group)
    data = mesh.axis_groups["data"]
    coords = mesh_coords(mesh, rank)
    summed, drops = [], []
    sum_grads, dispatch = steps._sum_grads, moe.dispatch

    def recording_sum(*a, **kw):
        out = sum_grads(*a, **kw)
        summed.append(out)
        return out

    def counting_dispatch(*a, **kw):
        d = dispatch(*a, **kw)
        drops.append(int((~d.keep).sum()))
        return d

    steps._sum_grads, moe.dispatch = recording_sum, counting_dispatch
    out = {}
    try:
        for key, name, over in cases:
            cfg = dataclasses.replace(f32_reduced(name), **over)
            shape = ShapeConfig("t", seq, batch, "train")
            rules = ShardingRules(mesh=mesh, cfg=cfg)
            whole = api.init(0, cfg, shape, device="cpu")
            pspecs = rules.param_pspecs(whole)
            shapes = tree_map(lambda p: tuple(p.shape), whole)
            opt = zero1_init(whole, steps.zero1_specs(rules, whole), mesh,
                             rank)
            params = tree_map(lambda p, s: shard_of(p, s, coords, mesh),
                              whole, pspecs)
            step = steps.make_train_step(
                cfg, AdamWConfig(lr=lr, warmup_steps=1, total_steps=10),
                rules)
            runs = []
            drops.clear()
            for s in range(n_steps):
                summed.clear()
                b = rank_batch(cfg, shape, s, data.rank, data.world,
                               device="cpu")
                params, opt, m = step(params, opt, b)
                grads = (group.gather(summed[0], pspecs, mesh, shapes)
                         if s == 0 else None)
                runs.append({
                    "metrics": {k: float(v) for k, v in m.items()},
                    "grads": _np(grads) if rank == 0 and s == 0 else None})
            first_drops = drops[0] if drops else 0
            gathered = group.gather(params, pspecs, mesh, shapes)
            ev = steps.make_eval_step(cfg, rules)(
                params, rank_batch(cfg, shape, n_steps, data.rank,
                                   data.world, device="cpu"))
            out[key] = {
                "runs": runs, "eval": float(ev), "drops": first_drops,
                "params": _np(gathered) if rank == 0 else None,
                "split": sum(p.numel() < w.numel() for p, w in zip(
                    tree_leaves(params), tree_leaves(whole)))}
    finally:
        steps._sum_grads, moe.dispatch = sum_grads, dispatch
    return out
