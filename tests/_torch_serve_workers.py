"""Rank processes for `tests/test_torch_serve_tp.py`, `tests/test_torch_
fsdp.py` and `tests/test_torch_dryrun.py`: serving and FSDP training on
a (data, model) mesh of ``gloo`` CPU ranks, started by
`_torch_dp_workers.run_ranks`.  This module imports no JAX, so a rank
starts with torch and the port only.
"""
import dataclasses

import numpy as np
import torch

from _torch_dp_workers import F32, _np, f32_reduced, run_ranks  # noqa: F401


def prompts(cfg, batch: int, plen: int, seed: int):
    """A serving batch of `batch` prompts of `plen` tokens from numpy's
    seeded generator, in the family's layout (whisper's stub frame
    embeddings beside its tokens, 4 frames a token)."""
    rng = np.random.default_rng(seed)
    toks = rng.integers(1, cfg.vocab_size, (batch, plen)).astype(np.int32)
    out = {"tokens": torch.as_tensor(toks)}
    if cfg.family == "encdec":
        out["frame_embeds"] = torch.as_tensor(
            rng.standard_normal((batch, 4 * plen, cfg.d_model)).astype(
                np.float32))
    return out


def generate(cfg, params, batch, max_len, n_decode, rules=None):
    """The prefill step and `n_decode` decode steps with logits
    (`launch.steps`, `with_logits`), float32 caches (float64 for a float64
    model): ([next tokens], [logits]) each step's as numpy, global over
    the batch.  (With the default bf16 caches a float32 difference of a
    rounding flips a cache entry's bf16 rounding now and then, and the
    logits move by 1e-4 of their max.)"""
    from repro_torch.launch import steps
    from repro_torch.models import layers as L

    prefill = steps.make_prefill_step(
        cfg, max_len, rules, with_logits=True,
        cache_dtype=L.compute_dtype(L.act_dtype_of(cfg)))
    decode = steps.make_decode_step(cfg, rules, with_logits=True)
    tok, cache, logits = prefill(params, batch)
    toks, outs = [tok.numpy()], [logits.numpy()]
    for _ in range(n_decode):
        tok, cache, logits = decode(params, tok, cache)
        toks.append(tok.numpy())
        outs.append(logits.numpy())
    return toks, outs


def rank_params(cfg, rules, mesh, rank, shape=None):
    """(this rank's shards of `api.init(0)`'s params, the whole params)."""
    from repro_torch.distributed.sharding import mesh_coords, shard_of
    from repro_torch.models import api
    from repro_torch.tree import tree_map

    whole = api.init(0, cfg, shape, device="cpu")
    coords = mesh_coords(mesh, rank)
    return tree_map(lambda p, s: shard_of(p, s, coords, mesh), whole,
                    rules.param_pspecs(whole)), whole


def _started():
    from repro_torch.distributed.process_group import DataParallel
    return DataParallel.start("gloo", "cpu")


def serve(rank, world, model, cases, max_len, n_decode):
    """On a (world / model, model) mesh, each case (key, arch, batch,
    prompt length, config overrides): the float32 REDUCED model from
    `api.init(0)`, this rank's shards, the prefill and `n_decode` decode
    steps with rules on the same global batch (`prompts`, seed 0); also
    the engine (`GenerationEngine(rules=)`) on the same prompts.  Every
    rank's tokens, rank 0's logits."""
    from repro_torch.distributed import ShardingRules
    from repro_torch.launch.mesh import make_host_mesh
    from repro_torch.serving.engine import GenerationEngine, Request

    group = _started()
    mesh = make_host_mesh(model=model, group=group)
    out = {}
    for key, name, batch, plen, over in cases:
        cfg = dataclasses.replace(f32_reduced(name), **over)
        rules = ShardingRules(mesh=mesh, cfg=cfg)
        params, _ = rank_params(cfg, rules, mesh, rank)
        toks, logits = generate(cfg, params, prompts(cfg, batch, plen, 0),
                                max_len, n_decode, rules)
        res = {"tokens": toks, "logits": logits if rank == 0 else None}
        if cfg.family not in ("encdec", "vlm"):
            eng = GenerationEngine(params, cfg, max_len, batch, "cpu",
                                   rules=rules)
            reqs = [Request(prompt=p.numpy(), max_new_tokens=n_decode + 1)
                    for p in prompts(cfg, batch, plen, 0)["tokens"]]
            res["engine"] = [r.output for r in eng.generate(reqs)]
        out[key] = res
    return out


def fsdp_steps(rank, world, model, cases, seq, batch, n_steps, lr,
               fsdp_min):
    """On a (world / model, model) mesh, each case (key, arch, config
    overrides): the float32 REDUCED model, FSDP rules (``fsdp=True``,
    with `sharding.FSDP_MIN` set to `fsdp_min` in this rank: the
    reference's 1024 leaves nothing to split at REDUCED widths), this
    rank's shards of the params and of the
    optimizer state (`opt_pspecs`), `n_steps` train steps on the rows of
    its data coordinate; per step the metrics, the collectives by class,
    and for step 0 the summed gradient and the params after it gathered
    whole; how many leaves FSDP splits.  Rank 0's arrays only."""
    from repro_torch.configs.base import ShapeConfig
    from repro_torch.data.pipeline import rank_batch
    from repro_torch.distributed import ShardingRules, sharding
    from repro_torch.distributed.process_group import (DataParallel,
                                                       collective_counts)
    from repro_torch.launch import steps
    from repro_torch.launch.mesh import make_host_mesh
    from repro_torch.optim import AdamWConfig
    from repro_torch.optim.adamw import zero1_init
    from repro_torch.tree import tree_leaves, tree_map

    group = DataParallel.start("gloo", "cpu")
    mesh = make_host_mesh(model=model, group=group)
    data = mesh.axis_groups["data"]
    summed, sum_grads = [], steps._sum_grads

    def recording_sum(*a, **kw):
        out = sum_grads(*a, **kw)
        summed.append(out)
        return out

    steps._sum_grads = recording_sum
    sharding.FSDP_MIN = fsdp_min
    out = {}
    try:
        for key, name, over in cases:
            cfg = dataclasses.replace(f32_reduced(name), **over)
            shape = ShapeConfig("t", seq, batch, "train")
            rules = ShardingRules(mesh=mesh, cfg=cfg, fsdp=True)
            params, whole = rank_params(cfg, rules, mesh, rank, shape)
            pspecs = rules.param_pspecs(whole)
            shapes = tree_map(lambda p: tuple(p.shape), whole)
            opt = zero1_init(whole, steps.zero1_specs(rules, whole), mesh,
                             rank)
            del whole
            step = steps.make_train_step(
                cfg, AdamWConfig(lr=lr, warmup_steps=1, total_steps=10),
                rules)
            runs = []
            for s in range(n_steps):
                summed.clear()
                b = rank_batch(cfg, shape, s, data.rank, data.world,
                               device="cpu")
                counts = collective_counts()
                for g in (group, *mesh.axis_groups.values()):
                    g.collectives = counts
                params, opt, m = step(params, opt, b)
                counts = {k: dict(v) for k, v in counts.items()}
                grads = after = None
                if s == 0:
                    grads = group.gather(summed[0], pspecs, mesh, shapes)
                    after = group.gather(params, pspecs, mesh, shapes)
                keep = rank == 0 and s == 0
                runs.append({
                    "metrics": {k: float(v) for k, v in m.items()},
                    "grads": _np(grads) if keep else None,
                    "params": _np(after) if keep else None,
                    "collectives": counts})
            split = sum("data" in str(sp) for sp in tree_leaves(pspecs))
            out[key] = {"runs": runs, "fsdp_leaves": split}
    finally:
        steps._sum_grads = sum_grads
    return out


def serve_meshes(rank, world, runs, max_len, n_decode):
    """`serve` on each mesh of `runs` ([(model, cases)]) in turn, in one
    group: {model axis: its results}."""
    return {model: serve(rank, world, model, cases, max_len, n_decode)
            for model, cases in runs}


def step_args(cfg, shape, rules, mesh, rank, device="cpu"):
    """(params, opt state, batch) of this rank for a train step, or
    (params, batch) for a prefill, made for real from `api.init(0)` on
    `device` as `launch.dryrun.lower_cell` makes them on ``meta``."""
    from repro_torch.data.pipeline import make_batch
    from repro_torch.launch import dryrun, steps
    from repro_torch.optim.adamw import zero1_init

    params, whole = rank_params(cfg, rules, mesh, rank, shape)
    if shape.kind == "train":
        opt = zero1_init(whole, steps.zero1_specs(rules, whole), mesh, rank)
        batch = make_batch(cfg, shape, step=0, device=device)
        return params, opt, dryrun._rows(batch, rules, rank)
    plen = shape.seq_len // (4 if cfg.family == "encdec" else 1)
    return params, prompts(cfg, shape.global_batch, plen, 0)


def recorded_steps(rank, world, model, cells):
    """On a (world / model, model) mesh, for each cell (key, arch, kind,
    seq, batch): the step `launch.dryrun.lower_cell` traces (its
    `build_rules`), run for real on the REDUCED float32 model; a decode
    cell's cache made by the prefill step first.  This rank's collectives
    of the step by class (`DataParallel.collectives`)."""
    from repro_torch.configs.base import ShapeConfig
    from repro_torch.launch import dryrun, steps
    from repro_torch.launch.mesh import make_host_mesh
    from repro_torch.optim import AdamWConfig

    group = _started()
    mesh = make_host_mesh(model=model, group=group)
    out = {}
    for key, name, kind, seq, batch in cells:
        cfg = f32_reduced(name)
        shape = ShapeConfig("t", seq, batch, kind)
        rules = dryrun.build_rules(cfg, mesh, False)
        if kind == "train":
            step = steps.make_train_step(cfg, AdamWConfig(), rules)
            args = step_args(cfg, shape, rules, mesh, rank)
        elif kind == "prefill":
            step = steps.make_prefill_step(cfg, seq, rules)
            args = step_args(cfg, shape, rules, mesh, rank)
        else:
            params, prompt = step_args(cfg, dataclasses.replace(
                shape, kind="prefill", seq_len=seq // 2), rules, mesh, rank)
            tok, cache = steps.make_prefill_step(cfg, seq, rules)(params,
                                                                  prompt)
            step, args = steps.serve_step(cfg, rules), (params, tok, cache)
        trace = dryrun.trace_step(step, args, group)
        out[key] = trace.collectives
    return out
