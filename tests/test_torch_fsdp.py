"""FSDP across processes (`launch.steps.make_train_step` with
``rules.fsdp``: `process_group.fsdp` / `gather_from_data` inside
`layers.maybe_remat`, the gradients' reduce-scatter, the norm's squares
summed over the data axis, AdamW on the shards in `optim.adamw`) on the
CPU: ``gloo`` ranks spawned by `_torch_serve_workers.fsdp_steps`, REDUCED
configs in float32, `ShardingRules(fsdp=True)` with the ranks'
`sharding.FSDP_MIN` set to FSDP_MIN (the reference's 1024 splits nothing
at REDUCED widths).

On (2, 1) and (2, 2) meshes, mamba2-130m, qwen3-1.7b, dbrx-132b (the
MoE with one process under `runtime.moe_dp_groups(2)`: each data rank
dispatches its rows) and zamba2-2.7b (its shared block's leaves gathered
whole once a step, outside the layers), two steps on the global batch:
  * the losses against one process's steps on the whole batch, rtol
    LOSS_RTOL, and step 0's against the reference's loss at the same
    params and batch (as `tests/test_torch_dp.py`, ROADMAP C5 repaired);
  * step 0's summed gradient, gathered whole (FSDP's leaves from their
    reduce-scattered shards), within GRAD_TOL of max|g| per leaf of one
    process's `loss_and_grads`, and grad_norm rtol NORM_RTOL;
  * the params after step 0, gathered whole, against one process's
    `adamw_update` fed that same gradient within PARAM_TOL of max|p| per
    leaf: AdamW's shards of FSDP's leaves stay shards (no gather).  (Held
    to one process's own step, a gradient element within rounding of 0
    steps by about lr either way, as `chip_smoke.dp_f32_check` notes.)
  * the collectives: FSDP's all-gathers and reduce-scatters run, and
    remat "full" gathers every layer again in the recompute (more
    all-gathers than remat "none", the same reduce-scatters).
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro import configs as jconfigs
from repro.configs.base import ShapeConfig as JShape
from repro.data.pipeline import make_batch as jmake_batch
from repro.models import api as japi
from repro.models import moe as jmoe
from repro.models import runtime as jruntime

from repro_torch.configs.base import ShapeConfig
from repro_torch.data.pipeline import make_batch
from repro_torch.launch import steps
from repro_torch.models import api, runtime
from repro_torch.optim import AdamWConfig, adamw_init, adamw_update
from repro_torch.tree import named_leaves

import _torch_serve_workers as W
from test_torch_moe import _c5_free_dispatch

ARCHS = ["mamba2-130m", "qwen3-1.7b", "dbrx-132b", "zamba2-2.7b"]
SEQ, BATCH, STEPS, LR = 32, 4, 2, 1e-3
FSDP_MIN = 32
LOSS_RTOL = 1e-5
GRAD_TOL = 1e-4            # max|g - g_one| / max|g_one|, per leaf
NORM_RTOL = 1e-4
PARAM_TOL = 1e-6           # max|p - p_adamw| / max|p_adamw|, per leaf
TIMEOUT = 180.0
MESHES = {2: 1, 4: 2}      # ranks: model axis -> (2, 1) and (2, 2)

_runs = {}


def _cases():
    out = [(n, n, {}) for n in ARCHS]
    out.append(("mamba2-130m/none", "mamba2-130m", {"remat": "none"}))
    return out


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    if not _runs:
        tmp = tmp_path_factory.mktemp("fsdp")
        for world, model in MESHES.items():
            _runs[world] = W.run_ranks(
                W.fsdp_steps, world, str(tmp / f"rdzv{world}"),
                (model, _cases(), SEQ, BATCH, STEPS, LR, FSDP_MIN),
                timeout=TIMEOUT)
    return _runs


def _one_process(name):
    cfg = W.f32_reduced(name)
    shape = ShapeConfig("t", SEQ, BATCH, "train")
    params = api.init(0, cfg, shape, device="cpu")
    opt_cfg = AdamWConfig(lr=LR, warmup_steps=1, total_steps=10)
    groups = 2 if cfg.family == "moe" else 1
    with runtime.moe_dp_groups(groups):
        _, grads = steps.loss_and_grads(
            params, cfg, make_batch(cfg, shape, step=0, device="cpu"))
        step = steps.make_train_step(cfg, opt_cfg)
        opt, p, losses = adamw_init(params), params, []
        for s in range(STEPS):
            p, opt, m = step(p, opt, make_batch(cfg, shape, step=s,
                                                device="cpu"))
            losses.append(float(m["loss"]))
    return cfg, params, grads, losses, opt_cfg


def _reference_loss(name, params, monkeypatch):
    monkeypatch.setattr(jmoe, "_dispatch_group", _c5_free_dispatch)
    jcfg = dataclasses.replace(jconfigs.get_reduced(name), **W.F32)
    jparams = jax.tree.map(lambda t: jnp.asarray(t.numpy()), params)
    jbatch = jmake_batch(jcfg, JShape("t", SEQ, BATCH, "train"))
    labels, mask = japi.loss_targets(jcfg, jbatch)
    with jruntime.moe_dp_groups(2):
        feats, aux = japi.forward_features(jparams, jcfg, jbatch)
        ce = japi.chunked_cross_entropy(jparams, jcfg, feats, labels, mask)
    return float(ce + steps.AUX_LOSS_WEIGHT * aux)


def _worst(got: dict, want: dict) -> tuple:
    return max((np.abs(got[k] - w).max() / max(np.abs(w).max(), 1e-30), k)
               for k, w in want.items())


@pytest.mark.parametrize("world", sorted(MESHES))
@pytest.mark.parametrize("name", ARCHS)
def test_fsdp_step_matches_one_process(name, world, runs, monkeypatch):
    results = runs[world]
    cfg, params, grads, losses, opt_cfg = _one_process(name)
    r = results[0][name]
    assert r["fsdp_leaves"] > 0
    for rank in results:                     # the same metrics on each
        assert rank[name]["runs"][0]["metrics"] == r["runs"][0]["metrics"]
    got = [run["metrics"]["loss"] for run in r["runs"]]
    np.testing.assert_allclose(got, losses, rtol=LOSS_RTOL)
    want_g = {k: v.numpy() for k, v in named_leaves(grads)}
    got_g = dict(named_leaves(r["runs"][0]["grads"]))
    assert sorted(got_g) == sorted(want_g)
    gap, leaf = _worst(got_g, want_g)
    assert gap <= GRAD_TOL, (leaf, gap)
    norm = np.sqrt(sum(float(np.sum(np.square(g.astype(np.float64))))
                       for g in want_g.values()))
    np.testing.assert_allclose(r["runs"][0]["metrics"]["grad_norm"], norm,
                               rtol=NORM_RTOL)
    tree = jax.tree.map(torch.as_tensor, r["runs"][0]["grads"])
    new, _, _ = adamw_update(tree, adamw_init(params), opt_cfg,
                             param_dtype=torch.float32)
    gap, leaf = _worst(dict(named_leaves(r["runs"][0]["params"])),
                       {k: v.numpy() for k, v in named_leaves(new)})
    assert gap <= PARAM_TOL, (leaf, gap)
    if world == 2:
        np.testing.assert_allclose(
            got[0], _reference_loss(name, params, monkeypatch),
            rtol=LOSS_RTOL)


@pytest.mark.parametrize("world", sorted(MESHES))
def test_full_remat_gathers_again(world, runs):
    full = runs[world][0]["mamba2-130m"]["runs"][0]["collectives"]
    none = runs[world][0]["mamba2-130m/none"]["runs"][0]["collectives"]
    assert full["counts"]["reduce-scatter"] > 0
    assert full["counts"]["reduce-scatter"] == none["counts"][
        "reduce-scatter"]
    assert full["counts"]["all-gather"] > none["counts"]["all-gather"]
    assert full["bytes"]["all-gather"] > none["bytes"]["all-gather"]
