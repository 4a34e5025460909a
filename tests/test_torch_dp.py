"""Data parallelism across processes (`distributed.process_group`,
`launch.steps` with rules, ZeRO-1 in `optim.adamw`, the trainer's
multi-process start, `CheckpointManager.restore_sharded`) on the CPU: two
``gloo`` ranks, spawned (`_torch_dp_workers.run_ranks`, a rendezvous
file under the test's tmp_path, one intra-op thread a rank, a timeout a
test), REDUCED configs in float32.

(a) A DP-2 `make_train_step` against the reference's train-step loss
    and `jax.value_and_grad` on the whole batch, the port's params
    carried across (as `tests/test_torch_train_step.py`): loss rtol
    1e-5, the reduced gradient within 1e-4 of max|g_ref| per leaf,
    grad_norm rtol 1e-4; mamba2-130m, qwen3-1.7b and qwen3-moe-30b-a3b
    (the reference under `runtime.moe_dp_groups(2)`, ROADMAP C5
    repaired with `test_torch_moe._c5_free_dispatch`).
    The data-parallel eval step's CE against the reference's on the
    whole batch, rtol 1e-5.
(b) ZeRO-1: after each of 2 steps the shards, gathered, equal the
    unsharded port AdamW run on the same reduced gradients bit for bit,
    and the reference's `adamw_update` within 1e-6 of max|ref| (the
    tolerance of `tests/test_torch_training.py`); each rank holds less
    than the whole state.  The bucketed all-reduce equals the plain sum
    at any bucket size.
(c) Elastic restart: the CLI trains 2 steps in 2 ranks, checkpoints and
    resumes in 1 rank, and the other way round; every loss within 1e-5
    of a straight 1-rank run.
(d) `restore_sharded`: each rank's leaf is its slice of the global
    array, at data-parallel sizes 2 and 4.
(e) Straggler exit: only rank 1 sees stragglers, and both ranks
    checkpoint and exit 75 together.
Plus `data.pipeline.rank_batch`: the ranks' rows are the global batch's.
"""
import dataclasses
import json
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro import configs as jconfigs
from repro.configs.base import ShapeConfig as JShape
from repro.data.pipeline import make_batch as jmake_batch
from repro.launch import steps as jsteps
from repro.models import api as japi
from repro.models import moe as jmoe
from repro.models import runtime as jruntime
from repro.optim import AdamWConfig as JAdamWConfig
from repro.optim import adamw_update as jadamw_update
from repro.optim.adamw import AdamWState as JAdamWState

from repro_torch import configs
from repro_torch.checkpoint import CheckpointManager
from repro_torch.configs.base import ShapeConfig
from repro_torch.data.pipeline import make_batch, rank_batch
from repro_torch.distributed import ShardingRules
from repro_torch.distributed.sharding import mesh_coords, shard_of
from repro_torch.launch import steps, train
from repro_torch.launch.mesh import make_mesh
from repro_torch.models import api
from repro_torch.optim import AdamWConfig, AdamWState, adamw_init, \
    adamw_update
from repro_torch.tree import named_leaves

import _torch_dp_workers as W
from test_torch_moe import _c5_free_dispatch

ARCHS = ["mamba2-130m", "qwen3-1.7b", "qwen3-moe-30b-a3b"]
FAMILIES = ["qwen3-1.7b", "mamba2-130m", "qwen3-moe-30b-a3b",
            "llava-next-mistral-7b", "whisper-medium", "zamba2-2.7b"]
SEQ, BATCH, STEPS, LR = 32, 4, 2, 1e-3
CE_RTOL = 1e-5
GRAD_TOL = 1e-4             # max|g - g_ref| / max|g_ref|, per leaf
NORM_RTOL = 1e-4
OPT_TOL = 1e-6
ELASTIC_RTOL = 1e-5
TIMEOUT = 120.0


@pytest.fixture(autouse=True)
def _one_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


_dp = {}


@pytest.fixture
def dp_runs(tmp_path):
    """Rank 0's and rank 1's results of `W.dp_steps` over ARCHS (one
    spawn for the module)."""
    if "runs" not in _dp:
        _dp["runs"] = W.run_ranks(W.dp_steps, 2, str(tmp_path / "rdzv"),
                                  (ARCHS, SEQ, BATCH, STEPS, LR),
                                  timeout=TIMEOUT)
    return _dp["runs"]


def _reference(name):
    """The reference's whole-batch loss and gradient at the port's
    initial params (float32 REDUCED, seed 0), under moe_dp_groups(2)."""
    jcfg = dataclasses.replace(jconfigs.get_reduced(name), **W.F32)
    cfg = W.f32_reduced(name)
    params = api.init(0, cfg, ShapeConfig("t", SEQ, BATCH, "train"),
                      device="cpu")
    jparams = jax.tree.map(lambda t: jnp.asarray(t.numpy()), params)
    jbatch = jmake_batch(jcfg, JShape("t", SEQ, BATCH, "train"))
    labels, mask = japi.loss_targets(jcfg, jbatch)

    def loss_fn(p):
        feats, aux = japi.forward_features(p, jcfg, jbatch)
        ce = japi.chunked_cross_entropy(p, jcfg, feats, labels, mask)
        return ce + steps.AUX_LOSS_WEIGHT * aux

    with jruntime.moe_dp_groups(2):
        loss, grads = jax.jit(jax.value_and_grad(loss_fn))(jparams)
    return jcfg, params, float(loss), grads


def _named(tree, prefix=""):
    """{path: numpy leaf} of nested dicts."""
    out = {}
    for k, v in tree.items():
        if isinstance(v, dict):
            out.update(_named(v, f"{prefix}{k}/"))
        else:
            out[prefix + k] = np.asarray(v)
    return out


@pytest.mark.parametrize("name", ARCHS)
def test_dp2_step_matches_reference_whole_batch(name, dp_runs, monkeypatch):
    monkeypatch.setattr(jmoe, "_dispatch_group", _c5_free_dispatch)
    r0, r1 = dp_runs
    _, _, want_loss, want_grads = _reference(name)
    m = r0[name]["runs"][0]["metrics"]
    assert m == r1[name]["runs"][0]["metrics"]  # the same on every rank
    np.testing.assert_allclose(m["loss"], want_loss, rtol=CE_RTOL)
    got, want = _named(r0[name]["runs"][0]["grads"]), _named(want_grads)
    assert sorted(got) == sorted(want)
    sq = 0.0
    for k, w in want.items():
        w = w.astype(np.float32)
        sq += float(np.sum(np.square(w.astype(np.float64))))
        err = np.abs(got[k] - w).max()
        assert err <= GRAD_TOL * np.abs(w).max(), (k, err, np.abs(w).max())
    np.testing.assert_allclose(m["grad_norm"], np.sqrt(sq), rtol=NORM_RTOL)


@pytest.mark.parametrize("name", ARCHS)
def test_zero1_state_equals_unsharded_adamw_and_reference(name, dp_runs):
    r0, r1 = dp_runs
    cfg = W.f32_reduced(name)
    params = api.init(0, cfg, ShapeConfig("t", SEQ, BATCH, "train"),
                      device="cpu")
    opt_cfg = AdamWConfig(lr=LR, warmup_steps=1, total_steps=10)
    jopt_cfg = JAdamWConfig(lr=LR, warmup_steps=1, total_steps=10)
    state = adamw_init(params)
    total = sum(t.numel() for t in jax.tree.leaves(state.master))
    jstate = jax.tree.map(lambda t: jnp.asarray(t.numpy()), state)
    jstate = JAdamWState(*jstate)
    for step in range(STEPS):
        run = r0[name]["runs"][step]
        grads = jax.tree.map(torch.from_numpy, run["grads"])
        new_params, state, m = adamw_update(grads, state, opt_cfg,
                                            param_dtype=torch.float32)
        _, jstate, jm = jadamw_update(
            jax.tree.map(jnp.asarray, run["grads"]), jstate, jopt_cfg,
            param_dtype=jnp.float32)
        got = run["state"]
        assert int(got["step"]) == int(state.step) == step + 1
        for field in ("master", "mu", "nu"):
            g, want = _named(got[field]), _named(
                jax.tree.map(lambda t: t.numpy(), getattr(state, field)))
            ref = _named(getattr(jstate, field))
            for k in want:
                np.testing.assert_array_equal(g[k], want[k], err_msg=k)
                scale = max(float(np.abs(ref[k]).max()), 1e-30)
                assert np.abs(g[k] - ref[k]).max() <= OPT_TOL * scale, k
        for k, w in _named(jax.tree.map(lambda t: t.numpy(),
                                        new_params)).items():
            np.testing.assert_array_equal(_named(run["params"])[k], w)
        np.testing.assert_allclose(run["metrics"]["grad_norm"],
                                   float(m["grad_norm"]), rtol=1e-6)
        np.testing.assert_allclose(float(jm["grad_norm"]),
                                   float(m["grad_norm"]), rtol=1e-6)
        for r in (r0, r1):
            assert r[name]["runs"][step]["shard_numel"] < total


@pytest.mark.parametrize("name", ARCHS)
def test_dp2_eval_step_matches_reference_whole_batch(name, dp_runs,
                                                     monkeypatch):
    """`make_eval_step(cfg, rules)`: the CE of the global batch, the
    ranks' rows together, against the reference's eval step on the whole
    batch (under moe_dp_groups(2), C5 repaired) at the params after the
    DP steps."""
    monkeypatch.setattr(jmoe, "_dispatch_group", _c5_free_dispatch)
    r0, r1 = dp_runs
    jcfg = dataclasses.replace(jconfigs.get_reduced(name), **W.F32)
    jparams = jax.tree.map(jnp.asarray, r0[name]["runs"][-1]["params"])
    jbatch = jmake_batch(jcfg, JShape("t", SEQ, BATCH, "train"), step=STEPS)
    with jruntime.moe_dp_groups(2):
        want = float(jsteps.make_eval_step(jcfg)(jparams, jbatch))
    assert r0[name]["eval"] == r1[name]["eval"]
    np.testing.assert_allclose(r0[name]["eval"], want, rtol=CE_RTOL)


def test_bucketed_all_reduce_equals_the_sum(dp_runs):
    (b0, b1) = (r["buckets"] for r in dp_runs)
    want = jax.tree.map(lambda a, b: a + b, b0["tree"], b1["tree"])
    for r in (b0, b1):
        for k in ("small", "default"):
            for (g, w) in zip(jax.tree.leaves(r[k]), jax.tree.leaves(want)):
                np.testing.assert_array_equal(g, w)


# ---------------------------------------------------------------------------
# the trainer's CLI across processes
# ---------------------------------------------------------------------------

CLI = ["--arch", "mamba2-130m", "--reduced", "--device", "cpu",
       "--dist-backend", "gloo", "--seq-len", "16", "--batch", "4",
       "--steps", "4", "--log-every", "1", "--save-every", "100"]


def _losses(ckpt):
    with open(os.path.join(ckpt, "metrics.jsonl")) as f:
        return {r["step"]: r["loss"] for r in map(json.loads, f)}


def _one_rank(ckpt, extra=(), monkeypatch=None):
    """The CLI in this process (one rank), REDUCED in float32."""
    get = configs.get_reduced
    monkeypatch.setattr(configs, "get_reduced", lambda n: dataclasses.replace(
        get(n), **W.F32))
    monkeypatch.delenv("WORLD_SIZE", raising=False)
    rc = train.main(CLI + ["--ckpt-dir", str(ckpt), *extra])
    monkeypatch.setattr(configs, "get_reduced", get)
    return rc


def _two_ranks(tmp_path, ckpt, extra=(), rank_extra=None):
    args = {r: (CLI + ["--ckpt-dir", str(ckpt), *extra,
                       *(rank_extra or {}).get(r, ())],)
            for r in range(2)}
    return W.run_ranks(W.cli, 2, str(tmp_path / "rdzv"), (),
                       rank_args=args, timeout=TIMEOUT)


_straight = {}


def _straight_losses(tmp_path, monkeypatch):
    if "losses" not in _straight:
        assert _one_rank(tmp_path / "straight", monkeypatch=monkeypatch) == 0
        _straight["losses"] = _losses(tmp_path / "straight")
    return _straight["losses"]


@pytest.mark.parametrize("first,then", [(2, 1), (1, 2)],
                         ids=["dp2-to-dp1", "dp1-to-dp2"])
def test_elastic_restart_matches_straight_run(first, then, tmp_path,
                                              monkeypatch):
    want = _straight_losses(tmp_path, monkeypatch)
    ckpt = tmp_path / "elastic"
    for world, extra in ((first, ["--stop-after", "2"]), (then, [])):
        if world == 1:
            assert _one_rank(ckpt, extra, monkeypatch) == 0
        else:
            assert _two_ranks(tmp_path, ckpt, extra) == [0, 0]
    got = _losses(ckpt)
    assert sorted(got) == [0, 1, 2, 3]
    for s in got:
        np.testing.assert_allclose(got[s], want[s], rtol=ELASTIC_RTOL,
                                   err_msg=f"step {s}")
    assert CheckpointManager(str(ckpt)).latest_step() == 4


def test_straggler_exit_is_agreed_by_every_rank(tmp_path):
    """Rank 1 alone calls every step after the fourth a straggler
    (--deadline-factor 0), rank 0 never (1e9): both count its incidents,
    checkpoint step 6 and exit 75."""
    ckpt = tmp_path / "straggler"
    rcs = _two_ranks(tmp_path, ckpt, ["--steps", "20", "--max-incidents",
                                      "2"],
                     rank_extra={0: ["--deadline-factor", "1e9"],
                                 1: ["--deadline-factor", "0"]})
    assert rcs == [75, 75]
    assert CheckpointManager(str(ckpt)).latest_step() == 6


@pytest.mark.parametrize("dp", [2, 4])
def test_restore_sharded_gives_each_rank_its_slice(dp, tmp_path):
    cfg = W.f32_reduced("qwen3-1.7b")
    params = api.init(1, cfg, device="cpu")
    params["embed"]["embedding"] = params["embed"]["embedding"].to(
        torch.bfloat16)
    opt = adamw_init(params)
    opt = opt._replace(mu=jax.tree.map(lambda t: t + 1.5, opt.mu),
                       step=torch.tensor(3, dtype=torch.int32))
    tree = {"params": params, "opt": opt}
    mgr = CheckpointManager(str(tmp_path))
    mgr.save(3, tree)
    mesh = make_mesh((dp, 1), ("data", "model"), ["meta"])
    rules = ShardingRules(mesh=mesh, cfg=cfg)
    zs = steps.zero1_specs(rules, params)
    specs = {"params": rules.param_pspecs(params),
             "opt": AdamWState((), zs, zs, zs)}
    sharded = 0
    for rank in range(dp):
        step, got = mgr.restore_sharded(tree, specs, mesh, rank)
        assert step == 3
        coords = mesh_coords(mesh, rank)
        spec_of = dict(named_leaves(specs))
        for name, leaf in named_leaves(tree):
            want = shard_of(leaf, spec_of[name], coords, mesh)
            g = dict(named_leaves(got))[name]
            assert g.dtype == want.dtype and g.device.type == "cpu"
            assert torch.equal(g, want), name
            sharded += g.numel() < leaf.numel()
    assert sharded > 0


@pytest.mark.parametrize("name", FAMILIES)
def test_rank_batch_rows_are_the_global_batch(name):
    cfg = configs.get_reduced(name)
    shape = ShapeConfig("t", 32, 4, "train")
    whole = make_batch(cfg, shape, step=3, device="cpu")
    parts = [rank_batch(cfg, shape, 3, r, 2, device="cpu") for r in (0, 1)]
    assert list(parts[0]) == list(whole)
    for k, v in whole.items():
        assert torch.equal(torch.cat([p[k] for p in parts]), v), k
    with pytest.raises(ValueError, match="divide"):
        rank_batch(cfg, shape, 0, 0, 3, device="cpu")
