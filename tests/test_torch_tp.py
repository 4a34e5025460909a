"""Tensor and expert parallelism across processes (`launch.steps` with a
model axis, `process_group`'s model-axis collectives and sub-groups, the
models' split blocks, the vocabulary-parallel loss, the trainer's
``--model-axis``) on the CPU: ``gloo`` ranks spawned by
`_torch_tp_workers` (one spawn for each rank count), REDUCED configs in
float32.

(a) The TP-2 train step of each of six architectures (mamba2-130m: heads
    and the B/C columns split, B gathered from one rank and C from the
    other; mamba2 with 3 heads, which a model axis of 2 would cut, so
    every rank runs the block whole and no leaf of it is partial;
    qwen3-1.7b: heads with their kv heads, SwiGLU, tied vocab;
    qwen3-moe-30b-a3b: experts (EP) and an untied lm_head; zamba2-2.7b;
    whisper-medium: GELU MLP and cross-attention; llava-next-mistral-7b),
    and whisper with a vocabulary of 255 that does not split, against the
    reference's loss and `jax.value_and_grad` on the whole batch at the
    same initial params: loss rtol 1e-5, the gathered gradient within
    1e-4 of max|g_ref| per leaf, grad_norm rtol 1e-4.  The MoE is held to
    the reference with ROADMAP C5 repaired (`test_torch_moe.
    _c5_free_dispatch`), at its capacity factor and at 0.5 (drops).
(b) The eval step's CE after the steps against the reference's at the
    gathered params, rtol 1e-5.
(c) In four ranks: DP-2 x TP-2 for qwen3-moe-30b-a3b (the reference
    under `moe_dp_groups(2)`), and qwen3-1.7b at TP 4, whose 2 kv heads do
    not split: wk and wv stay whole and each rank takes the kv head its q
    head reads.
(d) Elastic restore through the CLI: TP-2 trains 2 steps and checkpoints,
    one process resumes, and the other way round; every loss within 1e-5
    of a straight one-process run.
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

from repro_torch import configs
from repro_torch.checkpoint import CheckpointManager
from repro_torch.configs.base import ShapeConfig
from repro_torch.distributed import ShardingRules
from repro_torch.launch import steps, train
from repro_torch.launch.mesh import make_mesh
from repro_torch.models import api

import _torch_dp_workers as DW
import _torch_tp_workers as W
from test_torch_moe import _c5_free_dispatch

SEQ, BATCH, STEPS, LR = 32, 4, 2, 1e-3
CE_RTOL = 1e-5
GRAD_TOL = 1e-4             # max|g - g_ref| / max|g_ref|, per leaf
NORM_RTOL = 1e-4
ELASTIC_RTOL = 1e-5
TIMEOUT = 150.0

# (key, arch, config overrides, data-parallel groups of the reference's MoE)
# 3 heads of 32 channels: a model axis of 2 splits d_inner = 96 mid-head
HEADS_CUT = {"d_model": 48, "ssm_headdim": 32}
TP2 = [("mamba2-130m", "mamba2-130m", {}),
       ("mamba2-heads-cut", "mamba2-130m", HEADS_CUT),
       ("qwen3-1.7b", "qwen3-1.7b", {}),
       ("qwen3-moe-30b-a3b", "qwen3-moe-30b-a3b", {}),
       ("qwen3-moe-drops", "qwen3-moe-30b-a3b", {"capacity_factor": 0.5}),
       ("zamba2-2.7b", "zamba2-2.7b", {}),
       ("whisper-medium", "whisper-medium", {}),
       ("whisper-vocab-255", "whisper-medium", {"vocab_size": 255}),
       ("llava-next-mistral-7b", "llava-next-mistral-7b", {})]
DPTP = [("dp2-tp2-qwen3-moe", "qwen3-moe-30b-a3b", {})]
TP4 = [("tp4-qwen3-1.7b", "qwen3-1.7b", {})]
MOE_GROUPS = {"dp2-tp2-qwen3-moe": 2}
CASES = {k: (name, over) for k, name, over in TP2 + DPTP + TP4}


@pytest.fixture(autouse=True)
def _one_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


_runs = {}


def _ranks(tmp_path, world):
    """Rank 0's and the other ranks' results of `W.tp_steps` in `world`
    ranks: TP-2 over TP2 (two ranks); DP-2 x TP-2 over DPTP, then TP-4 over
    TP4 (four)."""
    if world not in _runs:
        rdzv = str(tmp_path / f"rdzv{world}")
        if world == 2:
            _runs[2] = W.run_ranks(W.tp_steps, 2, rdzv,
                                   (2, TP2, SEQ, BATCH, STEPS, LR),
                                   timeout=TIMEOUT)
        else:
            _runs[4] = W.run_ranks(_four, 4, rdzv, (), timeout=TIMEOUT)
    return _runs[world]


def _four(rank, world):
    out = W.tp_steps(rank, world, 2, DPTP, SEQ, BATCH, STEPS, LR)
    out.update(W.tp_steps(rank, world, 4, TP4, SEQ, BATCH, STEPS, LR))
    return out


def _result(tmp_path, key):
    world = 2 if key in {k for k, _, _ in TP2} else 4
    runs = _ranks(tmp_path, world)
    for r in runs[1:]:               # the same metrics on every rank
        assert r[key]["runs"][0]["metrics"] == runs[0][key]["runs"][0][
            "metrics"]
        assert r[key]["eval"] == runs[0][key]["eval"]
    return runs[0][key]


def _jcfg(key):
    name, over = CASES[key]
    return dataclasses.replace(jconfigs.get_reduced(name), **DW.F32, **over)


def _reference(key):
    """The reference's whole-batch loss and gradient at the port's
    initial params (float32 REDUCED, seed 0)."""
    name, over = CASES[key]
    jcfg = _jcfg(key)
    cfg = dataclasses.replace(DW.f32_reduced(name), **over)
    params = api.init(0, cfg, ShapeConfig("t", SEQ, BATCH, "train"),
                      device="cpu")
    jparams = jax.tree.map(lambda t: jnp.asarray(t.numpy()), params)
    jbatch = jmake_batch(jcfg, JShape("t", SEQ, BATCH, "train"))
    labels, mask = japi.loss_targets(jcfg, jbatch)

    def loss_fn(p):
        feats, aux = japi.forward_features(p, jcfg, jbatch)
        ce = japi.chunked_cross_entropy(p, jcfg, feats, labels, mask)
        return ce + steps.AUX_LOSS_WEIGHT * aux

    with jruntime.moe_dp_groups(MOE_GROUPS.get(key, 1)):
        loss, grads = jax.jit(jax.value_and_grad(loss_fn))(jparams)
    return float(loss), grads


def _named(tree, prefix=""):
    out = {}
    for k, v in tree.items():
        if isinstance(v, dict):
            out.update(_named(v, f"{prefix}{k}/"))
        else:
            out[prefix + k] = np.asarray(v)
    return out


def _check_step(key, tmp_path):
    got = _result(tmp_path, key)
    want_loss, want_grads = _reference(key)
    m = got["runs"][0]["metrics"]
    np.testing.assert_allclose(m["loss"], want_loss, rtol=CE_RTOL)
    g, w = _named(got["runs"][0]["grads"]), _named(want_grads)
    assert sorted(g) == sorted(w)
    sq = 0.0
    for k, want in w.items():
        want = want.astype(np.float32)
        sq += float(np.sum(np.square(want.astype(np.float64))))
        err = np.abs(g[k] - want).max()
        assert err <= GRAD_TOL * np.abs(want).max(), (k, err)
    np.testing.assert_allclose(m["grad_norm"], np.sqrt(sq), rtol=NORM_RTOL)
    assert got["split"] > 0          # some leaves are this rank's block
    return got


@pytest.mark.parametrize("key", [k for k, _, _ in TP2 + DPTP + TP4])
def test_tp_step_matches_reference_whole_batch(key, tmp_path, monkeypatch):
    monkeypatch.setattr(jmoe, "_dispatch_group", _c5_free_dispatch)
    got = _check_step(key, tmp_path)
    if key == "qwen3-moe-drops":
        assert got["drops"] > 0
    if key == "whisper-vocab-255":   # a vocabulary of 255 stays whole
        cfg = dataclasses.replace(DW.f32_reduced("whisper-medium"),
                                  vocab_size=255)
        rules = ShardingRules(mesh=make_mesh((1, 2), ("data", "model"),
                                             ["meta"]), cfg=cfg)
        specs = rules.param_pspecs(api.param_specs(cfg))
        assert specs["embed"]["embedding"] == (None, None)


@pytest.mark.parametrize("key", [k for k, _, _ in TP2 + DPTP + TP4])
def test_tp_eval_step_matches_reference(key, tmp_path, monkeypatch):
    """`make_eval_step(cfg, rules)` with the params split: the CE of the
    global batch at the params after the steps, against the reference's
    eval step on the whole batch at the same params, gathered."""
    monkeypatch.setattr(jmoe, "_dispatch_group", _c5_free_dispatch)
    got = _result(tmp_path, key)
    jcfg = _jcfg(key)
    jparams = jax.tree.map(jnp.asarray, got["params"])
    jbatch = jmake_batch(jcfg, JShape("t", SEQ, BATCH, "train"), step=STEPS)
    with jruntime.moe_dp_groups(MOE_GROUPS.get(key, 1)):
        want = float(jsteps.make_eval_step(jcfg)(jparams, jbatch))
    np.testing.assert_allclose(got["eval"], want, rtol=CE_RTOL)


def test_model_partial_marks_whole_leaves_used_on_a_block():
    """`ShardingRules.model_partial` at TP 4 for qwen3-1.7b REDUCED (kv
    heads whole), mamba2-130m and qwen3-moe: the whole leaves inside a
    split block, and nothing else."""
    mesh = make_mesh((1, 4), ("data", "model"), ["meta"])

    def partial(name):
        cfg = DW.f32_reduced(name)
        rules = ShardingRules(mesh=mesh, cfg=cfg)
        return {k for k, v in _named(rules.model_partial(
            api.param_specs(cfg))).items() if v}

    assert partial("qwen3-1.7b") == {"blocks/attn/wk", "blocks/attn/wv",
                                     "blocks/attn/q_norm",
                                     "blocks/attn/k_norm"}
    assert partial("mamba2-130m") == {f"blocks/{k}" for k in (
        "in_dt", "dt_bias", "A_log", "D", "gate_norm")}
    assert partial("qwen3-moe-30b-a3b") == {
        "blocks/attn/wk", "blocks/attn/wv", "blocks/attn/q_norm",
        "blocks/attn/k_norm"}


def test_model_partial_leaves_a_block_run_whole_unsummed():
    """A Mamba2 block whose heads do not divide the model axis runs whole
    on every rank (`models.mamba2._whole_if_cut`), so every rank holds
    the whole gradient of its unsplit leaves: none is partial, at TP 2
    and 4 (3 heads), though in_x is split; at 4 heads and TP 2 they are."""
    cfg = dataclasses.replace(DW.f32_reduced("mamba2-130m"), **HEADS_CUT)
    for model in (2, 4):
        rules = ShardingRules(mesh=make_mesh((1, model), ("data", "model"),
                                             ["meta"]), cfg=cfg)
        specs = api.param_specs(cfg)
        assert "model" in rules.param_pspecs(specs)["blocks"]["in_x"]
        assert not any(_named(rules.model_partial(specs)).values())
    four = dataclasses.replace(cfg, ssm_headdim=24)
    rules = ShardingRules(mesh=make_mesh((1, 2), ("data", "model"),
                                         ["meta"]), cfg=four)
    assert _named(rules.model_partial(api.param_specs(four)))[
        "blocks/A_log"]


def test_sharded_steps_refuse_what_the_port_does_not_run():
    """SP alone is refused, naming its ROADMAP item, by every step; FSDP
    and rules in the serving steps are executed (tests/test_torch_fsdp.py,
    tests/test_torch_serve_tp.py); a mesh with no process group, or with
    no group over the rules' data axes, is refused."""
    from repro_torch.launch.mesh import make_rank_view
    from repro_torch.optim import AdamWConfig

    cfg = DW.f32_reduced("qwen3-1.7b")
    mesh = make_rank_view((1, 1), ("data", "model"))
    sp = ShardingRules(mesh=mesh, cfg=cfg, sp=True)
    for make in (lambda r: steps.make_eval_step(cfg, r),
                 lambda r: steps.make_train_step(cfg, AdamWConfig(), r),
                 lambda r: steps.make_prefill_step(cfg, 16, r),
                 lambda r: steps.make_decode_step(cfg, r)):
        with pytest.raises(NotImplementedError, match="sp.*ROADMAP"):
            make(sp)
        make(ShardingRules(mesh=mesh, cfg=cfg, fsdp=True))
        make(ShardingRules(mesh=mesh, cfg=cfg))
    bare = make_mesh((1, 1), ("data", "model"), ["cpu"])
    with pytest.raises(ValueError, match="process group"):
        steps.make_eval_step(cfg, ShardingRules(mesh=bare, cfg=cfg))
    bare.process_group = object()
    with pytest.raises(NotImplementedError, match="data axes"):
        steps.make_eval_step(cfg, ShardingRules(mesh=bare, cfg=cfg))


# ---------------------------------------------------------------------------
# the trainer's CLI: elastic restore across model-parallel sizes
# ---------------------------------------------------------------------------

CLI = ["--arch", "mamba2-130m", "--reduced", "--device", "cpu",
       "--dist-backend", "gloo", "--seq-len", "16", "--batch", "4",
       "--steps", "4", "--log-every", "1", "--save-every", "100"]


def _losses(ckpt):
    with open(os.path.join(ckpt, "metrics.jsonl")) as f:
        return {r["step"]: r["loss"] for r in map(json.loads, f)}


def _one_process(ckpt, extra, monkeypatch):
    get = configs.get_reduced
    monkeypatch.setattr(configs, "get_reduced", lambda n: dataclasses.replace(
        get(n), **DW.F32))
    monkeypatch.delenv("WORLD_SIZE", raising=False)
    rc = train.main(CLI + ["--ckpt-dir", str(ckpt), *extra])
    monkeypatch.setattr(configs, "get_reduced", get)
    return rc


_straight = {}


@pytest.mark.parametrize("first,then", [(2, 1), (1, 2)],
                         ids=["tp2-to-1", "1-to-tp2"])
def test_elastic_restore_across_model_sizes(first, then, tmp_path,
                                            monkeypatch):
    if "losses" not in _straight:
        assert _one_process(tmp_path / "straight", [], monkeypatch) == 0
        _straight["losses"] = _losses(tmp_path / "straight")
    want = _straight["losses"]
    ckpt = tmp_path / "elastic"
    for world, extra in ((first, ["--stop-after", "2"]), (then, [])):
        if world == 1:
            assert _one_process(ckpt, extra, monkeypatch) == 0
        else:
            argv = CLI + ["--ckpt-dir", str(ckpt), "--model-axis", "2",
                          *extra]
            assert W.run_ranks(DW.cli, 2, str(tmp_path / "rdzv"), (),
                               rank_args={r: (argv,) for r in range(2)},
                               timeout=TIMEOUT) == [0, 0]
    got = _losses(ckpt)
    assert sorted(got) == [0, 1, 2, 3]
    for s in got:
        np.testing.assert_allclose(got[s], want[s], rtol=ELASTIC_RTOL,
                                   err_msg=f"step {s}")
    assert CheckpointManager(str(ckpt)).latest_step() == 4


def test_one_process_refuses_a_model_axis(monkeypatch):
    monkeypatch.delenv("WORLD_SIZE", raising=False)
    with pytest.raises(ValueError, match="model-axis"):
        train.main(CLI + ["--model-axis", "2"])
