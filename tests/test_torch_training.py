"""The port's training pieces against the reference's, on the CPU:

- `data.make_batch` bit-equal to the reference's for all six families
  (REDUCED): tokens, labels and the stub embeddings.
- `optim.adamw_update` against the reference's on the same gradients and
  state, three steps (clipping on): params, master, moments within 1e-6
  of each leaf's max|reference|; lr, grad_norm and clip_scale at rtol
  1e-6.
- `remat` "none" / "full" / "dots" give equal gradients (recomputing
  changes no number).
- The reference's two training checks (`tests/test_training.py`), ported:
  the loss falls by more than 0.5 on the learnable stream, and the CLI's
  resume is exact (20 steps straight == 10 + restart + 10).
- Checkpoints: one written by the reference restores in the port, and one
  written by the port restores in the reference, bf16 leaves included,
  bit for bit.
- The CLI refuses a model axis above 1 and nccl where it cannot run
  (two ranks on one card, the CPU), raises without a card unless asked
  for the CPU, and its straggler path checkpoints and exits 75.
"""
import dataclasses
import os
import subprocess
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro import configs as jconfigs
from repro.checkpoint import manager as jckpt
from repro.configs.base import ShapeConfig as JShape
from repro.data.pipeline import make_batch as jmake_batch
from repro.optim import AdamWConfig as JAdamWConfig
from repro.optim import adamw_init as jadamw_init
from repro.optim import adamw_update as jadamw_update

from repro_torch import configs
from repro_torch.checkpoint import CheckpointManager, load_pytree, \
    save_pytree
from repro_torch.configs.base import ShapeConfig
from repro_torch.data.pipeline import make_batch
from repro_torch.launch import steps, train
from repro_torch.models import api
from repro_torch.optim import AdamWConfig, AdamWState, adamw_init, \
    adamw_update

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
F32 = dict(param_dtype="float32", activation_dtype="float32")
FAMILIES = ["qwen3-1.7b", "mamba2-130m", "qwen3-moe-30b-a3b",
            "llava-next-mistral-7b", "whisper-medium", "zamba2-2.7b"]
OPT_TOL = 1e-6


@pytest.fixture(autouse=True)
def _one_thread():
    """One intra-op thread a test: the suite runs several workers at once,
    and this file's many small ops on every core's thread each slow all
    of them down (the loss test took 11 s alone, ~670 s so)."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _np(t):
    """A tensor's values as numpy (bf16 as float32)."""
    return (t.float() if t.dtype == torch.bfloat16 else t).numpy()


@pytest.mark.parametrize("name", FAMILIES)
def test_make_batch_bit_equal_to_reference(name):
    cfg, jcfg = configs.get_reduced(name), jconfigs.get_reduced(name)
    # a data-parallel slice (rank 1 of 2) for the text-in families: the
    # stub families' embeddings keep the global batch's rows in both
    # packages, so only dp_size 1 makes a consistent batch of theirs
    split = (1, 2) if cfg.family not in ("vlm", "encdec") else (0, 1)
    for step, rank, size in ((0, 0, 1), (3, *split)):
        got = make_batch(cfg, ShapeConfig("t", 32, 4, "train"), step=step,
                         dp_rank=rank, dp_size=size, device="cpu")
        want = jmake_batch(jcfg, JShape("t", 32, 4, "train"), step=step,
                           dp_rank=rank, dp_size=size)
        assert sorted(got) == sorted(want)
        for k, w in want.items():
            w = np.asarray(w)
            g = got[k]
            assert g.shape == w.shape, k
            if w.dtype.name == "bfloat16":
                assert g.dtype == torch.bfloat16
                np.testing.assert_array_equal(
                    g.view(torch.int16).numpy(), w.view(np.int16))
            else:
                assert str(g.dtype) == f"torch.{w.dtype}", k
                np.testing.assert_array_equal(g.numpy(), w)


def _tree(seed):
    """A small params tree: a nested dict, float32 and bf16 leaves."""
    rng = np.random.RandomState(seed)
    return {"blocks": {"w": rng.randn(3, 4, 5).astype(np.float32),
                       "b": rng.randn(3, 5).astype(np.float32)},
            "embed": {"embedding": rng.randn(16, 4).astype(np.float32)},
            "norm": rng.randn(4).astype(np.float32)}


def _leaves_named(tree, prefix=""):
    for k in sorted(tree):
        v = tree[k]
        if isinstance(v, dict):
            yield from _leaves_named(v, f"{prefix}{k}/")
        else:
            yield f"{prefix}{k}", v


@pytest.mark.parametrize("param_dtype", ["float32", "bfloat16"])
def test_adamw_update_matches_reference(param_dtype):
    cfg = dict(lr=1e-2, warmup_steps=2, total_steps=5, clip_norm=0.5)
    p0 = _tree(0)
    jdt = jnp.dtype(param_dtype)
    tdt = getattr(torch, param_dtype)
    jp = jax.tree.map(lambda a: jnp.asarray(a).astype(jdt), p0)
    tp = jax.tree.map(lambda a: torch.tensor(a).to(tdt), p0)
    js, ts = jadamw_init(jp), adamw_init(tp)
    for step in range(3):
        g = _tree(10 + step)
        jg = jax.tree.map(lambda a: jnp.asarray(a).astype(jdt), g)
        tg = jax.tree.map(lambda a: torch.tensor(a).to(tdt), g)
        jp, js, jm = jadamw_update(jg, js, JAdamWConfig(**cfg),
                                   param_dtype=jdt)
        tp, ts, tm = adamw_update(tg, ts, AdamWConfig(**cfg),
                                  param_dtype=tdt)
        assert int(ts.step) == int(js.step) == step + 1
        for k in ("lr", "grad_norm", "clip_scale"):
            np.testing.assert_allclose(float(tm[k]), float(jm[k]),
                                       rtol=OPT_TOL)
        assert float(tm["clip_scale"]) < 1.0       # clipping is on
        for got, want in ((tp, jp), (ts.master, js.master), (ts.mu, js.mu),
                          (ts.nu, js.nu)):
            for (name, g), (_, w) in zip(_leaves_named(got),
                                         _leaves_named(want)):
                w = np.asarray(w, np.float32)
                err = np.abs(_np(g) - w).max()
                assert err <= OPT_TOL * np.abs(w).max(), (step, name, err)


@pytest.mark.parametrize("name", FAMILIES)
def test_remat_policies_give_equal_gradients(name):
    cfg = dataclasses.replace(configs.get_reduced(name), **F32)
    shape = ShapeConfig("t", 16, 2, "train")
    params = api.init(0, cfg, shape, device="cpu")
    batch = make_batch(cfg, shape, device="cpu")
    out = {}
    for remat in ("none", "full", "dots"):
        c = dataclasses.replace(cfg, remat=remat)
        out[remat] = steps.loss_and_grads(params, c, batch)
    (loss, _, _), grads = out["none"]
    for remat in ("full", "dots"):
        (l2, _, _), g2 = out[remat]
        assert float(l2) == float(loss)
        for (k, a), (_, b) in zip(_leaves_named(grads), _leaves_named(g2)):
            assert torch.equal(a, b), (remat, k)


def test_bf16_mamba2_steps_hand_the_scan_float32_dt_and_a(monkeypatch):
    """After an optimizer step every param is in the param dtype (bf16,
    as in the reference), A_log too: the next step still hands the scan
    (kernel B2 on a card, which takes float32 dt and A only) float32 dt
    and A."""
    from repro_torch.kernels import ssd_scan as ssd

    cfg = configs.get_reduced("mamba2-130m")
    shape = ShapeConfig("t", 16, 2, "train")
    params = api.init(0, cfg, shape, device="cpu")
    opt = adamw_init(params)
    step = steps.make_train_step(cfg, AdamWConfig())
    seen = []
    scan = ssd._scan

    def checked(spec, x, dtv, Bm, Cm, A, h0):
        seen.append((x.dtype, dtv.dtype, A.dtype))
        return scan(spec, x, dtv, Bm, Cm, A, h0)

    monkeypatch.setattr(ssd, "_scan", checked)
    for i in range(2):
        params, opt, m = step(params, opt, make_batch(cfg, shape, step=i,
                                                      device="cpu"))
        assert np.isfinite(float(m["loss"]))
    assert params["blocks"]["A_log"].dtype == torch.bfloat16
    assert seen and all(d[1:] == (torch.float32, torch.float32)
                        for d in seen)


def test_remat_rejects_an_unknown_policy():
    from repro_torch.models import layers as L
    cfg = dataclasses.replace(configs.get_reduced("qwen3-1.7b"),
                              remat="most")
    with pytest.raises(ValueError, match="remat"):
        L.maybe_remat(lambda x: x, cfg)


def test_loss_decreases_on_learnable_stream():
    """tests/test_training.py's check on the port: the stream's
    conditional entropy ln(vocab/16) << ln(vocab), so 250 steps must take
    the loss well below the unigram plateau."""
    cfg = dataclasses.replace(configs.get_reduced("qwen3-1.7b"), **F32)
    shape = ShapeConfig("t", 64, 8, "train")
    params = api.init(0, cfg, shape, device="cpu")
    opt_cfg = AdamWConfig(lr=3e-3, warmup_steps=10, total_steps=250,
                          min_lr_ratio=0.5)
    opt_state = adamw_init(params)
    step = steps.make_train_step(cfg, opt_cfg)
    losses = []
    for i in range(250):
        params, opt_state, m = step(params, opt_state,
                                    make_batch(cfg, shape, step=i,
                                               device="cpu"))
        losses.append(float(m["loss"]))
    start = np.mean(losses[:5])          # ~ ln(256) = 5.55 unigram plateau
    end = np.mean(losses[-10:])
    assert end < start - 0.5, f"no learning: {losses[::25]}"


def _cli(ckpt, steps_, stop_after=None, extra=()):
    env = {**os.environ, "PYTHONPATH": os.path.join(REPO, "src"),
           "OMP_NUM_THREADS": "1"}
    cmd = [sys.executable, "-m", "repro_torch.launch.train", "--arch",
           "qwen2-7b", "--reduced", "--steps", str(steps_), "--seq-len",
           "32", "--batch", "2", "--ckpt-dir", ckpt, "--save-every", "10",
           "--mesh", "single", "--log-every", "1", "--device", "cpu",
           *extra]
    if stop_after:
        cmd += ["--stop-after", str(stop_after)]
    r = subprocess.run(cmd, cwd=REPO, env=env, capture_output=True,
                       text=True, timeout=600)
    assert r.returncode == 0, r.stdout[-1500:] + r.stderr[-1500:]
    return r.stdout


def test_train_cli_resume_exact(tmp_path):
    """tests/test_training.py's check on the port's CLI: 20 straight steps
    == 10 steps + restart + 10 steps (the same last loss)."""
    straight = _cli(str(tmp_path / "a"), 20)
    _cli(str(tmp_path / "b"), 20, stop_after=10)   # simulated preemption
    resumed = _cli(str(tmp_path / "b"), 20)
    assert "resumed from checkpoint step 10" in resumed

    def last_loss(out):
        lines = [ln for ln in out.splitlines() if ln.startswith("step 19 ")]
        assert lines[-1].endswith("dp=1")
        return lines[-1].split("loss")[1].split()[0]

    assert last_loss(straight) == last_loss(resumed)


def _ckpt_tree(seed):
    """{"params": ..., "opt": AdamWState}: the train loop's checkpoint,
    bf16 params, as numpy."""
    rng = np.random.RandomState(seed)
    p = {"blocks": {"in_x": rng.randn(2, 4, 6), "A_log": rng.randn(2, 3)},
         "embed": {"embedding": rng.randn(8, 4)}, "final_norm": rng.randn(4)}
    f32 = jax.tree.map(lambda a: a.astype(np.float32), p)
    return p, f32


def _jax_ckpt(seed):
    p, f32 = _ckpt_tree(seed)
    params = jax.tree.map(lambda a: jnp.asarray(a, jnp.bfloat16), p)
    opt = jadamw_init(params)
    opt = opt._replace(step=jnp.asarray(7, jnp.int32),
                       mu=jax.tree.map(lambda a: jnp.asarray(a) * 0.5, f32),
                       nu=jax.tree.map(lambda a: jnp.asarray(a) ** 2, f32))
    return {"params": params, "opt": opt}


def _torch_ckpt(seed):
    p, f32 = _ckpt_tree(seed)
    t = lambda a: torch.tensor(a)  # noqa: E731
    params = jax.tree.map(lambda a: t(a).to(torch.bfloat16), p)
    opt = AdamWState(step=torch.tensor(7, dtype=torch.int32),
                     master=jax.tree.map(t, f32),
                     mu=jax.tree.map(lambda a: t(a) * 0.5, f32),
                     nu=jax.tree.map(lambda a: t(a) ** 2, f32))
    return {"params": params, "opt": opt}


def _bits(x):
    """A leaf's raw bytes, whichever package holds it."""
    if torch.is_tensor(x):
        x = x.view(torch.int16) if x.dtype == torch.bfloat16 else x
        return x.numpy().tobytes(), tuple(x.shape)
    a = np.asarray(x)
    a = a.view(np.int16) if a.dtype.name == "bfloat16" else a
    return a.tobytes(), a.shape


def _equal_bits(got, want):
    gl = sorted(jax.tree_util.tree_flatten_with_path(got)[0],
                key=lambda kv: jax.tree_util.keystr(kv[0]))
    wl = sorted(jax.tree_util.tree_flatten_with_path(want)[0],
                key=lambda kv: jax.tree_util.keystr(kv[0]))
    assert len(gl) == len(wl)
    for (gp, g), (wp, w) in zip(gl, wl):
        assert _bits(g) == _bits(w), jax.tree_util.keystr(gp)


def test_reference_checkpoint_restores_in_port(tmp_path):
    want = _jax_ckpt(1)
    jckpt.save_pytree(str(tmp_path / "ck"), want, {"step": 7})
    like = _torch_ckpt(2)
    got = load_pytree(str(tmp_path / "ck"), like)
    assert isinstance(got["opt"], AdamWState)
    assert got["params"]["blocks"]["in_x"].dtype == torch.bfloat16
    assert got["opt"].step.dtype == torch.int32
    _equal_bits(got, want)


def test_port_checkpoint_restores_in_reference(tmp_path):
    want = _torch_ckpt(3)
    mgr = CheckpointManager(str(tmp_path), keep=2)
    mgr.save(4, want, blocking=False)
    mgr.wait()
    assert mgr.latest_step() == 4
    names = sorted(os.listdir(tmp_path / "step_0000000004"))
    assert "00000__opt_master_blocks_in_x.npy" in names
    assert "00000__opt_step.npy" in names and "MANIFEST.json" in names
    jmgr = jckpt.CheckpointManager(str(tmp_path), keep=2)
    step, got = jmgr.restore(_jax_ckpt(4))
    assert step == 4
    assert got["params"]["blocks"]["in_x"].dtype.name == "bfloat16"
    _equal_bits(got, want)
    assert jckpt.load_metadata(str(tmp_path / "step_0000000004")) == \
        {"step": 4}


def test_checkpoint_manager_retention_and_tmp_cleanup(tmp_path):
    mgr = CheckpointManager(str(tmp_path), keep=2)
    os.makedirs(tmp_path / "step_0000000099.tmp")      # a crashed writer
    tree = _torch_ckpt(5)
    for s in (1, 2, 3):
        mgr.save(s, tree, blocking=s == 3)
    assert mgr.steps() == [2, 3]
    assert not any(d.endswith(".tmp") for d in os.listdir(tmp_path))
    step, got = mgr.restore(_torch_ckpt(6))
    assert step == 3
    _equal_bits(got, tree)
    save_pytree(str(tmp_path / "one"), tree["params"])
    with pytest.raises(ValueError, match="shape"):
        load_pytree(str(tmp_path / "one"),
                    {**tree["params"], "final_norm": torch.zeros(5)})


def test_cli_refuses_more_than_one_device(monkeypatch):
    """What the CLI still refuses since data and tensor parallelism run
    (`tests/test_torch_dp.py`, `tests/test_torch_tp.py`): a model axis
    above 1 in one process (it needs that many ranks), and nccl where it
    cannot run: two ranks on a host with one card (ranks share a card
    over gloo only) and the CPU.  Each raises before joining a process
    group."""
    argv = ["--arch", "qwen3-1.7b", "--reduced", "--device", "cpu",
            "--steps", "1"]
    with pytest.raises(ValueError, match="--model-axis 2 needs"):
        train.main(argv + ["--model-axis", "2"])
    for k, v in (("WORLD_SIZE", "2"), ("RANK", "0"), ("LOCAL_RANK", "0"),
                 ("LOCAL_WORLD_SIZE", "2")):
        monkeypatch.setenv(k, v)
    monkeypatch.setattr(torch.cuda, "is_available", lambda: True)
    monkeypatch.setattr(torch.cuda, "device_count", lambda: 1)
    with pytest.raises(ValueError, match="nccl needs one card a rank"):
        train.main(["--arch", "qwen3-1.7b", "--reduced", "--steps", "1",
                    "--dist-backend", "nccl"])
    with pytest.raises(ValueError, match="nccl runs on cards only"):
        train.main(argv)


def test_cli_needs_a_card_unless_asked_for_the_cpu():
    if torch.cuda.is_available():
        pytest.skip("a card is present: the default device is valid here")
    with pytest.raises(RuntimeError, match="cuda"):
        train.main(["--arch", "qwen3-1.7b", "--reduced", "--steps", "1"])


def test_cli_straggler_checkpoints_and_exits_75(tmp_path, capsys):
    """--deadline-factor 0 makes every step after the first four a
    straggler: --max-incidents 2 checkpoints step 6 and exits 75."""
    rc = train.main(["--arch", "qwen3-1.7b", "--reduced", "--device", "cpu",
                     "--steps", "20", "--seq-len", "16", "--batch", "2",
                     "--ckpt-dir", str(tmp_path), "--deadline-factor", "0",
                     "--max-incidents", "2", "--save-every", "100"])
    assert rc == 75
    out = capsys.readouterr().out
    assert "checkpoint-and-exit" in out and "incident 2" in out
    assert CheckpointManager(str(tmp_path)).latest_step() == 6
