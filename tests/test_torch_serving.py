"""The port's serving path (`repro_torch.serving.GenerationEngine` over
`launch.steps` and `models.api`) against the reference's engine, and the
reference's engine tests (`tests/test_serving.py`) on the port.

mamba2-130m REDUCED in float32 (as the reference's serving tests run it),
and zamba2-2.7b, qwen3-1.7b and qwen3-moe-30b-a3b REDUCED likewise, the
reference's parameters carried across, the same requests: the greedy
outputs must be equal token for token (the MoE's against the reference
with ROADMAP C5 repaired, `test_torch_moe._c5_free_dispatch`).  On the CPU the scan runs its plain
version; on a card the same engine launches kernel B2 (`chip_smoke.py`).
"""
import dataclasses
import os
import subprocess
import sys
from pathlib import Path

import jax
import numpy as np
import pytest
import torch

from repro import configs as jconfigs
from repro.models import api as japi
from repro.models import moe as jmoe
from repro.serving import GenerationEngine as JEngine
from repro.serving import Request as JRequest

from repro_torch import configs, interop
from repro_torch.launch import serve
from repro_torch.models import api
from repro_torch.serving import GenerationEngine, Request
from test_torch_moe import _c5_free_dispatch

ROOT = Path(__file__).resolve().parents[1]
F32 = dict(param_dtype="float32", activation_dtype="float32")
ARCH = "mamba2-130m"


def _jax_setup():
    jcfg = dataclasses.replace(jconfigs.get_reduced(ARCH), **F32)
    return jcfg, japi.init(jax.random.PRNGKey(0), jcfg)


def _engine(batch=4, max_len=48, params=None):
    """The port's engine on the CPU; by default with the reference's
    parameters (PRNGKey(0)) carried across."""
    cfg = dataclasses.replace(configs.get_reduced(ARCH), **F32)
    if params is None:
        params = interop.mamba2_params_from_numpy(
            jax.tree.map(np.asarray, _jax_setup()[1]), cfg, device="cpu")
    return GenerationEngine(params, cfg, max_len=max_len, batch_size=batch,
                            device="cpu"), cfg


def _prompts(seed, lengths, vocab):
    rng = np.random.RandomState(seed)
    return [rng.randint(0, vocab, size=n).astype(np.int32) for n in lengths]


@pytest.mark.parametrize("lengths,max_new", [
    ((4, 9, 16, 7), (3, 6, 2, 5)),      # left padding, ragged lengths
    ((8, 8), (6, 6)),                   # equal lengths, one slot empty
    ((5,), (12,)),
])
def test_greedy_outputs_equal_reference(lengths, max_new):
    jcfg, jparams = _jax_setup()
    jengine = JEngine(jparams, jcfg, max_len=48, batch_size=4)
    engine, cfg = _engine()
    prompts = _prompts(sum(lengths), lengths, cfg.vocab_size)
    want = jengine.generate([JRequest(prompt=p, max_new_tokens=m)
                             for p, m in zip(prompts, max_new)])
    got = engine.generate([Request(prompt=p, max_new_tokens=m)
                           for p, m in zip(prompts, max_new)])
    for g, w in zip(got, want):
        np.testing.assert_array_equal(g.output, np.asarray(w.output))


# the hybrid and dense families: zamba2's shared attention block and
# qwen3's attention (qk-norm, GQA, tied embeddings) over a KV cache
LM_ARCHS = ["zamba2-2.7b", "qwen3-1.7b"]
_lm = {}


def _lm_setup(arch):
    """(reference engine, port engine, port cfg) for `arch` REDUCED in
    float32, the reference's parameters (PRNGKey(0)) carried across."""
    if arch not in _lm:
        jcfg = dataclasses.replace(jconfigs.get_reduced(arch), **F32)
        cfg = dataclasses.replace(configs.get_reduced(arch), **F32)
        jparams = japi.init(jax.random.PRNGKey(0), jcfg)
        conv = (interop.zamba2_params_from_numpy if cfg.family == "hybrid"
                else interop.transformer_params_from_numpy)
        params = conv(jax.tree.map(np.asarray, jparams), cfg, device="cpu")
        _lm[arch] = (JEngine(jparams, jcfg, max_len=48, batch_size=4),
                     GenerationEngine(params, cfg, max_len=48, batch_size=4,
                                      device="cpu"), cfg)
    return _lm[arch]


@pytest.mark.parametrize("lengths,max_new", [
    ((4, 9, 16, 7), (3, 6, 2, 5)),      # left padding, ragged lengths
    ((8, 8), (6, 6)),                   # equal lengths, one slot empty
])
@pytest.mark.parametrize("arch", LM_ARCHS)
def test_hybrid_and_dense_outputs_equal_reference(arch, lengths, max_new):
    """The reference engine's greedy outputs token for token: prompts
    left-padded with token 0, which real tokens attend to, positions from
    0 on every row (no padding mask, as in the reference)."""
    jengine, engine, cfg = _lm_setup(arch)
    prompts = _prompts(sum(lengths), lengths, cfg.vocab_size)
    want = jengine.generate([JRequest(prompt=p, max_new_tokens=m)
                             for p, m in zip(prompts, max_new)])
    got = engine.generate([Request(prompt=p, max_new_tokens=m)
                           for p, m in zip(prompts, max_new)])
    for g, w in zip(got, want):
        np.testing.assert_array_equal(g.output, np.asarray(w.output))


@pytest.mark.parametrize("lengths,max_new", [
    ((4, 9, 16, 7), (3, 6, 2, 5)),      # left padding, ragged lengths
    ((8, 8), (6, 6)),                   # equal lengths, one slot empty
])
def test_moe_outputs_equal_reference(lengths, max_new, monkeypatch):
    """REDUCED qwen3-moe at its capacity factor 1.25: prefill drops
    entries and decode routes 4 tokens (empty slots among them) at
    C = K.  The reference runs with its dispatch repaired (C5), patched in
    before its engine traces."""
    monkeypatch.setattr(jmoe, "_dispatch_group", _c5_free_dispatch)
    arch = "qwen3-moe-30b-a3b"
    jcfg = dataclasses.replace(jconfigs.get_reduced(arch), **F32)
    cfg = dataclasses.replace(configs.get_reduced(arch), **F32)
    jparams = japi.init(jax.random.PRNGKey(0), jcfg)
    params = interop.transformer_params_from_numpy(
        jax.tree.map(np.asarray, jparams), cfg, device="cpu")
    jengine = JEngine(jparams, jcfg, max_len=48, batch_size=4)
    engine = GenerationEngine(params, cfg, max_len=48, batch_size=4,
                              device="cpu")
    prompts = _prompts(sum(lengths), lengths, cfg.vocab_size)
    want = jengine.generate([JRequest(prompt=p, max_new_tokens=m)
                             for p, m in zip(prompts, max_new)])
    got = engine.generate([Request(prompt=p, max_new_tokens=m)
                           for p, m in zip(prompts, max_new)])
    for g, w in zip(got, want):
        np.testing.assert_array_equal(g.output, np.asarray(w.output))


@pytest.mark.parametrize("arch", LM_ARCHS + ["qwen3-moe-30b-a3b"])
def test_hybrid_and_dense_serve_cli_on_cpu(arch):
    out = subprocess.run(
        [sys.executable, "-m", "repro_torch.launch.serve", "--device", "cpu",
         "--arch", arch, "--reduced", "--num-requests", "3", "--batch", "2",
         "--max-new", "4"], capture_output=True, text=True, timeout=300,
        cwd=ROOT, env={**os.environ, "PYTHONPATH": str(ROOT / "src")})
    assert out.returncode == 0, out.stderr
    assert "served 3 requests, 12 tokens" in out.stdout


@pytest.mark.parametrize("arch", ["whisper-medium",
                                  "llava-next-mistral-7b"])
def test_serve_cli_refuses_stub_families(arch):
    """The vlm and encdec batches carry stub embeddings the engine does not
    take: the CLI refuses them, as the reference's does."""
    with pytest.raises(SystemExit, match="text-in"):
        serve.main(["--device", "cpu", "--arch", arch, "--reduced"])


def test_eos_outputs_equal_reference():
    jcfg, jparams = _jax_setup()
    jengine = JEngine(jparams, jcfg, max_len=48, batch_size=4)
    engine, cfg = _engine()
    prompt = _prompts(3, (6,), cfg.vocab_size)[0]
    full = engine.generate([Request(prompt=prompt, max_new_tokens=8)])[0]
    eos = int(full.output[3])
    want = jengine.generate([JRequest(prompt=prompt, max_new_tokens=8,
                                      eos_id=eos)])[0]
    got = engine.generate([Request(prompt=prompt, max_new_tokens=8,
                                   eos_id=eos)])[0]
    np.testing.assert_array_equal(got.output, np.asarray(want.output))


class TestEngine:
    """tests/test_serving.py::TestEngine on the port."""

    def test_generates_requested_lengths(self):
        engine, cfg = _engine()
        reqs = [Request(prompt=p, max_new_tokens=m) for p, m in zip(
            _prompts(0, (4, 9, 16, 7), cfg.vocab_size), (3, 6, 2, 5))]
        engine.generate(reqs)
        for r, m in zip(reqs, [3, 6, 2, 5]):
            assert r.output.shape == (m,)
            assert np.all((r.output >= 0) & (r.output < cfg.vocab_size))

    def test_greedy_is_deterministic(self):
        engine, cfg = _engine()
        prompt = _prompts(1, (8,), cfg.vocab_size)[0]
        a = engine.generate([Request(prompt=prompt, max_new_tokens=6)])[0]
        b = engine.generate([Request(prompt=prompt, max_new_tokens=6)])[0]
        np.testing.assert_array_equal(a.output, b.output)

    def test_batching_matches_single(self):
        engine, cfg = _engine(batch=3)
        prompts = _prompts(2, (8, 8, 8), cfg.vocab_size)
        together = engine.generate(
            [Request(prompt=p, max_new_tokens=4) for p in prompts])
        for i, p in enumerate(prompts):
            alone = engine.generate([Request(prompt=p, max_new_tokens=4)])[0]
            np.testing.assert_array_equal(together[i].output, alone.output)

    def test_eos_truncation(self):
        engine, cfg = _engine()
        prompt = _prompts(3, (6,), cfg.vocab_size)[0]
        r = engine.generate([Request(prompt=prompt, max_new_tokens=8)])[0]
        full = r.output.copy()
        eos = int(full[2])
        first = int(np.nonzero(full == eos)[0][0])  # may repeat earlier
        r2 = engine.generate([Request(prompt=prompt, max_new_tokens=8,
                                      eos_id=eos)])[0]
        np.testing.assert_array_equal(r2.output, full[:first + 1])
        assert r2.output[-1] == eos

    def test_capacity_guard(self):
        engine, cfg = _engine(batch=2)
        reqs = [Request(prompt=np.zeros(4, np.int32)) for _ in range(3)]
        with pytest.raises(ValueError):
            engine.generate(reqs)


def test_random_init_serves():
    """The port's own random init (a seed) serves too (the reference's
    test_ssm_families_serve)."""
    cfg = dataclasses.replace(configs.get_reduced(ARCH), **F32)
    engine, _ = _engine(batch=2, params=api.init(0, cfg, device="cpu"))
    reqs = [Request(prompt=p, max_new_tokens=4)
            for p in _prompts(0, (5, 5), cfg.vocab_size)]
    engine.generate(reqs)
    for r in reqs:
        assert r.output.shape == (4,)


def test_serve_cli_on_cpu():
    out = subprocess.run(
        [sys.executable, "-m", "repro_torch.launch.serve", "--device", "cpu",
         "--arch", ARCH, "--reduced", "--num-requests", "3", "--batch", "2",
         "--max-new", "4"], capture_output=True, text=True, timeout=300,
        cwd=ROOT, env={**os.environ, "PYTHONPATH": str(ROOT / "src")})
    assert out.returncode == 0, out.stderr
    assert "served 3 requests, 12 tokens" in out.stdout
    assert out.stdout.count("req[") == 3


def test_entry_points_default_to_the_card():
    """Without device="cpu" the serving entry points raise here."""
    if torch.cuda.is_available():
        pytest.skip("a card is present: the default device is valid here")
    cfg = configs.get_reduced(ARCH)
    with pytest.raises(RuntimeError, match="cuda"):
        api.init(0, cfg)
    with pytest.raises(RuntimeError, match="cuda"):
        api.make_cache(cfg, 2, 16)
    params = api.init(0, cfg, device="cpu")
    with pytest.raises(RuntimeError, match="cuda"):
        GenerationEngine(params, cfg, max_len=16, batch_size=2)
    with pytest.raises(RuntimeError, match="cuda"):
        serve.main(["--arch", ARCH, "--reduced"])
