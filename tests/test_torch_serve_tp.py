"""Serving under sharding rules across processes (`launch.steps`'
prefill and decode steps with rules, `serve_step`,
`serving.engine.GenerationEngine(rules=)`, the models' decode under a
model axis, the caches split as `ShardingRules.cache_pspecs` lays them
out) on the CPU: ``gloo`` ranks spawned by `_torch_serve_workers`,
REDUCED configs in float32 with float32 caches, prompts from numpy's
seeded generator.

(a) Two ranks as (1, 2): mamba2-130m (heads, the B/C columns of the conv
    state), zamba2-2.7b (its Mamba2 blocks and the shared attention's
    heads), qwen3-1.7b (heads with their kv heads, the tied vocabulary),
    qwen3-moe-30b-a3b (experts and heads) and whisper-medium (self- and
    cross-attention caches); and four ranks as (2, 2), the batch's rows
    split over the data axis too (the MoE held to one process under
    `runtime.moe_dp_groups(2)`, each rank dispatching its rows).  The
    next tokens of the prefill and of 4 decode steps equal one
    process's, on every rank, and the logits, gathered whole over the
    vocabulary, are within LOGITS_TOL of max|logits| of one process's;
    the engine's outputs equal one process's engine's.
    Also mamba2 with 3 heads, which a model axis of 2 cuts: every rank
    runs its blocks whole (`models.mamba2._whole_if_cut`).
(b) Batch 1 on two data ranks, (2, 1): the batch does not divide the
    data axis, so the attention caches hold half the positions each (the
    sequence-split KV cache, `process_group.kv_sequence`) and decode's
    softmax is split over the ranks; the prompt (14 positions) lies in
    rank 0's half and the decode steps cross into rank 1's.  zamba2-2.7b
    and qwen3-1.7b, the same limits.
(c) Every case's gathered logits of the prefill and the decode steps
    against the reference's (`repro.models.api.prefill` / `decode_step`,
    float32 caches) on the same params and prompts, fed the same tokens:
    within REF_RTOL and REF_ATOL x max|logits|, the limits of the
    one-process tests of each model (`tests/test_torch_transformer.py`
    and the others); the MoE with ROADMAP C5 repaired
    (`test_torch_moe._c5_free_dispatch`) under the same groups.
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro import configs as jconfigs
from repro.models import api as japi
from repro.models import moe as jmoe
from repro.models import runtime as jruntime

from repro_torch.models import api, runtime
from repro_torch.serving.engine import GenerationEngine, Request

import _torch_serve_workers as W
from test_torch_moe import _c5_free_dispatch

LOGITS_TOL = 1e-5          # max|logits - one process's| / max|one's|
REF_RTOL, REF_ATOL = 1e-4, 1e-5   # against the reference, as _close
MAX_LEN, N_DECODE = 32, 4
TIMEOUT = 180.0
BATCH, PLEN = 4, 12
# key: (arch, config overrides); 3 heads of 32 channels: a model axis of 2
# splits d_inner = 96 mid-head
CASES = {"mamba2-130m": ("mamba2-130m", {}),
         "mamba2-heads-cut": ("mamba2-130m", {"d_model": 48,
                                              "ssm_headdim": 32}),
         "zamba2-2.7b": ("zamba2-2.7b", {}),
         "qwen3-1.7b": ("qwen3-1.7b", {}),
         "qwen3-moe-30b-a3b": ("qwen3-moe-30b-a3b", {}),
         "whisper-medium": ("whisper-medium", {})}
ARCHS = list(CASES)
SEQ_SPLIT = ["zamba2-2.7b", "qwen3-1.7b"]
SEQ_PLEN = 14

_runs = {}


def _cases(keys, batch, plen):
    return [(key, CASES[key][0], batch, plen, CASES[key][1])
            for key in keys]


def _cfg(key):
    name, over = CASES[key]
    return dataclasses.replace(W.f32_reduced(name), **over)


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    """{2: {model axis: results}, 4: {...}}: one spawn a rank count."""
    if not _runs:
        tmp = tmp_path_factory.mktemp("serve")
        _runs[2] = W.run_ranks(
            W.serve_meshes, 2, str(tmp / "rdzv2"),
            ([(2, _cases(ARCHS, BATCH, PLEN)),
              (1, _cases(SEQ_SPLIT, 1, SEQ_PLEN))], MAX_LEN, N_DECODE),
            timeout=TIMEOUT)
        _runs[4] = W.run_ranks(
            W.serve_meshes, 4, str(tmp / "rdzv4"),
            ([(2, _cases(ARCHS, BATCH, PLEN))], MAX_LEN, N_DECODE),
            timeout=TIMEOUT)
    return _runs


def _one_process(key, batch, plen, groups=1):
    cfg = _cfg(key)
    params = api.init(0, cfg, None, device="cpu")
    with runtime.moe_dp_groups(groups):
        toks, logits = W.generate(cfg, params, W.prompts(cfg, batch, plen, 0),
                                  MAX_LEN, N_DECODE)
        engine = None
        if cfg.family not in ("encdec", "vlm"):
            eng = GenerationEngine(params, cfg, MAX_LEN, batch, "cpu")
            reqs = [Request(prompt=p.numpy(), max_new_tokens=N_DECODE + 1)
                    for p in W.prompts(cfg, batch, plen, 0)["tokens"]]
            engine = [r.output for r in eng.generate(reqs)]
    return toks, logits, engine


def _reference(key, batch, plen, groups, tokens):
    """The reference's last-position logits of the prefill and of a
    decode step for each of `tokens` but the last, fed in turn (the next
    tokens the ranks chose), on `api.init(0)`'s params and the same
    prompts."""
    name, over = CASES[key]
    jcfg = dataclasses.replace(jconfigs.get_reduced(name), **W.F32, **over)
    params = api.init(0, _cfg(key), None, device="cpu")
    jp = jax.tree.map(lambda t: jnp.asarray(t.numpy()), params)
    jb = {k: jnp.asarray(v.numpy())
          for k, v in W.prompts(_cfg(key), batch, plen, 0).items()}
    with jruntime.moe_dp_groups(groups):
        logits, cache = japi.prefill(jp, jcfg, jb, MAX_LEN,
                                     cache_dtype=jnp.float32)
        out = [np.asarray(logits[:, -1:])]
        for tok in tokens[:-1]:
            logits, cache = japi.decode_step(jp, jcfg, jnp.asarray(tok),
                                             cache)
            out.append(np.asarray(logits))
    return out


def _check(results, key, want, ref):
    toks, logits, engine = want
    for r, res in enumerate(results):
        got = res[key]
        for step, (g, w) in enumerate(zip(got["tokens"], toks)):
            np.testing.assert_array_equal(g, w, err_msg=f"rank {r} {step}")
        if engine is not None:
            for g, w in zip(got["engine"], engine):
                np.testing.assert_array_equal(g, w, err_msg=f"rank {r}")
    got = results[0][key]["logits"]
    for step, (g, w) in enumerate(zip(got, logits)):
        assert g.shape == w.shape
        gap = np.abs(g - w).max() / np.abs(w).max()
        assert gap <= LOGITS_TOL, (key, step, gap)
    want_ref = ref(results[0][key]["tokens"])
    assert len(want_ref) == len(got) == N_DECODE + 1
    for step, (g, w) in enumerate(zip(got, want_ref)):
        np.testing.assert_allclose(g, w, rtol=REF_RTOL,
                                   atol=REF_ATOL * np.abs(w).max(),
                                   err_msg=f"{key} step {step}")


def _held(key, batch, plen, groups, monkeypatch):
    monkeypatch.setattr(jmoe, "_dispatch_group", _c5_free_dispatch)
    return (_one_process(key, batch, plen, groups),
            lambda toks: _reference(key, batch, plen, groups, toks))


@pytest.mark.parametrize("key", ARCHS)
def test_two_model_ranks_serve_as_one_process(key, runs, monkeypatch):
    _check([r[2] for r in runs[2]], key,
           *_held(key, BATCH, PLEN, 1, monkeypatch))


@pytest.mark.parametrize("key", ARCHS)
def test_data_and_model_ranks_serve_as_one_process(key, runs, monkeypatch):
    """(2, 2): two rows a data rank; the MoE's one process and the
    reference dispatch the same two groups (`moe_dp_groups(2)`)."""
    groups = 2 if _cfg(key).family == "moe" else 1
    _check([r[2] for r in runs[4]], key,
           *_held(key, BATCH, PLEN, groups, monkeypatch))


@pytest.mark.parametrize("key", SEQ_SPLIT)
def test_sequence_split_cache_serves_as_one_process(key, runs, monkeypatch):
    assert SEQ_PLEN < MAX_LEN // 2 < SEQ_PLEN + N_DECODE
    _check([r[1] for r in runs[2]], key,
           *_held(key, 1, SEQ_PLEN, 1, monkeypatch))


def test_cache_is_this_ranks_share(monkeypatch):
    """Under the sequence split a rank's KV cache holds half the
    positions; under the model axis its heads (`layers.kv_cache_shape`),
    read from the leaves as `ShardingRules.cache_pspecs` cuts them."""
    from repro_torch.distributed import process_group as pg
    from repro_torch.distributed.sharding import ShardingRules
    from repro_torch.launch.mesh import make_rank_view
    from repro_torch.models import layers as L

    cfg = W.f32_reduced("qwen3-1.7b")
    p = api.param_specs(cfg)["blocks"]["attn"]
    whole = L.kv_cache_shape(p, cfg, 2, MAX_LEN)
    assert whole == (2, MAX_LEN, cfg.num_kv_heads, cfg.hd())
    mesh = make_rank_view((2, 1), ("data", "model"))
    with pg.kv_sequence(mesh.axis_groups["data"]):
        assert L.kv_cache_shape(p, cfg, 1, MAX_LEN)[1] == MAX_LEN // 2
    rules = ShardingRules(mesh=make_rank_view((1, 2), ("data", "model")),
                          cfg=cfg)
    spec = rules.param_pspecs({"wk": p["wk"]})["wk"]
    k, q = (torch.empty(w.shape[:2] + (w.shape[2] // 2, w.shape[3]),
                        device="meta") for w in (p["wk"], p["wq"]))
    assert spec[2] == "model"
    with pg.model_parallel(rules.mesh.axis_groups["model"]):
        got = L.kv_cache_shape({"wq": q, "wk": k}, cfg, 2, MAX_LEN)
    assert got == (2, MAX_LEN, cfg.num_kv_heads // 2, cfg.hd())
    cache = rules.cache_pspecs({"k": torch.empty(
        (cfg.num_layers, 2, MAX_LEN, cfg.num_kv_heads, cfg.hd()),
        device="meta")})
    assert cache["k"][3] == "model"
