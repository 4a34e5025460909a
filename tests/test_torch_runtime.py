"""The run-time knobs (`repro_torch.models.runtime`, port of
`repro.models.runtime`) against the reference's, on the CPU, float32.

(a) `layers.sdpa` with `runtime.attn_q_chunk(qc)`: the queries in chunks
    against the reference's `sdpa` under its own `attn_q_chunk(qc)` (its
    `lax.scan` over the chunks), causal, with `kv_len`, and with
    `q_positions`; and against the port's own unchunked scores: rtol
    1e-5, atol 1e-6 x max(1, max|ref|).  A length the chunk does not
    divide takes the whole scores, as the reference does.
(b) `moe.moe_block` with `runtime.moe_dp_groups(G)`, G = 2 and 4, at
    drops (the router weighed to expert 0) against the reference's under
    its `moe_dp_groups(G)`, with ROADMAP C5 repaired in the reference
    (`test_torch_moe._c5_free_dispatch`, patched in): rtol 1e-4, atol
    1e-5 x max(1, max|ref|) (the tolerance of `tests/test_torch_moe.py`);
    the groups drop differently from one dispatch, and G that leaves a
    group fewer tokens than experts falls back to one, as the reference.
(c) The knobs are process-wide and restored on exit.
"""
import dataclasses

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.models import layers as JL
from repro.models import moe as jmoe
from repro.models import runtime as jruntime

from repro_torch.models import layers as L
from repro_torch.models import moe, runtime

from test_torch_moe import _c5_free_dispatch, _configs, _model

SDPA_RTOL, SDPA_ATOL = 1e-5, 1e-6
MOE_RTOL, MOE_ATOL = 1e-4, 1e-5


def _rand(shape, seed):
    return np.random.default_rng(seed).standard_normal(shape).astype(
        np.float32)


def _close(got, want, rtol, atol):
    want = np.asarray(want, np.float32)
    np.testing.assert_allclose(got.numpy(), want, rtol=rtol,
                               atol=atol * max(1.0, np.abs(want).max()))


@pytest.mark.parametrize("case", ["causal", "kv_len", "q_positions"])
@pytest.mark.parametrize("qc", [4, 8])
def test_chunked_sdpa_matches_reference(case, qc):
    B, Sq, H, Hkv, hd = 2, 16, 4, 2, 8
    Skv = Sq if case == "causal" else 20
    q = _rand((B, Sq, H, hd), 1)
    k, v = _rand((B, Skv, Hkv, hd), 2), _rand((B, Skv, Hkv, hd), 3)
    kw = {"causal": case != "kv_len"}
    if case != "causal":
        kw["kv_len"] = np.array([13, 20], np.int32)
    if case == "q_positions":
        kw["q_positions"] = np.stack([np.arange(Sq) + 2,
                                      np.arange(Sq) + 4]).astype(np.int32)
    jkw = {k_: jnp.asarray(v_) if isinstance(v_, np.ndarray) else v_
           for k_, v_ in kw.items()}
    tkw = {k_: torch.as_tensor(v_) if isinstance(v_, np.ndarray) else v_
           for k_, v_ in kw.items()}
    args = [torch.as_tensor(a) for a in (q, k, v)]
    with jruntime.attn_q_chunk(qc):
        want = JL.sdpa(jnp.asarray(q), jnp.asarray(k), jnp.asarray(v), **jkw)
    with runtime.attn_q_chunk(qc):
        got = L.sdpa(*args, **tkw)
    _close(got, want, SDPA_RTOL, SDPA_ATOL)
    _close(got, L.sdpa(*args, **tkw), SDPA_RTOL, SDPA_ATOL)


def test_chunk_that_does_not_divide_takes_whole_scores(monkeypatch):
    """Sq = 12 with a chunk of 8 (and Sq <= chunk): one call of the
    whole-scores body, as the reference's condition."""
    calls = []
    full = L._sdpa_full

    def counting(q, *a, **kw):
        calls.append(q.shape[1])
        return full(q, *a, **kw)

    monkeypatch.setattr(L, "_sdpa_full", counting)
    q, k = _rand((1, 12, 2, 4), 4), _rand((1, 12, 2, 4), 5)
    for qc in (8, 12, 16):
        calls.clear()
        with runtime.attn_q_chunk(qc):
            L.sdpa(torch.as_tensor(q), torch.as_tensor(k),
                   torch.as_tensor(k), causal=True)
        assert calls == [12], (qc, calls)
    calls.clear()
    with runtime.attn_q_chunk(4):
        L.sdpa(torch.as_tensor(q), torch.as_tensor(k), torch.as_tensor(k),
               causal=True)
    assert calls == [4, 4, 4]


GB, GS = 4, 8                  # 32 tokens: 2 groups of 16, 4 of 8


def _drops_case(name):
    """(jcfg, tcfg, reference layer-0 MoE params, the port's, x) with the
    router weighed toward expert 0, so its capacity overflows."""
    jcfg, tcfg = _configs(name, drops=True)
    p = {k: np.array(v[0]) for k, v in _model(name)["blocks"]["moe"].items()}
    x = _rand((GB, GS, tcfg.d_model), 6)
    x[..., 0] = 3.0
    p["router"][0] = 0.0
    p["router"][0, 0] = 2.0
    return jcfg, tcfg, p, {k: torch.as_tensor(v) for k, v in p.items()}, x


@pytest.mark.parametrize("G", [2, 4])
@pytest.mark.parametrize("name", ["qwen3-moe-30b-a3b", "dbrx-132b"])
def test_moe_groups_match_reference(name, G, monkeypatch):
    monkeypatch.setattr(jmoe, "_dispatch_group", _c5_free_dispatch)
    jcfg, tcfg, p, tp, x = _drops_case(name)
    n = GB * GS
    assert n // G >= tcfg.num_experts
    drops = []
    dispatch = moe.dispatch

    def counting(*a, **kw):
        d = dispatch(*a, **kw)
        drops.append(int((~d.keep).sum()))
        return d

    monkeypatch.setattr(moe, "dispatch", counting)
    with jruntime.moe_dp_groups(G):
        want, waux = jmoe.moe_block(p, jcfg, jnp.asarray(x))
    with runtime.moe_dp_groups(G):
        assert moe.groups(n, tcfg) == G
        got, gaux = moe.moe_block(tp, tcfg, torch.as_tensor(x))
    assert len(drops) == G and sum(drops) > 0
    _close(got, want, MOE_RTOL, MOE_ATOL)
    np.testing.assert_allclose(float(gaux), float(waux), rtol=MOE_RTOL)
    one, _ = moe.moe_block(tp, tcfg, torch.as_tensor(x))
    assert not torch.allclose(one, got)       # the groups drop otherwise


def test_groups_fall_back_to_one():
    """The reference's rule: G <= 1, G not dividing N, or fewer tokens a
    group than experts give one group; a data-parallel rank takes G / R
    of them (R ranks)."""
    cfg = dataclasses.replace(_configs("qwen3-moe-30b-a3b")[1])
    E = cfg.num_experts
    for g, n, want in ((1, 64, 1), (3, 64, 1), (2, 2 * E, 2),
                       (2, 2 * E - 2, 1), (4, 2 * E, 1)):
        with runtime.moe_dp_groups(g):
            assert moe.groups(n, cfg) == want, (g, n)


def test_knobs_are_restored():
    assert runtime.ATTN_Q_CHUNK == 0 and runtime.MOE_DP_GROUPS == 1
    with runtime.attn_q_chunk(1024), runtime.moe_dp_groups(16):
        assert (runtime.ATTN_Q_CHUNK, runtime.MOE_DP_GROUPS) == (1024, 16)
        with pytest.raises(RuntimeError):
            with runtime.attn_q_chunk(8):
                raise RuntimeError
        assert runtime.ATTN_Q_CHUNK == 1024
    assert runtime.ATTN_Q_CHUNK == 0 and runtime.MOE_DP_GROUPS == 1
