"""The port's attention half of `models.layers` (`repro_torch.models.layers`)
against the reference's `repro.models.layers`, on the same inputs: RoPE,
`sdpa` (causal, GQA, MQA, `kv_len`, the real configs' head widths),
`attention_block`, `attention_decode` and both MLPs, the reference's
parameters carried across as numpy.  Float32, at the tolerances of
`tests/test_attention.py` (rtol 1e-5, atol 1e-6).
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro import configs as jconfigs
from repro.models import layers as JL

from repro_torch import configs
from repro_torch.models import layers as L

RTOL, ATOL = 1e-5, 1e-6
F32 = dict(param_dtype="float32", activation_dtype="float32")


def _rand(shape, seed):
    return np.random.RandomState(seed).randn(*shape).astype(np.float32)


def _close(got, want):
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=RTOL,
                               atol=ATOL)


def _t(a):
    """A writable torch copy of a numpy or JAX array."""
    return torch.tensor(np.array(a))


@pytest.mark.parametrize("hd,theta", [(16, 1e4), (80, 1e4), (128, 1e6)])
def test_rope_matches(hd, theta):
    x = _rand((2, 9, 3, hd), 0)
    pos = np.stack([np.arange(9), np.arange(9) + 5]).astype(np.int32)
    _close(L.rope(_t(x), _t(pos), theta),
           JL.rope(jnp.asarray(x), jnp.asarray(pos), theta))


# (B, Sq, Skv, H, Hkv, hd): MHA, GQA, MQA
SDPA_SHAPES = [(2, 8, 8, 4, 4, 16), (2, 8, 8, 8, 2, 16), (2, 6, 6, 4, 1, 20)]


@pytest.mark.parametrize("causal", [True, False])
@pytest.mark.parametrize("shape", SDPA_SHAPES,
                         ids=["mha", "gqa", "mqa"])
def test_sdpa_matches(shape, causal):
    B, Sq, Skv, H, Hkv, hd = shape
    q, k, v = _rand((B, Sq, H, hd), 1), _rand((B, Skv, Hkv, hd), 2), \
        _rand((B, Skv, Hkv, hd), 3)
    want = JL.sdpa(jnp.asarray(q), jnp.asarray(k), jnp.asarray(v),
                   causal=causal)
    _close(L.sdpa(_t(q), _t(k), _t(v), causal=causal), want)


def test_sdpa_kv_len_and_q_positions_match():
    """Decode-shaped queries against a padded cache: `kv_len` per row,
    and causal rows offset by `q_positions`."""
    B, Skv, H, Hkv, hd = 2, 10, 4, 2, 8
    q = _rand((B, 1, H, hd), 4)
    k, v = _rand((B, Skv, Hkv, hd), 5), _rand((B, Skv, Hkv, hd), 6)
    kv_len = np.array([4, 9], np.int32)
    want = JL.sdpa(jnp.asarray(q), jnp.asarray(k), jnp.asarray(v),
                   causal=False, kv_len=jnp.asarray(kv_len))
    got = L.sdpa(_t(q), _t(k), _t(v), causal=False, kv_len=_t(kv_len))
    _close(got, want)
    q3 = _rand((B, 3, H, hd), 7)
    qpos = np.array([[2, 3, 4], [6, 7, 8]], np.int32)
    want = JL.sdpa(jnp.asarray(q3), jnp.asarray(k), jnp.asarray(v),
                   causal=True, q_positions=jnp.asarray(qpos),
                   kv_len=jnp.asarray(kv_len))
    got = L.sdpa(_t(q3), _t(k), _t(v), causal=True, q_positions=_t(qpos),
                 kv_len=_t(kv_len))
    _close(got, want)


# (H, Hkv, hd) of zamba2's shared block, qwen3-1.7b and granite-34b (MQA)
REAL_HEADS = [(32, 32, 80), (16, 8, 128), (48, 1, 128)]


@pytest.mark.parametrize("causal", [True, False])
@pytest.mark.parametrize("heads", REAL_HEADS,
                         ids=["zamba2", "qwen3", "granite"])
def test_sdpa_matches_at_real_head_widths(heads, causal):
    """The full-width configs' head counts and widths, at a short
    sequence."""
    H, Hkv, hd = heads
    B, S = 2, 24
    q, k, v = _rand((B, S, H, hd), 8), _rand((B, S, Hkv, hd), 9), \
        _rand((B, S, Hkv, hd), 10)
    want = JL.sdpa(jnp.asarray(q), jnp.asarray(k), jnp.asarray(v),
                   causal=causal)
    _close(L.sdpa(_t(q), _t(k), _t(v), causal=causal), want)


# qk-norm + GQA (qwen3), qkv bias (qwen2), MQA (granite), MHA with
# head_dim 16 (zamba2's shared block), head_dim 20 (stablelm)
ARCHS = ["qwen3-1.7b", "qwen2-7b", "granite-34b", "zamba2-2.7b",
         "stablelm-12b"]


def _attn_setup(name, seed=0):
    jcfg = dataclasses.replace(jconfigs.get_reduced(name), **F32)
    cfg = dataclasses.replace(configs.get_reduced(name), **F32)
    jp = JL.init_attention(jax.random.PRNGKey(seed), jcfg)
    if cfg.qkv_bias:        # the reference's init makes zero biases
        jp = {**jp, **{b: jnp.asarray(_rand(jp[b].shape, 20 + i))
                       for i, b in enumerate(("bq", "bk", "bv"))}}
    if cfg.qk_norm:
        jp = {**jp, **{n: jnp.asarray(1 + 0.1 * _rand(jp[n].shape, 30 + i))
                       for i, n in enumerate(("q_norm", "k_norm"))}}
    tp = {k: _t(v) for k, v in jp.items()}
    assert {k: tuple(v.shape) for k, v in tp.items()} == \
        L.attention_shapes(cfg)
    return jcfg, cfg, jp, tp


@pytest.mark.parametrize("name", ARCHS)
def test_attention_block_matches(name):
    jcfg, cfg, jp, tp = _attn_setup(name)
    B, S = 2, 11
    x = _rand((B, S, cfg.d_model), 11)
    pos = np.broadcast_to(np.arange(S, dtype=np.int32), (B, S)).copy()
    want, (wk, wv) = JL.attention_block(jp, jcfg, jnp.asarray(x),
                                        jnp.asarray(pos))
    got, (gk, gv) = L.attention_block(tp, cfg, _t(x), _t(pos))
    _close(got, want)
    _close(gk, wk)
    _close(gv, wv)


@pytest.mark.parametrize("name", ARCHS)
def test_attention_decode_matches(name):
    """One token against a cache whose rows hold different lengths (3 and
    6): the output, and both caches with the new k/v written at each row's
    position and nothing else changed."""
    jcfg, cfg, jp, tp = _attn_setup(name)
    B, Smax, Hkv, hd = 2, 8, cfg.num_kv_heads, cfg.hd()
    x = _rand((B, 1, cfg.d_model), 12)
    kc, vc = _rand((B, Smax, Hkv, hd), 13), _rand((B, Smax, Hkv, hd), 14)
    pos = np.array([3, 6], np.int32)
    want, wk, wv = JL.attention_decode(jp, jcfg, jnp.asarray(x),
                                       jnp.asarray(kc), jnp.asarray(vc),
                                       jnp.asarray(pos))
    tk, tv = _t(kc), _t(vc)
    got, gk, gv = L.attention_decode(tp, cfg, _t(x), tk, tv, _t(pos))
    assert gk is tk and gv is tv              # written in place
    _close(got, want)
    _close(gk, wk)
    _close(gv, wv)


def test_mlp_matches():
    jcfg = dataclasses.replace(jconfigs.get_reduced("qwen3-1.7b"), **F32)
    cfg = dataclasses.replace(configs.get_reduced("qwen3-1.7b"), **F32)
    jp = JL.init_mlp(jax.random.PRNGKey(1), jcfg)
    tp = {k: _t(v) for k, v in jp.items()}
    assert {k: tuple(v.shape) for k, v in tp.items()} == L.mlp_shapes(cfg)
    x = _rand((2, 5, cfg.d_model), 15)
    _close(L.mlp_block(tp, _t(x)), JL.mlp_block(jp, jnp.asarray(x)))


def test_mlp_gelu_matches():
    """granite's 2-matrix MLP with biases; jax.nn.gelu's default is the
    tanh approximation."""
    jcfg = dataclasses.replace(jconfigs.get_reduced("granite-34b"), **F32)
    cfg = dataclasses.replace(configs.get_reduced("granite-34b"), **F32)
    jp = JL.init_mlp_gelu(jax.random.PRNGKey(2), jcfg)
    jp = {**jp, "b_in": jnp.asarray(_rand(jp["b_in"].shape, 16)),
          "b_out": jnp.asarray(_rand(jp["b_out"].shape, 17))}
    tp = {k: _t(v) for k, v in jp.items()}
    assert {k: tuple(v.shape) for k, v in tp.items()} == L.mlp_shapes(cfg)
    x = 2 * _rand((2, 5, cfg.d_model), 18)
    _close(L.mlp_gelu_block(tp, _t(x)), JL.mlp_gelu_block(jp, jnp.asarray(x)))


def test_init_shapes_and_dtypes():
    """The port's random attention and MLP init has the reference's names,
    shapes and dtypes (numbers differ: torch.Generator, not jax.random)."""
    for name in ARCHS:
        jcfg, cfg = jconfigs.get_reduced(name), configs.get_reduced(name)
        gen = torch.Generator().manual_seed(0)
        for tfn, jfn in ((L.init_attention, JL.init_attention),
                         ((L.init_mlp_gelu, JL.init_mlp_gelu)
                          if cfg.mlp_type == "gelu"
                          else (L.init_mlp, JL.init_mlp))):
            tp = tfn(gen, cfg)
            jp = jfn(jax.random.PRNGKey(0), jcfg)
            assert set(tp) == set(jp), name
            for k in tp:
                assert tuple(tp[k].shape) == jp[k].shape, (name, k)
                assert str(tp[k].dtype).split(".")[-1] == \
                    str(jp[k].dtype), (name, k)
