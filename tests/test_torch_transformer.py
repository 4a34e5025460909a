"""The port's dense transformer (`repro_torch.models.transformer` through
`models.api`) against the reference's, with the reference's parameters
carried across (`interop.transformer_params_from_numpy`) and the same
tokens: the four dense REDUCED configs in float32, which between them run
qk-norm and tied embeddings (qwen3), qkv bias (qwen2), the GELU MLP and
MQA (granite, 3 layers) and head_dim 20 (stablelm).

Tolerances as `tests/test_torch_mamba2.py`: logits and caches within
rtol 1e-4 and atol 1e-5 x max(1, max|ref|); the port's decode against its
own teacher-forced forward at rtol 1e-3, atol 1e-4
(`tests/test_arch_smoke.py::test_decode_matches_forward`).
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro import configs as jconfigs
from repro.models import api as japi
from repro.models import transformer as jtransformer

from repro_torch import configs, interop
from repro_torch.models import api, transformer

RTOL, ATOL = 1e-4, 1e-5
DEC_RTOL, DEC_ATOL = 1e-3, 1e-4
F32 = dict(param_dtype="float32", activation_dtype="float32")
ARCHS = ["qwen3-1.7b", "qwen2-7b", "granite-34b", "stablelm-12b"]
B, S = 2, 11

_cache = {}


def _setup(name):
    """(jax cfg, port cfg, jax params, port params, tokens numpy).  The
    reference's init makes zero biases and unit norms; they are drawn
    here, so that qkv bias, qk-norm and the GELU biases count."""
    if name not in _cache:
        jcfg = dataclasses.replace(jconfigs.get_reduced(name), **F32)
        tcfg = dataclasses.replace(configs.get_reduced(name), **F32)
        jp = jax.tree.map(np.asarray,
                          japi.init(jax.random.PRNGKey(0), jcfg))
        rng = np.random.RandomState(5)
        for group, names, scale, offset in (
                ("attn", ("bq", "bk", "bv"), 0.5, 0.0),
                ("attn", ("q_norm", "k_norm"), 0.1, 1.0),
                ("mlp", ("b_in", "b_out"), 0.5, 0.0)):
            for n in names:
                if n in jp["blocks"][group]:
                    a = jp["blocks"][group][n]
                    jp["blocks"][group][n] = (
                        offset + scale * rng.randn(*a.shape)).astype(a.dtype)
        tparams = interop.transformer_params_from_numpy(jp, tcfg,
                                                        device="cpu")
        toks = np.random.RandomState(1).randint(0, jcfg.vocab_size, (B, S))
        _cache[name] = (jcfg, tcfg, jax.tree.map(jnp.asarray, jp), tparams,
                        toks.astype(np.int32))
    return _cache[name]


def _close(got, want, rtol=RTOL):
    want = np.asarray(want, np.float32)
    np.testing.assert_allclose(got.float().numpy(), want, rtol=rtol,
                               atol=ATOL * max(1.0, np.abs(want).max()))


@pytest.mark.parametrize("name", ARCHS)
def test_forward_logits_match(name):
    jcfg, tcfg, jp, tp, toks = _setup(name)
    want, _ = japi.forward(jp, jcfg, {"tokens": jnp.asarray(toks)})
    got, aux = api.forward(tp, tcfg, {"tokens": torch.as_tensor(toks)})
    assert got.dtype == torch.float32 and aux == 0.0
    assert tuple(got.shape) == toks.shape + (tcfg.vocab_size,)
    _close(got, want)
    feats, _ = api.forward_features(tp, tcfg,
                                    {"tokens": torch.as_tensor(toks)})
    wfeats, _ = japi.forward_features(jp, jcfg, {"tokens": jnp.asarray(toks)})
    _close(feats, wfeats)


@pytest.mark.parametrize("name", ARCHS)
def test_inputs_embeds_match(name):
    """The `inputs_embeds` path (the VLM/audio stubs' entry)."""
    jcfg, tcfg, jp, tp, toks = _setup(name)
    emb = np.random.RandomState(2).randn(B, 7, tcfg.d_model).astype(
        np.float32)
    want, _ = jtransformer.forward(jp, jcfg, None,
                                   inputs_embeds=jnp.asarray(emb))
    got, _ = transformer.forward(tp, tcfg, None,
                                 inputs_embeds=torch.as_tensor(emb))
    _close(got, want)


@pytest.mark.parametrize("name", ARCHS)
def test_prefill_logits_and_cache_match(name):
    jcfg, tcfg, jp, tp, toks = _setup(name)
    max_len = S + 5
    want, wc = japi.prefill(jp, jcfg, {"tokens": jnp.asarray(toks)},
                            max_len, cache_dtype=jnp.float32)
    got, gc = api.prefill(tp, tcfg, {"tokens": torch.as_tensor(toks)},
                          max_len, cache_dtype=torch.float32)
    _close(got, want)
    for field in ("k", "v"):
        g, w = getattr(gc, field), getattr(wc, field)
        assert tuple(g.shape) == w.shape == (
            tcfg.num_layers, B, max_len, tcfg.num_kv_heads, tcfg.hd())
        _close(g, w)
    np.testing.assert_array_equal(gc.length.numpy(), np.asarray(wc.length))
    _, gc16 = api.prefill(tp, tcfg, {"tokens": torch.as_tensor(toks)},
                          max_len)
    assert gc16.k.dtype == gc16.v.dtype == torch.bfloat16


@pytest.mark.parametrize("name", ARCHS)
def test_decode_step_matches(name):
    """Both decode steps from the same cache (the reference's prefill's,
    carried across as writable copies: decode writes k and v in place),
    then a second step from each one's own cache."""
    jcfg, tcfg, jp, tp, toks = _setup(name)
    _, wc = japi.prefill(jp, jcfg, {"tokens": jnp.asarray(toks[:, :-1])},
                         S + 2, cache_dtype=jnp.float32)
    tc = transformer.KVCache(*(torch.tensor(np.array(a)) for a in wc))
    last = toks[:, -1:]
    want, wc2 = japi.decode_step(jp, jcfg, jnp.asarray(last), wc)
    got, tc2 = api.decode_step(tp, tcfg, torch.as_tensor(last), tc)
    _close(got, want)
    _close(tc2.k, wc2.k)
    _close(tc2.v, wc2.v)
    np.testing.assert_array_equal(tc2.length.numpy(), np.asarray(wc2.length))
    nxt = np.argmax(np.asarray(want)[:, -1], axis=-1)[:, None]
    want3, _ = japi.decode_step(jp, jcfg, jnp.asarray(nxt, jnp.int32), wc2)
    got3, _ = api.decode_step(tp, tcfg,
                              torch.as_tensor(nxt, dtype=torch.int32), tc2)
    _close(got3, want3)


@pytest.mark.parametrize("name", ARCHS)
def test_decode_matches_own_forward(name):
    _, tcfg, _, tp, toks = _setup(name)
    t = torch.as_tensor(toks)
    full, _ = api.forward(tp, tcfg, {"tokens": t})
    _, cache = api.prefill(tp, tcfg, {"tokens": t[:, :-1]}, S,
                           cache_dtype=torch.float32)
    step, _ = api.decode_step(tp, tcfg, t[:, -1:], cache)
    np.testing.assert_allclose(step[:, 0].numpy(), full[:, -1].numpy(),
                               rtol=DEC_RTOL, atol=DEC_ATOL)


@pytest.mark.parametrize("name", ARCHS)
def test_param_tree_and_init(name):
    """The port's random init has the reference's tree, shapes and dtypes
    (numbers differ), is reproducible from a seed; `interop` refuses a
    tree of another config; `make_cache` gives the reference's shapes."""
    jcfg, tcfg = jconfigs.get_reduced(name), configs.get_reduced(name)
    jp = jax.tree.map(np.asarray, japi.init(jax.random.PRNGKey(0), jcfg))
    tp = api.init(0, tcfg, device="cpu")
    jflat = {jax.tree_util.keystr(k): v
             for k, v in jax.tree_util.tree_flatten_with_path(jp)[0]}
    tflat = {jax.tree_util.keystr(k): v
             for k, v in jax.tree_util.tree_flatten_with_path(tp)[0]}
    assert set(tflat) == set(jflat)
    for k, v in tflat.items():
        assert tuple(v.shape) == jflat[k].shape, k
        assert str(v.dtype).split(".")[-1] == str(jflat[k].dtype), k
    again = api.init(0, tcfg, device="cpu")
    assert torch.equal(tp["blocks"]["attn"]["wq"],
                       again["blocks"]["attn"]["wq"])
    with pytest.raises(ValueError, match="do not fit"):
        interop.transformer_params_from_numpy(jp, dataclasses.replace(
            tcfg, num_kv_heads=4), device="cpu")
    want = japi.make_cache(jcfg, 3, 20)
    got = api.make_cache(tcfg, 3, 20, device="cpu")
    assert isinstance(got, transformer.KVCache)
    for g, w in zip(got, want):
        assert tuple(g.shape) == w.shape
        assert str(g.dtype).split(".")[-1] == str(w.dtype)


def test_moe_is_not_ported():
    cfg = dataclasses.replace(configs.get_reduced("qwen3-1.7b"),
                              family="moe")
    gen = torch.Generator().manual_seed(0)
    with pytest.raises(NotImplementedError, match="A11"):
        transformer.init(gen, cfg)
    with pytest.raises(NotImplementedError, match="A11"):
        api.forward({}, cfg, {"tokens": torch.zeros((1, 2), dtype=int)})
