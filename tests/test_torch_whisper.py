"""The port's whisper encoder-decoder (`repro_torch.models.whisper` through
`models.api`) and the layers it adds (`layer_norm`, `encoder_kv`,
`cross_attention_block`) against the reference's, with the reference's
parameters carried across (`interop.whisper_params_from_numpy`) and the
same frame embeddings and tokens: whisper-medium's REDUCED config in
float32 (2 + 2 layers, 4 heads of 16, the GELU MLP, tied embeddings),
its LayerNorm weights and biases and MLP biases drawn at random so they
count; and REDUCED in its own bf16.

Tolerances as `tests/test_torch_transformer.py`: logits and caches within
rtol 1e-4 and atol 1e-5 x max(1, max|ref|); decode against the port's own
teacher-forced forward at rtol 1e-3, atol 1e-4
(`tests/test_arch_smoke.py::test_decode_matches_forward`).
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro import configs as jconfigs
from repro.configs.base import ShapeConfig as JShape
from repro.models import api as japi
from repro.models import layers as JL
from repro.models import whisper as jwhisper

from repro_torch import configs, interop
from repro_torch.configs.base import ShapeConfig
from repro_torch.models import api, layers as L, whisper

RTOL, ATOL = 1e-4, 1e-5
DEC_RTOL, DEC_ATOL = 1e-3, 1e-4
F32 = dict(param_dtype="float32", activation_dtype="float32")
ARCH = "whisper-medium"
B, S_ENC, S_DEC = 2, 24, 9
SHAPE = (ShapeConfig("t", 64, B, "prefill"), JShape("t", 64, B, "prefill"))

_cache = {}


def _perturb(tree, rng):
    """LayerNorm weights near 1 and biases (LN and MLP) at random, in
    place, in each leaf's dtype (the reference's init makes them 1 and 0)."""
    for k, v in tree.items():
        if isinstance(v, dict):
            _perturb(v, rng)
        elif k in ("w", "b", "b_in", "b_out"):
            off = 1.0 if k == "w" else 0.0
            tree[k] = (off + 0.2 * rng.randn(*v.shape)).astype(v.dtype)


def _setup(dtype="float32"):
    """(jcfg, tcfg, reference params (jax), the port's, frames, tokens)."""
    if dtype not in _cache:
        kw = F32 if dtype == "float32" else {}
        jcfg = dataclasses.replace(jconfigs.get_reduced(ARCH), **kw)
        tcfg = dataclasses.replace(configs.get_reduced(ARCH), **kw)
        jp = jax.tree.map(np.asarray, japi.init(jax.random.PRNGKey(0), jcfg,
                                                SHAPE[1]))
        _perturb(jp, np.random.RandomState(5))
        tp = interop.whisper_params_from_numpy(jp, tcfg, device="cpu")
        rng = np.random.RandomState(1)
        frames = rng.randn(B, S_ENC, tcfg.d_model).astype(np.float32)
        toks = rng.randint(0, tcfg.vocab_size, (B, S_DEC)).astype(np.int32)
        _cache[dtype] = (jcfg, tcfg, jax.tree.map(jnp.asarray, jp), tp,
                         frames, toks)
    return _cache[dtype]


def _batches(frames, toks):
    return ({"frame_embeds": jnp.asarray(frames), "tokens": jnp.asarray(toks)},
            {"frame_embeds": torch.as_tensor(frames),
             "tokens": torch.as_tensor(toks)})


def _close(got, want, rtol=RTOL):
    want = np.asarray(want, np.float32)
    np.testing.assert_allclose(got.float().numpy(), want, rtol=rtol,
                               atol=ATOL * max(1.0, np.abs(want).max()))


def test_layer_norm_matches():
    """Population variance in float32, rounded once: float32 and bf16
    inputs (bf16 within one bf16 rounding of the reference's, 2^-8 of
    max|ref|: XLA may fuse the float32 steps before the one rounding and
    move an element across a rounding boundary; measured: one element of
    1344, by 1.2e-7 at 2e-5, where y * w + b cancels)."""
    rng = np.random.RandomState(0)
    x = (3.0 + 2.0 * rng.randn(4, 7, 48)).astype(np.float32)
    w = rng.randn(48).astype(np.float32)
    b = rng.randn(48).astype(np.float32)
    want = JL.layer_norm(jnp.asarray(x), jnp.asarray(w), jnp.asarray(b), 1e-5)
    got = L.layer_norm(torch.as_tensor(x), torch.as_tensor(w),
                       torch.as_tensor(b), 1e-5)
    _close(got, want)
    want = JL.layer_norm(*(jnp.asarray(a, jnp.bfloat16) for a in (x, w, b)),
                         1e-5)
    got = L.layer_norm(*(torch.as_tensor(a).bfloat16() for a in (x, w, b)),
                       1e-5)
    assert got.dtype == torch.bfloat16
    want = np.asarray(want, np.float32)
    np.testing.assert_allclose(got.float().numpy(), want, rtol=0,
                               atol=2 ** -8 * np.abs(want).max())


@pytest.mark.parametrize("qkv_bias", [False, True])
def test_cross_attention_matches(qkv_bias):
    """`encoder_kv` and `cross_attention_block` (with and without the qkv
    bias, which whisper-medium does not set) against the reference's."""
    jcfg, tcfg, jp, tp, frames, toks = _setup()
    jcfg = dataclasses.replace(jcfg, qkv_bias=qkv_bias)
    tcfg = dataclasses.replace(tcfg, qkv_bias=qkv_bias)
    rng = np.random.RandomState(2)
    jattn = {k: np.array(v[0])
             for k, v in jp["dec_blocks"]["cross_attn"].items()}
    if qkv_bias:
        H, hd = tcfg.num_heads, tcfg.hd()
        jattn.update({n: rng.randn(H, hd).astype(np.float32)
                      for n in ("bq", "bk", "bv")})
    tattn = {k: torch.as_tensor(v) for k, v in jattn.items()}
    enc = rng.randn(B, S_ENC, tcfg.d_model).astype(np.float32)
    x = rng.randn(B, S_DEC, tcfg.d_model).astype(np.float32)
    wk, wv = JL.encoder_kv(jattn, jcfg, jnp.asarray(enc))
    gk, gv = L.encoder_kv(tattn, tcfg, torch.as_tensor(enc))
    _close(gk, wk)
    _close(gv, wv)
    want = JL.cross_attention_block(jattn, jcfg, jnp.asarray(x), (wk, wv))
    got = L.cross_attention_block(tattn, tcfg, torch.as_tensor(x), (gk, gv))
    _close(got, want)


def test_encode_matches():
    jcfg, tcfg, jp, tp, frames, _ = _setup()
    want = jwhisper.encode(jp, jcfg, jnp.asarray(frames))
    got = whisper.encode(tp, tcfg, torch.as_tensor(frames))
    assert tuple(got.shape) == (B, S_ENC, tcfg.d_model)
    _close(got, want)


def test_forward_matches():
    jcfg, tcfg, jp, tp, frames, toks = _setup()
    jb, tb = _batches(frames, toks)
    want, _ = japi.forward(jp, jcfg, jb)
    got, aux = api.forward(tp, tcfg, tb)
    assert got.dtype == torch.float32 and aux == 0.0
    assert tuple(got.shape) == (B, S_DEC, tcfg.vocab_size)
    _close(got, want)
    feats, _ = api.forward_features(tp, tcfg, tb)
    _close(feats, japi.forward_features(jp, jcfg, jb)[0])


def test_prefill_logits_and_cache_match():
    jcfg, tcfg, jp, tp, frames, toks = _setup()
    jb, tb = _batches(frames, toks)
    max_len = S_DEC + 5
    want, wc = japi.prefill(jp, jcfg, jb, max_len, cache_dtype=jnp.float32)
    got, gc = api.prefill(tp, tcfg, tb, max_len, cache_dtype=torch.float32)
    _close(got, want)
    assert isinstance(gc, whisper.EncDecCache)
    for field in ("k", "v", "cross_k", "cross_v"):
        g, w = getattr(gc, field), getattr(wc, field)
        assert tuple(g.shape) == w.shape
        _close(g, w)
    assert gc.k.shape[2] == max_len and gc.cross_k.shape[2] == S_ENC
    np.testing.assert_array_equal(gc.length.numpy(), np.asarray(wc.length))
    _, gc16 = api.prefill(tp, tcfg, tb, max_len)
    assert gc16.k.dtype == gc16.cross_v.dtype == torch.bfloat16


def test_decode_steps_match():
    """Two decode steps from the reference's prefill cache (carried
    across as writable copies: decode writes k and v in place)."""
    jcfg, tcfg, jp, tp, frames, toks = _setup()
    jb, _ = _batches(frames, toks[:, :-1])
    _, wc = japi.prefill(jp, jcfg, jb, S_DEC + 2, cache_dtype=jnp.float32)
    tc = whisper.EncDecCache(*(torch.tensor(np.array(a)) for a in wc))
    last = toks[:, -1:]
    for _ in range(2):
        want, wc = japi.decode_step(jp, jcfg, jnp.asarray(last), wc)
        got, tc = api.decode_step(tp, tcfg, torch.as_tensor(last), tc)
        _close(got, want)
        _close(tc.k, wc.k)
        _close(tc.v, wc.v)
        np.testing.assert_array_equal(tc.length.numpy(),
                                      np.asarray(wc.length))
        last = np.argmax(np.asarray(want)[:, -1], -1)[:, None].astype(
            np.int32)


def test_decode_matches_own_forward():
    """`tests/test_arch_smoke.py::test_decode_matches_forward`'s encdec
    case on the port."""
    _, tcfg, _, tp, frames, toks = _setup()
    _, tb = _batches(frames, toks)
    full, _ = api.forward(tp, tcfg, tb)
    _, cache = api.prefill(tp, tcfg, {"frame_embeds": tb["frame_embeds"],
                                      "tokens": tb["tokens"][:, :-1]},
                           max_len=16, cache_dtype=torch.float32)
    step, _ = api.decode_step(tp, tcfg, tb["tokens"][:, -1:], cache)
    np.testing.assert_allclose(step[:, 0].numpy(), full[:, -1].numpy(),
                               rtol=DEC_RTOL, atol=DEC_ATOL)


@pytest.mark.parametrize("with_shape", [False, True])
def test_param_tree_and_init(with_shape):
    """The port's random init has the reference's tree, shapes and dtypes,
    its position tables sized as the reference's `api.init` sizes them
    (from `shape`, or max_source_positions: 64 and 16 rows for REDUCED);
    reproducible from a seed; `interop` refuses a tree of another config;
    `make_cache` gives the reference's shapes."""
    jcfg, tcfg = jconfigs.get_reduced(ARCH), configs.get_reduced(ARCH)
    tshape, jshape = SHAPE if with_shape else (None, None)
    jp = jax.tree.map(np.asarray, japi.init(jax.random.PRNGKey(0), jcfg,
                                            jshape))
    tp = api.init(0, tcfg, tshape, device="cpu")
    jflat = {jax.tree_util.keystr(k): v
             for k, v in jax.tree_util.tree_flatten_with_path(jp)[0]}
    tflat = {jax.tree_util.keystr(k): v
             for k, v in jax.tree_util.tree_flatten_with_path(tp)[0]}
    assert set(tflat) == set(jflat)
    for k, v in tflat.items():
        assert tuple(v.shape) == jflat[k].shape, k
        assert str(v.dtype).split(".")[-1] == str(jflat[k].dtype), k
    assert torch.equal(tp["enc_pos"],
                       api.init(0, tcfg, tshape, device="cpu")["enc_pos"])
    with pytest.raises(ValueError, match="do not fit"):
        interop.whisper_params_from_numpy(jp, dataclasses.replace(
            tcfg, num_decoder_layers=3), device="cpu")
    for enc_len in (None, 30):
        want = japi.make_cache(jcfg, 3, 20, enc_len)
        got = api.make_cache(tcfg, 3, 20, enc_len, device="cpu")
        assert isinstance(got, whisper.EncDecCache)
        for g, w in zip(got, want):
            assert tuple(g.shape) == w.shape
            assert str(g.dtype).split(".")[-1] == str(w.dtype)
    assert [whisper.dec_seq_len(n) for n in (1, 3, 64, 1500)] == \
        [jwhisper.dec_seq_len(n) for n in (1, 3, 64, 1500)]


def test_full_size_init_tables():
    """whisper-medium with no shape: 1500 encoder and 375 decoder
    positions, the reference's sizes (`api.init`); its parameters then
    come within 1% of `param_count`'s 0.758e9 (which counts no position
    table and no bias)."""
    cfg = configs.get(ARCH)
    seq = cfg.max_source_positions
    assert (max(seq, 16), max(whisper.dec_seq_len(seq), 16)) == (1500, 375)
    n = sum(int(np.prod(s)) for s in whisper.param_shapes(
        cfg, 1500, 375).values())
    assert round(cfg.param_count() / 1e9, 3) == 0.758
    assert abs(n - cfg.param_count()) < 0.01 * cfg.param_count()


def test_bf16_tracks_reference():
    """REDUCED in its own bf16, the reference's parameters carried across
    bit for bit: the logits finite and within 2^-5 of max|logits| of the
    reference's (measured on this CPU: 1.0%; the port rounds as the
    reference's ops do, XLA's fusions in its layer scans round otherwise,
    ROADMAP C2)."""
    jcfg, tcfg, jp, tp, frames, toks = _setup("bfloat16")
    assert tp["dec_blocks"]["self_attn"]["wq"].dtype == torch.bfloat16
    jb, tb = _batches(frames, toks)
    want = np.asarray(japi.forward(jp, jcfg, jb)[0])
    got = api.forward(tp, tcfg, tb)[0]
    assert torch.isfinite(got).all()
    assert np.abs(got.numpy() - want).max() <= 2 ** -5 * np.abs(want).max()
