"""The port's llava VLM (`repro_torch.models.llava` through `models.api`)
against the reference's, with the reference's parameters carried across
(`interop.transformer_params_from_numpy`: llava's parameters are its
Mistral backbone's) and the same stub image embeddings and tokens:
llava-next-mistral-7b's REDUCED config (2 layers, 4 heads of 16 with 2
kv, 8 image positions) in float32, and in its own bf16.

Tolerances as `tests/test_torch_transformer.py`: logits and caches within
rtol 1e-4 and atol 1e-5 x max(1, max|ref|); decode against the port's own
teacher-forced forward at rtol 1e-3, atol 1e-4.
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro import configs as jconfigs
from repro.models import api as japi
from repro.models import llava as jllava

from repro_torch import configs, interop
from repro_torch.models import api, llava, transformer

RTOL, ATOL = 1e-4, 1e-5
DEC_RTOL, DEC_ATOL = 1e-3, 1e-4
F32 = dict(param_dtype="float32", activation_dtype="float32")
ARCH = "llava-next-mistral-7b"
B, S_TEXT = 2, 7

_cache = {}


def _setup(dtype="float32"):
    """(jcfg, tcfg, reference params (jax), the port's, image embeddings,
    tokens)."""
    if dtype not in _cache:
        kw = F32 if dtype == "float32" else {}
        jcfg = dataclasses.replace(jconfigs.get_reduced(ARCH), **kw)
        tcfg = dataclasses.replace(configs.get_reduced(ARCH), **kw)
        jp = japi.init(jax.random.PRNGKey(0), jcfg)
        tp = interop.transformer_params_from_numpy(
            jax.tree.map(np.asarray, jp), tcfg, device="cpu")
        rng = np.random.RandomState(1)
        img = rng.randn(B, tcfg.num_image_tokens, tcfg.d_model).astype(
            np.float32)
        toks = rng.randint(0, tcfg.vocab_size, (B, S_TEXT)).astype(np.int32)
        _cache[dtype] = (jcfg, tcfg, jp, tp, img, toks)
    return _cache[dtype]


def _batches(img, toks):
    return ({"image_embeds": jnp.asarray(img), "tokens": jnp.asarray(toks)},
            {"image_embeds": torch.as_tensor(img),
             "tokens": torch.as_tensor(toks)})


def _close(got, want, rtol=RTOL):
    want = np.asarray(want, np.float32)
    np.testing.assert_allclose(got.float().numpy(), want, rtol=rtol,
                               atol=ATOL * max(1.0, np.abs(want).max()))


def test_splice_embeddings_matches():
    jcfg, tcfg, jp, tp, img, toks = _setup()
    want = jllava.splice_embeddings(jp, jcfg, jnp.asarray(toks),
                                    jnp.asarray(img))
    got = llava.splice_embeddings(tp, tcfg, torch.as_tensor(toks),
                                  torch.as_tensor(img))
    assert tuple(got.shape) == (B, tcfg.num_image_tokens + S_TEXT,
                                tcfg.d_model)
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))


def test_forward_matches():
    jcfg, tcfg, jp, tp, img, toks = _setup()
    jb, tb = _batches(img, toks)
    want, _ = japi.forward(jp, jcfg, jb)
    got, aux = api.forward(tp, tcfg, tb)
    assert got.dtype == torch.float32 and aux == 0.0
    assert tuple(got.shape) == (B, tcfg.num_image_tokens + S_TEXT,
                                tcfg.vocab_size)
    _close(got, want)
    feats, _ = api.forward_features(tp, tcfg, tb)
    _close(feats, japi.forward_features(jp, jcfg, jb)[0])


def test_prefill_and_decode_match():
    """Prefill logits and cache (its capacity counts the image's
    positions), then two decode steps from the reference's cache (carried
    across as writable copies)."""
    jcfg, tcfg, jp, tp, img, toks = _setup()
    total = tcfg.num_image_tokens + S_TEXT
    jb, tb = _batches(img, toks)
    want, wc = japi.prefill(jp, jcfg, jb, total + 3,
                            cache_dtype=jnp.float32)
    got, gc = api.prefill(tp, tcfg, tb, total + 3, cache_dtype=torch.float32)
    _close(got, want)
    assert isinstance(gc, transformer.KVCache)
    _close(gc.k, wc.k)
    _close(gc.v, wc.v)
    np.testing.assert_array_equal(gc.length.numpy(), np.asarray(wc.length))
    tc = transformer.KVCache(*(torch.tensor(np.array(a)) for a in wc))
    last = np.argmax(np.asarray(want)[:, -1], -1)[:, None].astype(np.int32)
    for _ in range(2):
        want, wc = japi.decode_step(jp, jcfg, jnp.asarray(last), wc)
        got, tc = api.decode_step(tp, tcfg, torch.as_tensor(last), tc)
        _close(got, want)
        _close(tc.k, wc.k)
        last = np.argmax(np.asarray(want)[:, -1], -1)[:, None].astype(
            np.int32)


def test_decode_matches_own_forward():
    _, tcfg, _, tp, img, toks = _setup()
    _, tb = _batches(img, toks)
    full, _ = api.forward(tp, tcfg, tb)
    _, cache = api.prefill(tp, tcfg, {"image_embeds": tb["image_embeds"],
                                      "tokens": tb["tokens"][:, :-1]},
                           tcfg.num_image_tokens + S_TEXT,
                           cache_dtype=torch.float32)
    step, _ = api.decode_step(tp, tcfg, tb["tokens"][:, -1:], cache)
    np.testing.assert_allclose(step[:, 0].numpy(), full[:, -1].numpy(),
                               rtol=DEC_RTOL, atol=DEC_ATOL)


def test_text_loss_mask_matches():
    _, tcfg, _, _, _, _ = _setup()
    jcfg = jconfigs.get_reduced(ARCH)
    want = jllava.text_loss_mask(jcfg, 3, 12)
    got = llava.text_loss_mask(tcfg, 3, 12, device="cpu")
    assert got.dtype == torch.float32
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))


def test_param_tree_and_init():
    """The port's random init has the reference's tree, shapes and
    dtypes, reproducible from a seed; `make_cache` gives the reference's
    shapes."""
    jcfg, tcfg = jconfigs.get_reduced(ARCH), configs.get_reduced(ARCH)
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
    assert torch.equal(tp["blocks"]["mlp"]["w_up"],
                       api.init(0, tcfg, device="cpu")["blocks"]["mlp"][
                           "w_up"])
    want = japi.make_cache(jcfg, 3, 20)
    got = api.make_cache(tcfg, 3, 20, device="cpu")
    for g, w in zip(got, want):
        assert tuple(g.shape) == w.shape
        assert str(g.dtype).split(".")[-1] == str(w.dtype)


@pytest.mark.parametrize("arch,published", [
    ("llava-next-mistral-7b", 7.24), ("qwen3-moe-30b-a3b", 30.53),
    ("whisper-medium", 0.758)])
def test_published_sizes(arch, published):
    """The figures the card phases print (`param_count`, in 1e9)."""
    n = configs.get(arch).param_count() / 1e9
    assert round(n, len(str(published).split(".")[1])) == published


def test_bf16_tracks_reference():
    """REDUCED in its own bf16, the reference's parameters carried across
    bit for bit: the logits finite and within 2^-5 of max|logits| of the
    reference's (measured on this CPU: 1.1%; XLA's fusions in the
    reference's layer scan round otherwise than its ops one by one,
    ROADMAP C2)."""
    jcfg, tcfg, jp, tp, img, toks = _setup("bfloat16")
    assert tp["blocks"]["attn"]["wq"].dtype == torch.bfloat16
    jb, tb = _batches(img, toks)
    want = np.asarray(japi.forward(jp, jcfg, jb)[0])
    got = api.forward(tp, tcfg, tb)[0]
    assert torch.isfinite(got).all()
    assert np.abs(got.numpy() - want).max() <= 2 ** -5 * np.abs(want).max()
