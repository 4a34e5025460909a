"""The port's Mamba2 model (`repro_torch.models.mamba2` through
`models.api`) against the reference's, with the reference's parameters
carried across (`interop.mamba2_params_from_numpy`) and the same tokens.

Configs, both float32 as the reference's tests run them: mamba2-130m's
REDUCED config, and mamba2-130m at its full widths (d_model 768, vocab
50280, state 128, headdim 64, chunk 64) cut to 2 layers.  Prompt lengths
are not chunk multiples, so the scan's padding runs.

Tolerance: logits, caches and states within rtol 1e-4 and atol 1e-5 x
max(1, max|ref|) (the SSD kernel tests' tolerance; both sides are float32
throughout).  The atol scales with the output above unit scale because at
the full widths float32 rounding alone (the frameworks' prefix sums and
products round in different orders; the scan's log-decay reaches ~-45)
moves each block's output by ~1e-5 on values up to ~6, and logits near
zero by up to ~1.7e-5 where max|logits| is ~3.  The port's decode against
its own teacher-forced forward: rtol 1e-3, atol 1e-4
(`tests/test_arch_smoke.py::test_decode_matches_forward`).  One test
runs the config's own bf16 and records how far the two bf16 models are
apart (see `test_bf16_model_tracks_reference`).
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro import configs as jconfigs
from repro.models import api as japi

from repro_torch import configs, interop
from repro_torch.models import api, mamba2

RTOL, ATOL = 1e-4, 1e-5
DEC_RTOL, DEC_ATOL = 1e-3, 1e-4
F32 = dict(param_dtype="float32", activation_dtype="float32")


def _configs(which):
    if which == "reduced":
        return (dataclasses.replace(jconfigs.get_reduced("mamba2-130m"),
                                    **F32),
                dataclasses.replace(configs.get_reduced("mamba2-130m"),
                                    **F32))
    return (dataclasses.replace(jconfigs.get("mamba2-130m"), num_layers=2,
                                **F32),
            dataclasses.replace(configs.get("mamba2-130m"), num_layers=2,
                                **F32))


# (config, batch, prompt length): 13 and 70 are not multiples of the
# chunk (8 and 64)
CASES = {"reduced": ("reduced", 2, 13), "full-width-2-layer": ("full", 2, 70)}


_cache = {}


def _setup(name):
    """(jax cfg, port cfg, jax params, port params, tokens numpy)."""
    if name not in _cache:
        which, B, S = CASES[name]
        jcfg, tcfg = _configs(which)
        jparams = japi.init(jax.random.PRNGKey(0), jcfg)
        tparams = interop.mamba2_params_from_numpy(
            jax.tree.map(np.asarray, jparams), tcfg, device="cpu")
        toks = np.random.RandomState(1).randint(0, jcfg.vocab_size, (B, S))
        _cache[name] = (jcfg, tcfg, jparams, tparams,
                        toks.astype(np.int32))
    return _cache[name]


def _close(got, want, rtol=RTOL):
    want = np.asarray(want, np.float32)
    np.testing.assert_allclose(got.float().numpy(), want, rtol=rtol,
                               atol=ATOL * max(1.0, np.abs(want).max()))


@pytest.mark.parametrize("name", list(CASES))
def test_forward_logits_match(name):
    jcfg, tcfg, jp, tp, toks = _setup(name)
    want, _ = japi.forward(jp, jcfg, {"tokens": jnp.asarray(toks)})
    got, aux = api.forward(tp, tcfg, {"tokens": torch.as_tensor(toks)})
    assert got.dtype == torch.float32 and aux == 0.0
    assert tuple(got.shape) == toks.shape + (tcfg.vocab_size,)
    _close(got, want)


@pytest.mark.parametrize("name", list(CASES))
def test_prefill_logits_and_cache_match(name):
    jcfg, tcfg, jp, tp, toks = _setup(name)
    S = toks.shape[1]
    want, wc = japi.prefill(jp, jcfg, {"tokens": jnp.asarray(toks)}, S,
                            cache_dtype=jnp.float32)
    got, gc = api.prefill(tp, tcfg, {"tokens": torch.as_tensor(toks)}, S,
                          cache_dtype=torch.float32)
    _close(got, want)
    assert gc.conv.shape == wc.conv.shape and gc.state.shape == \
        wc.state.shape
    _close(gc.conv, wc.conv)
    _close(gc.state, wc.state)
    np.testing.assert_array_equal(gc.length.numpy(), np.asarray(wc.length))


def test_prefill_and_make_cache_ignore_max_len():
    """The SSM cache has no length axis: `api.prefill` and
    `api.make_cache` take `max_len` as for every family and ignore it,
    as the reference's do."""
    jcfg, tcfg, jp, tp, toks = _setup("reduced")
    batch = {"tokens": torch.as_tensor(toks)}
    short, sc = api.prefill(tp, tcfg, batch, 16)
    long, lc = api.prefill(tp, tcfg, batch, 64)
    assert torch.equal(short, long)
    for a, b in zip(sc, lc):
        assert torch.equal(a, b)
    want = japi.make_cache(jcfg, 3, 40)
    for cap in (1, 40):
        got = api.make_cache(tcfg, 3, cap, device="cpu")
        assert isinstance(got, mamba2.SSMCache)
        for g, w in zip(got, want):
            assert tuple(g.shape) == w.shape and not g.any()


@pytest.mark.parametrize("name", list(CASES))
def test_prefill_bf16_cache_dtype(name):
    """The default cache keeps the conv state in bf16, the SSM state in
    float32, as the reference's."""
    jcfg, tcfg, jp, tp, toks = _setup(name)
    _, wc = japi.prefill(jp, jcfg, {"tokens": jnp.asarray(toks)}, 16)
    _, gc = api.prefill(tp, tcfg, {"tokens": torch.as_tensor(toks)}, 16)
    assert gc.conv.dtype == torch.bfloat16 and gc.state.dtype == \
        torch.float32
    # at most one bf16 rounding apart: a relative spacing of <= 2^-7
    _close(gc.conv, wc.conv.astype(jnp.float32), rtol=2 ** -7)


@pytest.mark.parametrize("name", list(CASES))
def test_decode_step_matches(name):
    """Both decode steps from the same cache (the reference's prefill's,
    carried across), then a second step from each one's own cache."""
    jcfg, tcfg, jp, tp, toks = _setup(name)
    S = toks.shape[1]
    _, wc = japi.prefill(jp, jcfg, {"tokens": jnp.asarray(toks[:, :-1])},
                         S, cache_dtype=jnp.float32)
    tc = mamba2.SSMCache(*(torch.as_tensor(np.asarray(a)) for a in wc))
    last = toks[:, -1:]
    want, wc2 = japi.decode_step(jp, jcfg, jnp.asarray(last), wc)
    got, tc2 = api.decode_step(tp, tcfg, torch.as_tensor(last), tc)
    _close(got, want)
    _close(tc2.conv, wc2.conv)
    _close(tc2.state, wc2.state)
    np.testing.assert_array_equal(tc2.length.numpy(), np.asarray(wc2.length))
    nxt = np.argmax(np.asarray(want)[:, -1], axis=-1)[:, None]
    want3, _ = japi.decode_step(jp, jcfg, jnp.asarray(nxt, jnp.int32), wc2)
    got3, _ = api.decode_step(tp, tcfg,
                              torch.as_tensor(nxt, dtype=torch.int32), tc2)
    _close(got3, want3)


@pytest.mark.parametrize("name", list(CASES))
def test_decode_matches_own_forward(name):
    """The port's prefill + one decode step against its teacher-forced
    forward on the full prompt."""
    _, tcfg, _, tp, toks = _setup(name)
    t = torch.as_tensor(toks)
    full, _ = api.forward(tp, tcfg, {"tokens": t})
    _, cache = api.prefill(tp, tcfg, {"tokens": t[:, :-1]}, t.shape[1],
                           cache_dtype=torch.float32)
    step, _ = api.decode_step(tp, tcfg, t[:, -1:], cache)
    np.testing.assert_allclose(step[:, 0].numpy(), full[:, -1].numpy(),
                               rtol=DEC_RTOL, atol=DEC_ATOL)


BF16_GAP = 2 ** -5


@pytest.mark.parametrize("S", [13, 40])
def test_bf16_model_tracks_reference(S):
    """The REDUCED config in its own dtypes (bf16 parameters and
    activations), the reference's bf16 parameters carried across bit for
    bit.  Here the two models compute different functions: the reference's
    `_ssd_chunked` rounds M to bf16 before M x, the port's scan keeps it in
    float32, and the frameworks round the bf16 products in their own
    orders.  Both stay finite, and forward logits and the prefill's SSM
    state agree within max|diff| <= 2^-5 max|ref| (a handful of bf16
    spacings, which are 2^-8..2^-7 relative).  On this CPU the gap measured
    ~1.0-1.3% of max|logits| and ~1.3% of max|state|, while each bf16 model
    is ~1.3-2.6% from the float32 model on the same parameters."""
    jcfg = jconfigs.get_reduced("mamba2-130m")
    tcfg = configs.get_reduced("mamba2-130m")
    jp = japi.init(jax.random.PRNGKey(0), jcfg)
    tp = interop.mamba2_params_from_numpy(jax.tree.map(np.asarray, jp),
                                          tcfg, device="cpu")
    assert tp["blocks"]["in_x"].dtype == torch.bfloat16
    toks = np.random.RandomState(1).randint(0, jcfg.vocab_size, (2, S))
    toks = toks.astype(np.int32)
    want = np.asarray(japi.forward(jp, jcfg, {"tokens": jnp.asarray(toks)})
                      [0], np.float32)
    got = api.forward(tp, tcfg, {"tokens": torch.as_tensor(toks)})[0]
    _, wc = japi.prefill(jp, jcfg, {"tokens": jnp.asarray(toks)}, S)
    _, gc = api.prefill(tp, tcfg, {"tokens": torch.as_tensor(toks)}, S)
    for g, w in ((got, want), (gc.state, np.asarray(wc.state))):
        g = g.float().numpy()
        assert np.all(np.isfinite(g)) and g.shape == w.shape
        assert np.abs(g - w).max() <= BF16_GAP * np.abs(w).max()


def test_param_tree_and_init():
    """The port's random init has the reference's tree, shapes and dtypes
    (numbers differ: torch.Generator, not jax.random), is reproducible from
    a seed, and `interop` refuses a tree of another config."""
    jcfg, tcfg = _configs("reduced")
    jp = jax.tree.map(np.asarray, japi.init(jax.random.PRNGKey(0), jcfg))
    tp = api.init(0, tcfg, device="cpu")
    flat = {f"{k}/{n}": v for k in ("embed", "blocks")
            for n, v in tp[k].items()}
    flat["final_norm"] = tp["final_norm"]
    jflat = {f"{k}/{n}": v for k in ("embed", "blocks")
             for n, v in jp[k].items()}
    jflat["final_norm"] = jp["final_norm"]
    assert set(flat) == set(jflat)
    for k, v in flat.items():
        assert tuple(v.shape) == jflat[k].shape, k
        assert str(v.dtype).split(".")[-1] == str(jflat[k].dtype), k
    again = api.init(0, tcfg, device="cpu")
    assert all(torch.equal(a, again["blocks"][n])
               for n, a in tp["blocks"].items())
    with pytest.raises(ValueError, match="do not fit"):
        interop.mamba2_params_from_numpy(jp, dataclasses.replace(
            tcfg, d_model=32), device="cpu")


def test_bf16_params_carry_across():
    """bf16 parameters (the config's own dtypes) come across bit for bit."""
    jcfg = jconfigs.get_reduced("mamba2-130m")
    jp = jax.tree.map(np.asarray, japi.init(jax.random.PRNGKey(0), jcfg))
    tp = interop.mamba2_params_from_numpy(
        jp, configs.get_reduced("mamba2-130m"), device="cpu")
    w = tp["blocks"]["in_x"]
    assert w.dtype == torch.bfloat16
    np.testing.assert_array_equal(w.float().numpy(),
                                  jp["blocks"]["in_x"].astype(np.float32))


def test_configs_and_families():
    cfg = configs.get("mamba2-130m")
    jcfg = jconfigs.get("mamba2-130m")
    for f in dataclasses.fields(cfg):
        assert getattr(cfg, f.name) == getattr(jcfg, f.name), f.name
    red = configs.get_reduced("mamba2-130m")
    for f in dataclasses.fields(red):
        assert getattr(red, f.name) == getattr(
            jconfigs.get_reduced("mamba2-130m"), f.name), f.name
    assert cfg.param_count() == jcfg.param_count()
    assert red.param_count() == jconfigs.get_reduced(
        "mamba2-130m").param_count()
    assert set(configs.UNPORTED) | set(configs.ARCHS) == set(jconfigs.ARCHS)
    with pytest.raises(KeyError, match="A11"):
        configs.get("qwen3-moe-30b-a3b")
    with pytest.raises(KeyError, match="A11"):
        configs.get_reduced("whisper-medium")
    for family in ("moe", "encdec", "vlm"):
        other = dataclasses.replace(cfg, family=family)
        with pytest.raises(NotImplementedError, match="A11"):
            api.init(0, other, device="cpu")
        with pytest.raises(NotImplementedError, match="A11"):
            api.make_cache(other, 2, 16, device="cpu")
        with pytest.raises(NotImplementedError, match="A11"):
            other.param_count()
