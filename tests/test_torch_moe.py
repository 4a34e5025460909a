"""The port's MoE (`repro_torch.models.moe`, and the moe family through
`models.transformer` and `models.api`) against the reference's, with the
reference's parameters carried across (`interop.transformer_params_from_
numpy`) and the same inputs: REDUCED qwen3-moe-30b-a3b (8 experts, top 2,
qk-norm) and dbrx-132b (4 experts, top 2), float32.

Routing, the capacity dispatch (slots, keep, buffer) and `moe_block` are
held at three routings of the same random tokens: ``no-drop`` (capacity
factor E / K, so C = N and nothing drops), ``drops`` (the router biased
to expert 0, which overflows; expert E-1 does not) and, for ROADMAP C5,
``last`` (biased to expert E-1, which overflows).  Where E-1 overflows
the reference writes its dropped entries' zeros over the kept entry at
slot (E-1, C-1) (`src/repro/models/moe.py:87-92`); the port writes kept
entries only.  The model-level tests run at no drop against the
reference as it is, and at drops against the reference with its dispatch
repaired so (`_c5_free_dispatch`, patched in for the test).

Tolerances as `tests/test_torch_transformer.py`: rtol 1e-4 and atol
1e-5 x max(1, max|ref|); decode against the port's own forward at rtol
1e-3, atol 1e-4.
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro import configs as jconfigs
from repro.models import api as japi
from repro.models import layers as JL
from repro.models import moe as jmoe
from repro.models import transformer as jtransformer

from repro_torch import configs, interop
from repro_torch.models import api, moe, transformer

RTOL, ATOL = 1e-4, 1e-5
DEC_RTOL, DEC_ATOL = 1e-3, 1e-4
F32 = dict(param_dtype="float32", activation_dtype="float32")
ARCHS = ["qwen3-moe-30b-a3b", "dbrx-132b"]
B, S = 2, 11


def _configs(name, drops=True, **kw):
    """(reference cfg, port cfg), float32; without drops the capacity
    factor is E / K, which makes C = N: every expert has room for every
    token."""
    jcfg = dataclasses.replace(jconfigs.get_reduced(name), **{**F32, **kw})
    if not drops:
        jcfg = dataclasses.replace(
            jcfg, capacity_factor=jcfg.num_experts / jcfg.experts_per_tok)
    tcfg = configs.get_reduced(name)
    tcfg = dataclasses.replace(tcfg, **{f.name: getattr(jcfg, f.name)
                                        for f in dataclasses.fields(tcfg)})
    return jcfg, tcfg


def _c5_free_dispatch(cfg, x2d, expert_idx, weights, C):
    """The reference's `_dispatch_group` with ROADMAP C5 repaired: the
    dropped entries are written to a spare row that is cut off, not to
    slot (E-1, C-1).  Everything else is its code."""
    n, D = x2d.shape
    K, E = cfg.experts_per_tok, cfg.num_experts
    flat_e = expert_idx.reshape(-1)
    flat_tok = jnp.repeat(jnp.arange(n), K)
    order = jnp.argsort(flat_e, stable=True)
    e_sorted = flat_e[order]
    tok_sorted = flat_tok[order]
    start = jnp.searchsorted(e_sorted, jnp.arange(E), side="left")
    rank = jnp.arange(n * K) - start[e_sorted]
    keep = rank < C
    slot_e = jnp.where(keep, e_sorted, E - 1)
    slot_c = jnp.where(keep, rank, C - 1)
    rows = jnp.where(keep, e_sorted * C + rank, E * C)
    buf = jnp.zeros((E * C + 1, D), x2d.dtype).at[rows].set(x2d[tok_sorted])
    return (buf[:E * C].reshape(E, C, D), slot_e, slot_c, keep, tok_sorted,
            weights.reshape(-1)[order])


_params = {}


def _model(name):
    """The reference's REDUCED float32 parameters (PRNGKey(0)) as numpy."""
    if name not in _params:
        jcfg, _ = _configs(name)
        _params[name] = jax.tree.map(np.asarray,
                                     japi.init(jax.random.PRNGKey(0), jcfg))
    return _params[name]


def _block_case(name, routing):
    """(jcfg, tcfg, reference layer-0 MoE params (numpy), the port's, x
    (B, S, D) numpy) for `routing` in no-drop / drops / last: x gets a
    constant feature 0 that the router weighs toward expert 0 (drops) or
    E-1 (last)."""
    jcfg, tcfg = _configs(name, drops=routing != "no-drop")
    p = {k: np.array(v[0]) for k, v in _model(name)["blocks"]["moe"].items()}
    x = np.random.RandomState(3).randn(B, S, tcfg.d_model).astype(np.float32)
    if routing != "no-drop":
        x[..., 0] = 3.0
        p["router"][0] = 0.0
        p["router"][0, 0 if routing == "drops" else -1] = 2.0
    tp = {k: torch.as_tensor(v) for k, v in p.items()}
    return jcfg, tcfg, p, tp, x


def _close(got, want, rtol=RTOL):
    want = np.asarray(want, np.float32)
    np.testing.assert_allclose(got.float().numpy(), want, rtol=rtol,
                               atol=ATOL * max(1.0, np.abs(want).max()))


def _counts(expert_idx, E):
    return np.bincount(np.asarray(expert_idx).ravel(), minlength=E)


@pytest.mark.parametrize("routing", ["no-drop", "drops", "last"])
@pytest.mark.parametrize("name", ARCHS)
def test_route_matches(name, routing):
    jcfg, tcfg, p, tp, x = _block_case(name, routing)
    x2d = x.reshape(B * S, -1)
    wi, ww, waux = jmoe.route(p, jcfg, jnp.asarray(x2d))
    gi, gw, gaux = moe.route(tp, tcfg, torch.as_tensor(x2d))
    np.testing.assert_array_equal(gi.numpy(), np.asarray(wi))
    assert gw.dtype == torch.float32
    _close(gw, ww)
    np.testing.assert_allclose(float(gaux), float(waux), rtol=RTOL)


@pytest.mark.parametrize("routing", ["no-drop", "drops"])
@pytest.mark.parametrize("name", ARCHS)
def test_dispatch_matches(name, routing):
    """Slots, keep, the tokens in sorted order, their weights and the
    (E, C, D) buffer equal the reference's; at `drops` some entries drop
    and expert E-1 does not overflow."""
    jcfg, tcfg, p, tp, x = _block_case(name, routing)
    x2d = jnp.asarray(x.reshape(B * S, -1))
    ei, w, _ = jmoe.route(p, jcfg, x2d)
    C = jmoe._capacity(B * S, jcfg)
    assert moe.capacity(B * S, tcfg) == C
    want = jmoe._dispatch_group(jcfg, x2d, ei, w, C)
    got = moe.dispatch(tcfg, torch.tensor(np.asarray(x2d)),
                       torch.as_tensor(np.asarray(ei)).long(),
                       torch.as_tensor(np.asarray(w)), C)
    counts = _counts(ei, jcfg.num_experts)
    if routing == "no-drop":
        assert C == B * S and bool(got.keep.all())
    else:
        assert counts.max() > C and counts[-1] <= C
        assert not bool(got.keep.all())
    np.testing.assert_array_equal(got.buf.numpy(), np.asarray(want[0]))
    for g, w_ in ((got.slot_e, want[1]), (got.slot_c, want[2]),
                  (got.keep, want[3]),
                  (got.order // jcfg.experts_per_tok, want[4])):
        np.testing.assert_array_equal(g.numpy(), np.asarray(w_))
    np.testing.assert_array_equal(got.w_sorted.numpy(), np.asarray(want[5]))


@pytest.mark.parametrize("routing", ["no-drop", "drops"])
@pytest.mark.parametrize("name", ARCHS)
def test_moe_block_matches(name, routing):
    jcfg, tcfg, p, tp, x = _block_case(name, routing)
    want, waux = jmoe.moe_block(p, jcfg, jnp.asarray(x))
    got, gaux = moe.moe_block(tp, tcfg, torch.as_tensor(x))
    assert tuple(got.shape) == x.shape and got.dtype == torch.float32
    _close(got, want)
    np.testing.assert_allclose(float(gaux), float(waux), rtol=RTOL)


@pytest.mark.parametrize("name", ARCHS)
def test_last_expert_overflow_c5(name):
    """ROADMAP C5.  Where expert E-1 overflows, the reference's dropped
    entries write 0 over slot (E-1, C-1): that slot's kept token loses its
    input there and its expert E-1 output.  The port keeps it.  So the
    buffers differ only at (E-1, C-1), which the port holds that token's
    x at, and the outputs only at that token's row; with the reference's
    dispatch repaired (`_c5_free_dispatch`) they agree everywhere."""
    jcfg, tcfg, p, tp, x = _block_case(name, "last")
    E, K, N = jcfg.num_experts, jcfg.experts_per_tok, B * S
    x2d = jnp.asarray(x.reshape(N, -1))
    ei, w, _ = jmoe.route(p, jcfg, x2d)
    C = jmoe._capacity(N, jcfg)
    assert _counts(ei, E)[-1] > C
    want = jmoe._dispatch_group(jcfg, x2d, ei, w, C)
    got = moe.dispatch(tcfg, torch.tensor(np.asarray(x2d)),
                       torch.as_tensor(np.asarray(ei)).long(),
                       torch.as_tensor(np.asarray(w)), C)
    # the token at rank C-1 of expert E-1: stable order, so the C-th of
    # its entries in token order
    tok = int(np.nonzero(np.asarray(ei) == E - 1)[0][C - 1])
    wbuf, gbuf = np.asarray(want[0]), got.buf.numpy().copy()
    assert not np.any(wbuf[E - 1, C - 1])
    np.testing.assert_array_equal(gbuf[E - 1, C - 1], x.reshape(N, -1)[tok])
    gbuf[E - 1, C - 1] = 0.0
    np.testing.assert_array_equal(gbuf, wbuf)
    wy = np.asarray(jmoe.moe_block(p, jcfg, jnp.asarray(x))[0]).reshape(N, -1)
    gy = moe.moe_block(tp, tcfg, torch.as_tensor(x))[0].reshape(N, -1)
    others = np.arange(N) != tok
    _close(gy[others], wy[others])
    assert np.abs(gy[tok].numpy() - wy[tok]).max() > 1e-3
    fixed = _c5_free_dispatch(jcfg, x2d, ei, w, C)
    np.testing.assert_array_equal(got.buf.numpy(), np.asarray(fixed[0]))


def _dense_oracle(p, cfg, x):
    """Every expert's SwiGLU on every token, in float64; each token keeps
    its top-k experts' outputs, weighted by the router (numpy)."""
    x2d = x.reshape(-1, x.shape[-1]).astype(np.float64)
    logits = x2d @ p["router"].astype(np.float64)
    probs = np.exp(logits - logits.max(-1, keepdims=True))
    probs /= probs.sum(-1, keepdims=True)
    top = np.argsort(-probs, axis=-1, kind="stable")[:, :cfg.experts_per_tok]
    w = np.take_along_axis(probs, top, -1)
    w /= w.sum(-1, keepdims=True)
    g = np.einsum("nd,edf->enf", x2d, p["w_gate"])
    u = np.einsum("nd,edf->enf", x2d, p["w_up"])
    out = np.einsum("enf,efd->end", g / (1 + np.exp(-g)) * u, p["w_down"])
    y = sum(w[:, k, None] * out[top[:, k], np.arange(len(x2d))]
            for k in range(cfg.experts_per_tok))
    return y.reshape(x.shape)


@pytest.mark.parametrize("name", ARCHS)
def test_moe_block_matches_dense_oracle(name):
    """At no drop the sort-based dispatch computes the dense top-k
    mixture: within 1e-5 of max|ref| (the check `chip_smoke.py` runs at
    full width)."""
    _, tcfg, p, tp, x = _block_case(name, "no-drop")
    want = _dense_oracle(p, tcfg, x)
    got = moe.moe_block(tp, tcfg, torch.as_tensor(x))[0].numpy()
    assert np.abs(got - want).max() <= 1e-5 * np.abs(want).max()


def _setup(name, drops, monkeypatch=None):
    """(jcfg, tcfg, reference params, the port's, tokens).  With drops,
    `monkeypatch` puts `_c5_free_dispatch` into the reference for the
    test."""
    if drops:
        monkeypatch.setattr(jmoe, "_dispatch_group", _c5_free_dispatch)
    jcfg, tcfg = _configs(name, drops)
    jp = _model(name)
    tp = interop.transformer_params_from_numpy(jp, tcfg, device="cpu")
    toks = np.random.RandomState(1).randint(0, jcfg.vocab_size, (B, S))
    return jcfg, tcfg, jax.tree.map(jnp.asarray, jp), tp, toks.astype(
        np.int32)


DROPS = [pytest.param(False, id="no-drop"), pytest.param(True, id="drops")]


@pytest.mark.parametrize("drops", DROPS)
@pytest.mark.parametrize("name", ARCHS)
def test_forward_matches(name, drops, monkeypatch):
    jcfg, tcfg, jp, tp, toks = _setup(name, drops, monkeypatch)
    want, waux = japi.forward(jp, jcfg, {"tokens": jnp.asarray(toks)})
    got, gaux = api.forward(tp, tcfg, {"tokens": torch.as_tensor(toks)})
    assert got.dtype == torch.float32
    _close(got, want)
    np.testing.assert_allclose(float(gaux), float(waux), rtol=RTOL)
    feats, _ = api.forward_features(tp, tcfg,
                                    {"tokens": torch.as_tensor(toks)})
    wfeats, _ = japi.forward_features(jp, jcfg,
                                      {"tokens": jnp.asarray(toks)})
    _close(feats, wfeats)


def test_routes_drop_in_the_model():
    """The drops cases route as their name says: at the default capacity
    factor some of REDUCED qwen3-moe's first-layer entries drop, and
    expert E-1 overflows (C5's case, which `_c5_free_dispatch` repairs)."""
    jcfg, _, jp, _, toks = _setup("qwen3-moe-30b-a3b", False)
    jcfg = dataclasses.replace(jcfg, capacity_factor=1.25)
    x = JL.embed(jp["embed"], jcfg, jnp.asarray(toks))
    bp = jax.tree.map(lambda a: a[0], jp["blocks"])
    pos = jnp.broadcast_to(jnp.arange(S, dtype=jnp.int32), (B, S))
    x = x + JL.attention_block(bp["attn"], jcfg, JL.rms_norm(
        x, bp["attn_norm"], jcfg.norm_eps), pos, causal=True)[0]
    h = JL.rms_norm(x, bp["mlp_norm"], jcfg.norm_eps)
    ei, _, _ = jmoe.route(bp["moe"], jcfg, h.reshape(B * S, -1))
    counts = _counts(ei, jcfg.num_experts)
    assert counts[-1] > jmoe._capacity(B * S, jcfg)


@pytest.mark.parametrize("drops", DROPS)
@pytest.mark.parametrize("name", ARCHS)
def test_prefill_and_decode_match(name, drops, monkeypatch):
    """Prefill logits and cache, then two decode steps from the
    reference's cache (carried across as writable copies)."""
    jcfg, tcfg, jp, tp, toks = _setup(name, drops, monkeypatch)
    max_len = S + 2
    want, wc = japi.prefill(jp, jcfg, {"tokens": jnp.asarray(toks)},
                            max_len, cache_dtype=jnp.float32)
    got, gc = api.prefill(tp, tcfg, {"tokens": torch.as_tensor(toks)},
                          max_len, cache_dtype=torch.float32)
    _close(got, want)
    _close(gc.k, wc.k)
    _close(gc.v, wc.v)
    _, wc = japi.prefill(jp, jcfg, {"tokens": jnp.asarray(toks[:, :-1])},
                         max_len, cache_dtype=jnp.float32)
    tc = transformer.KVCache(*(torch.tensor(np.array(a)) for a in wc))
    last = toks[:, -1:]
    for _ in range(2):
        want, wc = japi.decode_step(jp, jcfg, jnp.asarray(last), wc)
        got, tc = api.decode_step(tp, tcfg, torch.as_tensor(last), tc)
        _close(got, want)
        _close(tc.k, wc.k)
        last = np.argmax(np.asarray(want)[:, -1], -1)[:, None].astype(
            np.int32)


@pytest.mark.parametrize("name", ARCHS)
def test_decode_matches_own_forward(name):
    """At no drop (a decode step's two tokens and the forward's 22 route
    alike only when nothing drops)."""
    _, tcfg, _, tp, toks = _setup(name, False)
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
    (the router float32, the experts bf16), is reproducible from a seed;
    `interop` refuses a tree of another config; FLOPs a token as the
    reference's."""
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
    assert torch.equal(tp["blocks"]["moe"]["w_up"],
                       api.init(0, tcfg, device="cpu")["blocks"]["moe"][
                           "w_up"])
    with pytest.raises(ValueError, match="do not fit"):
        interop.transformer_params_from_numpy(jp, dataclasses.replace(
            tcfg, num_experts=tcfg.num_experts + 1), device="cpu")
    assert moe.moe_flops_per_token(tcfg) == jmoe.moe_flops_per_token(jcfg)


def _reference_blocks_one_by_one(jp, jcfg, toks):
    """The reference's bf16 logits with its blocks called one by one
    (no layer scan)."""
    x = JL.embed(jp["embed"], jcfg, jnp.asarray(toks))
    pos = jnp.broadcast_to(jnp.arange(toks.shape[1], dtype=jnp.int32),
                           toks.shape)
    for i in range(jcfg.num_layers):
        bp = jax.tree.map(lambda a: a[i], jp["blocks"])
        x, _ = jtransformer._block_apply(jcfg, bp, x, pos, JL._id_constrain)
    x = JL.rms_norm(x, jp["final_norm"], jcfg.norm_eps)
    return np.asarray(JL.unembed(jp["embed"], jcfg, x))


@pytest.mark.parametrize("name", ARCHS)
def test_bf16_tracks_reference(name):
    """REDUCED in its own bf16, at no drop, the reference's parameters
    carried across bit for bit.  The port sums each token's K expert
    outputs in float32 and rounds once, where the reference's segment_sum
    adds in bf16 (ROADMAP C2).  Its logits are held within 2^-5 of
    max|logits| of the reference's blocks called one by one (measured on
    this CPU: 0.42% for qwen3-moe, 0 for dbrx).  Not of the reference's
    served logits: a top-k choice is discrete, and the reference's own
    layer scan moves its bf16 logits 27% / 1.1% of max from the same
    blocks called one by one, by flipping near-tied routes."""
    jcfg, tcfg = _configs(name, drops=False, param_dtype="bfloat16",
                          activation_dtype="bfloat16")
    jp = japi.init(jax.random.PRNGKey(0), jcfg)
    tp = interop.transformer_params_from_numpy(jax.tree.map(np.asarray, jp),
                                               tcfg, device="cpu")
    assert tp["blocks"]["moe"]["w_gate"].dtype == torch.bfloat16
    assert tp["blocks"]["moe"]["router"].dtype == torch.float32
    toks = np.random.RandomState(1).randint(0, jcfg.vocab_size, (B, S))
    want = _reference_blocks_one_by_one(jp, jcfg, toks.astype(np.int32))
    got = api.forward(tp, tcfg, {"tokens": torch.as_tensor(toks)})[0]
    assert torch.isfinite(got).all()
    assert np.abs(got.numpy() - want).max() <= 2 ** -5 * np.abs(want).max()
