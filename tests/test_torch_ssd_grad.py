"""The SSD scan's gradient in the port (`kernels.ssd_scan.SSDScanFn`, its
backward the autodiff of the port's `models.mamba2._ssd_chunked`) against
the reference's: `jax.vjp` of its jnp `models.mamba2._ssd_chunked`, which
is how the reference's models differentiate the scan.

Same numpy inputs (`tests/test_kernel_ssd.py`'s draws) and the same
random cotangents of y and h_final go to both.  Float32, G 1 and 2, with
and without h0, at S a multiple of the chunk; then a whole Mamba2 block
(`block_forward`, the reference's parameters carried across) at an S the
block pads to a chunk multiple, its gradients through the padded scan.
Tolerance: each gradient within 1e-5 of its own max|reference| (both sides
float32; the prefix sums and products round in different orders).  Also:
`ssd_scan` records `SSDScanFn` whenever an input requires grad, and its
forward is the plain scan's.
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro import configs as jconfigs
from repro.models import api as japi
from repro.models import mamba2 as jm

from repro_torch import configs, interop
from repro_torch.kernels import ssd_scan as ssd
from repro_torch.models import mamba2

GRAD_TOL = 1e-5            # max|diff| / max|reference gradient|
NAMES = ("x", "dt", "B", "C", "A", "h0")
F32 = dict(param_dtype="float32", activation_dtype="float32")


@pytest.fixture(autouse=True)
def _one_thread():
    """One intra-op thread a test: the suite runs several workers at once,
    and this file's many small ops on every core's thread each slow all
    of them down (the loss test took 11 s alone, ~670 s so)."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _inputs(Bsz, S, H, G, N, P, seed, with_h0):
    """tests/test_kernel_ssd.py's draws (float32 numpy), then h0."""
    rng = np.random.RandomState(seed)
    x = rng.randn(Bsz, S, H, P).astype(np.float32)
    dtv = (0.1 + 0.5 * rng.rand(Bsz, S, H)).astype(np.float32)
    Bm = rng.randn(Bsz, S, G, N).astype(np.float32)
    Cm = rng.randn(Bsz, S, G, N).astype(np.float32)
    A = (-np.exp(0.3 * rng.randn(H))).astype(np.float32)
    h0 = rng.randn(Bsz, H, N, P).astype(np.float32) if with_h0 else None
    gy = rng.randn(Bsz, S, H, P).astype(np.float32)
    gh = rng.randn(Bsz, H, N, P).astype(np.float32)
    return (x, dtv, Bm, Cm, A, h0), (gy, gh)


def _close(name, got, want):
    want = np.asarray(want, np.float32)
    err = np.abs(got.detach().float().numpy() - want).max()
    scale = np.abs(want).max()
    assert err <= GRAD_TOL * scale, (name, err, scale)


def _port_grads(ins, cots, Q):
    ts = [None if a is None else torch.tensor(a, requires_grad=True)
          for a in ins]
    x = ts[0]
    Bsz, S, H, P = x.shape
    G, N = ts[2].shape[2], ts[2].shape[3]
    spec = ssd.SSDSpec(seq_len=S, chunk=Q, nheads=H, ngroups=G, headdim=P,
                       state=N)
    y, h = ssd.ssd_scan(spec, *ts[:5], h0=ts[5])
    assert type(y.grad_fn).__name__ == "SSDScanFnBackward"
    py, ph = ssd.ssd_scan_plain(spec, *(t.detach() if t is not None
                                        else None for t in ts[:5]),
                                h0=None if ts[5] is None else ts[5].detach())
    assert torch.equal(y.detach(), py) and torch.equal(h.detach(), ph)
    leaves = [t for t in ts if t is not None]
    gs = torch.autograd.grad((y, h), leaves,
                             tuple(torch.tensor(c) for c in cots))
    return gs


def _jax_grads(ins, cots, Q):
    with_h0 = ins[5] is not None

    def f(*args):
        h0 = args[5] if with_h0 else None
        return jm._ssd_chunked(*args[:5], Q, h0=h0)

    args = [jnp.asarray(a) for a in ins if a is not None]
    return jax.jit(lambda a, c: jax.vjp(f, *a)[1](c))(
        args, tuple(jnp.asarray(c) for c in cots))


# (B, S, H, G, N, P, Q): test_kernel_ssd.py's shapes with one and two groups
SHAPES = [(2, 32, 4, 1, 8, 8, 8), (2, 32, 4, 2, 8, 8, 8),
          (1, 24, 6, 2, 5, 8, 4), (2, 128, 4, 1, 16, 8, 64)]


@pytest.mark.parametrize("with_h0", [False, True], ids=["h0-zero", "h0"])
@pytest.mark.parametrize("shape", SHAPES, ids=str)
def test_scan_grads_match_reference_vjp(shape, with_h0):
    Bsz, S, H, G, N, P, Q = shape
    ins, cots = _inputs(Bsz, S, H, G, N, P, seed=sum(shape), with_h0=with_h0)
    got = _port_grads(ins, cots, Q)
    want = _jax_grads(ins, cots, Q)
    assert len(got) == len(want) == (6 if with_h0 else 5)
    for name, g, w in zip(NAMES, got, want):
        assert g.dtype == torch.float32
        _close(name, g, w)


def test_grad_fn_whenever_an_input_requires_grad():
    ins, _ = _inputs(1, 16, 2, 1, 4, 4, seed=3, with_h0=True)
    spec = ssd.SSDSpec(seq_len=16, chunk=8, nheads=2, ngroups=1, headdim=4,
                       state=4)
    for i in range(6):
        ts = [torch.tensor(a) for a in ins]
        ts[i].requires_grad_()
        y, h = ssd.ssd_scan(spec, *ts[:5], h0=ts[5])
        assert type(y.grad_fn).__name__ == "SSDScanFnBackward", NAMES[i]
        assert type(h.grad_fn).__name__ == "SSDScanFnBackward", NAMES[i]
        with torch.no_grad():
            y, _ = ssd.ssd_scan(spec, *ts[:5], h0=ts[5])
        assert y.grad_fn is None
    y, _ = ssd.ssd_scan(spec, *(torch.tensor(a) for a in ins[:5]))
    assert y.grad_fn is None


def test_bf16_inputs_get_grads_in_their_dtypes():
    """bf16 x, B and C (the model's own dtypes): the gradients come back
    in the inputs' dtypes, and equal the float32 gradient at the rounded
    inputs, rounded once."""
    ins, cots = _inputs(1, 32, 4, 1, 8, 8, seed=11, with_h0=False)
    bf = torch.bfloat16
    ts = [torch.tensor(a) for a in ins[:5]]
    for i in (0, 2, 3):
        ts[i] = ts[i].to(bf)
    ts = [t.requires_grad_() for t in ts]
    spec = ssd.SSDSpec(seq_len=32, chunk=8, nheads=4, ngroups=1, headdim=8,
                       state=8)
    y, h = ssd.ssd_scan(spec, *ts)
    gs = torch.autograd.grad((y, h), ts, tuple(torch.tensor(c)
                                               for c in cots))
    assert [g.dtype for g in gs] == [t.dtype for t in ts]
    ref = _jax_grads([t.detach().float().numpy() for t in ts] + [None],
                     cots, 8)
    for name, g, w in zip(NAMES, gs, ref):
        w = torch.tensor(np.asarray(w)).to(g.dtype).float()
        assert float((g.float() - w).abs().max()) <= \
            2 ** -7 * float(w.abs().max()), name


def _block_case(S):
    jcfg = dataclasses.replace(jconfigs.get_reduced("mamba2-130m"), **F32)
    cfg = dataclasses.replace(configs.get_reduced("mamba2-130m"), **F32)
    jparams = japi.init(jax.random.PRNGKey(0), jcfg)
    bp_np = jax.tree.map(lambda a: np.asarray(a)[0], jparams["blocks"])
    rng = np.random.RandomState(S)
    x = (0.5 * rng.randn(2, S, cfg.d_model)).astype(np.float32)
    gy = rng.randn(2, S, cfg.d_model).astype(np.float32)
    return jcfg, cfg, bp_np, x, gy


@pytest.mark.parametrize("S", [13, 16])
def test_block_grads_match_reference_through_padding(S):
    """A whole Mamba2 block at S 13 (padded to the chunk 8) and 16: the
    gradients of every block parameter and of x, through `ssd_scan` (the
    port) and `_ssd_chunked` (the reference), against `jax.vjp`."""
    jcfg, cfg, bp_np, x, gy = _block_case(S)
    assert cfg.ssm_chunk == 8
    full = interop.mamba2_params_from_numpy(
        {"embed": {"embedding": np.zeros((cfg.vocab_size, cfg.d_model),
                                         np.float32)},
         "blocks": {k: v[None] for k, v in bp_np.items()},
         "final_norm": np.ones(cfg.d_model, np.float32)},
        dataclasses.replace(cfg, num_layers=1), device="cpu")
    bp = {k: v[0].clone().requires_grad_() for k, v in
          full["blocks"].items()}
    xt = torch.tensor(x, requires_grad=True)
    y, _ = mamba2.block_forward(bp, cfg, xt)
    names = sorted(bp)
    gs = torch.autograd.grad(y, [xt] + [bp[k] for k in names],
                             torch.tensor(gy))

    def f(xj, pj):
        return jm.block_forward(pj, jcfg, xj)[0]

    gx, gp = jax.jit(lambda xj, pj, c: jax.vjp(f, xj, pj)[1](c))(
        jnp.asarray(x), {k: jnp.asarray(v) for k, v in bp_np.items()},
        jnp.asarray(gy))
    _close("x", gs[0], gx)
    for k, g in zip(names, gs[1:]):
        _close(k, g, gp[k])


def test_chunked_scan_equals_plain_forward():
    """The port's `_ssd_chunked` (M in float32) computes what the plain
    scan computes, float32 and bf16 inputs alike: within 1e-5 of each
    output's max."""
    ins, _ = _inputs(2, 32, 4, 2, 8, 8, seed=5, with_h0=True)
    ts = [torch.tensor(a) for a in ins]
    spec = ssd.SSDSpec(seq_len=32, chunk=8, nheads=4, ngroups=2, headdim=8,
                       state=8)
    for dtype in (torch.float32, torch.bfloat16):
        cast = [t.to(dtype) if i in (0, 2, 3) else t
                for i, t in enumerate(ts)]
        py, ph = ssd.ssd_scan_plain(spec, *cast[:5], h0=cast[5])
        y, h = mamba2._ssd_chunked(*cast[:5], 8, h0=cast[5])
        for got, want in ((y, py), (h, ph)):
            assert got.dtype == torch.float32
            assert float((got - want).abs().max()) <= 1e-5 * float(
                want.abs().max())


def test_grads_stay_finite_where_a_chunk_decays_past_exp_range():
    """A chunk whose log-decay spans more than float32's exp range (Q 128,
    dt 1, A -2: Lc reaches -256): the reference's `_ssd_chunked` gradient
    is NaN there (its where(mask, exp(Ldiff), 0) takes 0 * inf above the
    diagonal, ROADMAP C8); the port's exp takes the causal entries only,
    so `SSDScanFn`'s gradients are finite and equal autograd through the
    plain scan (guarded the same way) within 1e-4 of each max (the card's
    bound, `chip_smoke.GRAD_TOL`: at a log-decay of -256 the two scans'
    prefix sums, in different orders, move dA by ~2e-5 of its max)."""
    Bsz, S, H, G, N, P, Q = 1, 128, 2, 1, 4, 4, 128
    ins, cots = _inputs(Bsz, S, H, G, N, P, seed=9, with_h0=False)
    ins = (ins[0], np.ones_like(ins[1]), ins[2], ins[3],
           np.array([-1.0, -2.0], np.float32), None)
    want = _jax_grads(ins, cots, Q)
    assert not all(np.isfinite(np.asarray(w)).all() for w in want)
    got = _port_grads(ins, cots, Q)
    spec = ssd.SSDSpec(seq_len=S, chunk=Q, nheads=H, ngroups=G, headdim=P,
                       state=N)
    leaves = [torch.tensor(a, requires_grad=True) for a in ins[:5]]
    plain = torch.autograd.grad(ssd.ssd_scan_plain(spec, *leaves), leaves,
                                tuple(torch.tensor(c) for c in cots))
    for name, g, w in zip(NAMES, got, plain):
        assert torch.isfinite(g).all(), name
        assert float((g - w).abs().max()) <= 1e-4 * float(w.abs().max()), \
            name
