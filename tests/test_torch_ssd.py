"""The port's SSD scan (`repro_torch.kernels.ssd_scan`, its plain version
on the CPU) against the reference's Pallas kernel and its jnp
`models.mamba2._ssd_chunked` (the model's scan), on the same numpy-made
inputs.

The reference's `ssd_scan` runs as `tests/test_kernel_ssd.py` runs it
(Pallas in interpret mode).  Cases are that file's: (S, Q) in {(16, 4),
(32, 8), (32, 32)}, its three (B, S, H, G, N, P) shapes, its property
cases (rep in {1, 2} heads a group), its bf16 I/O case, and one case at
mamba2-130m's head shape (H 24, P 64, N 128, G 1, Q 64, S 128, B 1).
Tolerances are that file's: rtol 1e-4, atol 1e-5 (2e-4 for the property
cases), and for bf16 I/O max|diff| <= 0.15 max(max|f32|, 1); at the
mamba2-130m head shape the atol scales with max|y| (see that test).
"""
import re
from pathlib import Path

import numpy as np
import jax.numpy as jnp
import pytest
import torch

from repro.kernels import ref as jref
from repro.kernels import ssd_scan as jssd
from repro.models import mamba2 as jm

from repro_torch.kernels import ref as tref
from repro_torch.kernels import ssd_scan as tssd

RTOL, ATOL = 1e-4, 1e-5
PROP_RTOL = 2e-4


def _inputs(Bsz, S, H, G, N, P, seed=0, with_h0=False):
    """test_kernel_ssd.py's draws (float32 numpy), then h0."""
    rng = np.random.RandomState(seed)
    x = rng.randn(Bsz, S, H, P).astype(np.float32)
    dtv = (0.1 + 0.5 * rng.rand(Bsz, S, H)).astype(np.float32)
    Bm = rng.randn(Bsz, S, G, N).astype(np.float32)
    Cm = rng.randn(Bsz, S, G, N).astype(np.float32)
    A = (-np.exp(0.3 * rng.randn(H))).astype(np.float32)
    h0 = rng.randn(Bsz, H, N, P).astype(np.float32) if with_h0 else None
    return x, dtv, Bm, Cm, A, h0


def _t(a, dtype=None):
    return None if a is None else torch.as_tensor(a, dtype=dtype)


def _spec(S, Q, H, G, N, P, mod, dtype):
    return mod.SSDSpec(seq_len=S, chunk=Q, nheads=H, ngroups=G, headdim=P,
                       state=N, dtype=dtype)


def _port_scan(x, dtv, Bm, Cm, A, h0, Q, dtype=torch.float32):
    Bsz, S, H, P = x.shape
    G, N = Bm.shape[2], Bm.shape[3]
    spec = _spec(S, Q, H, G, N, P, tssd, dtype)
    return tssd.ssd_scan(spec, _t(x), _t(dtv), _t(Bm), _t(Cm), _t(A),
                         h0=_t(h0))


def _jax_scan(x, dtv, Bm, Cm, A, Q):
    Bsz, S, H, P = x.shape
    G, N = Bm.shape[2], Bm.shape[3]
    spec = _spec(S, Q, H, G, N, P, jssd, jnp.float32)
    y, h = jssd.ssd_scan(spec, *(jnp.asarray(a) for a in (x, dtv, Bm, Cm,
                                                         A)))
    return np.asarray(y), np.asarray(h)


def _jax_chunked(x, dtv, Bm, Cm, A, h0, Q):
    y, h = jm._ssd_chunked(*(jnp.asarray(a) for a in (x, dtv, Bm, Cm, A)),
                           Q, h0=None if h0 is None else jnp.asarray(h0))
    return np.asarray(y), np.asarray(h)


def _close(got, want, rtol=RTOL):
    np.testing.assert_allclose(got.numpy() if torch.is_tensor(got) else got,
                               want, rtol=rtol, atol=ATOL)


@pytest.mark.parametrize("S,Q", [(16, 4), (32, 8), (32, 32)])
def test_scan_matches_reference_kernel_and_chunked(S, Q):
    """test_kernel_matches_naive's cases: the port's scan against the
    reference's Pallas kernel and its jnp `_ssd_chunked`."""
    args = _inputs(2, S, 4, 2, 8, 8)
    y, h = _port_scan(*args, Q)
    ky, kh = _jax_scan(*args[:5], Q)
    cy, ch = _jax_chunked(*args, Q)
    _close(y, ky)
    _close(h, kh)
    _close(y, cy)
    _close(h, ch)


@pytest.mark.parametrize("shape", [(1, 16, 2, 1, 4, 4), (2, 24, 6, 3, 5, 8),
                                   (3, 8, 4, 4, 16, 16)])
@pytest.mark.parametrize("with_h0", [False, True])
def test_scan_and_chunked_match_reference(shape, with_h0):
    """test_kernel_matches_xla_chunked's shapes, with and without h0: the
    port's scan against the reference's `_ssd_chunked` (and its Pallas
    kernel, which takes no h0, where h0 is None)."""
    Bsz, S, H, G, N, P = shape
    Q = 8 if S % 8 == 0 else 4
    args = _inputs(Bsz, S, H, G, N, P, seed=3, with_h0=with_h0)
    cy, ch = _jax_chunked(*args, Q)
    y, h = _port_scan(*args, Q)
    _close(y, cy)
    _close(h, ch)
    if not with_h0:
        ky, kh = _jax_scan(*args[:5], Q)
        _close(y, ky)
        _close(h, kh)


def _naive64(x, dtv, Bm, Cm, A, h0):
    """The recurrence h_t = exp(dt_t A) h_{t-1} + dt_t B_t x_t^T,
    y_t = C_t . h_t in float64 (numpy), from h0 or zeros."""
    x, dtv, Bm, Cm, A = (np.asarray(a, np.float64)
                         for a in (x, dtv, Bm, Cm, A))
    Bsz, S, H, P = x.shape
    rep = H // Bm.shape[2]
    Bh = np.repeat(Bm, rep, axis=2)
    Ch = np.repeat(Cm, rep, axis=2)
    h = (np.zeros((Bsz, H, Bm.shape[3], P)) if h0 is None
         else np.asarray(h0, np.float64))
    y = np.zeros_like(x)
    for t in range(S):
        h = (np.exp(dtv[:, t] * A)[:, :, None, None] * h
             + (dtv[:, t, :, None] * Bh[:, t])[..., None]
             * x[:, t, :, None, :])
        y[:, t] = np.einsum("bhn,bhnp->bhp", Ch[:, t], h)
    return y, h


def _close_to_scale(got, want):
    """rtol 1e-4, with atol 1e-5 x max(1, max|want|)."""
    got = got.numpy() if torch.is_tensor(got) else np.asarray(got)
    np.testing.assert_allclose(got, want, rtol=RTOL,
                               atol=ATOL * max(1.0, np.abs(want).max()))


@pytest.mark.parametrize("with_h0", [False, True])
def test_mamba2_130m_head_shape(with_h0):
    """One batch row at mamba2-130m's head shape: H 24, P 64, N 128, G 1,
    Q 64, two chunks.  Here |y| reaches ~50, and float32 rounding alone
    moves outputs near zero by up to ~5e-5 (each of the port's plain scan
    and the reference's two scans is that far from the float64 recurrence;
    the frameworks' prefix sums and products round in different orders).
    So at this shape the atol scales with the output above unit scale
    (1e-5 x max(1, max|y|)), as the stencil tests hold each field to its
    own scale; rtol stays 1e-4.  Every scan is held so to the float64
    recurrence, and the port's to the reference's."""
    args = _inputs(1, 128, 24, 1, 128, 64, seed=5, with_h0=with_h0)
    y64, h64 = _naive64(*args)
    y, h = _port_scan(*args, 64)
    cy, ch = _jax_chunked(*args, 64)
    for got_y, got_h in ((y, h), (cy, ch)):
        _close_to_scale(got_y, y64)
        _close_to_scale(got_h, h64)
    _close_to_scale(y, cy)
    _close_to_scale(h, ch)
    if not with_h0:
        ky, kh = _jax_scan(*args[:5], 64)
        _close_to_scale(ky, y64)
        _close_to_scale(y, ky)
        _close_to_scale(h, kh)


@pytest.mark.parametrize("seed,Q,rep", [(0, 4, 1), (1, 8, 2), (7, 4, 2),
                                        (42, 8, 1), (123, 4, 1),
                                        (999, 8, 2)])
def test_property_cases(seed, Q, rep):
    """test_property_kernel_equals_oracle's family: G 2, rep heads a
    group."""
    G = 2
    args = _inputs(1, 16, G * rep, G, 4, 4, seed=seed)
    y, _ = _port_scan(*args, Q)
    cy, _ = _jax_chunked(*args, Q)
    ky, _ = _jax_scan(*args[:5], Q)
    _close(y, cy, rtol=PROP_RTOL)
    _close(y, ky, rtol=PROP_RTOL)


def test_bf16_io():
    """test_bf16_io: bf16 x, B, C, dt and y against the float32 chunked
    scan of the same (rounded) values."""
    x, dtv, Bm, Cm, A, _ = _inputs(1, 16, 2, 1, 4, 8)
    bf = [torch.as_tensor(a).to(torch.bfloat16) for a in (x, dtv, Bm, Cm)]
    spec = _spec(16, 4, 2, 1, 4, 8, tssd, torch.bfloat16)
    y, h = tssd.ssd_scan(spec, *bf, _t(A))
    assert y.dtype == torch.bfloat16 and h.dtype == torch.float32
    yb = y.float().numpy()
    assert np.all(np.isfinite(yb))
    f32 = [jnp.asarray(b.float().numpy()) for b in bf]
    yf, _ = jm._ssd_chunked(*f32, jnp.asarray(A), 4)
    yf = np.asarray(yf)
    assert np.abs(yb - yf).max() < 0.15 * max(np.abs(yf).max(), 1.0)


@pytest.mark.parametrize("S", [1, 9, 24])
def test_naive_reference_matches(S):
    rng = np.random.RandomState(S)
    x = rng.randn(S, 5).astype(np.float32)
    a = np.exp(-rng.rand(S)).astype(np.float32)
    b = rng.randn(S, 3).astype(np.float32)
    c = rng.randn(S, 3).astype(np.float32)
    want = np.asarray(jref.ssd_chunked_reference(*(jnp.asarray(v) for v in
                                                   (x, a, b, c))))
    got = tref.ssd_chunked_reference(*(_t(v) for v in (x, a, b, c)))
    _close(got, want)


def test_scan_matches_naive_recurrence():
    """test_kernel_matches_naive's oracle: the per-(b, h) recurrence."""
    x, dtv, Bm, Cm, A, _ = _inputs(2, 32, 4, 2, 8, 8)
    y, _ = _port_scan(x, dtv, Bm, Cm, A, None, 8)
    rep = 2
    for b in range(2):
        for h in range(4):
            g = h // rep
            a_t = torch.exp(_t(dtv[b, :, h]) * float(A[h]))
            bt = _t(Bm[b, :, g] * dtv[b, :, h, None])
            yn = tref.ssd_chunked_reference(_t(x[b, :, h]), a_t, bt,
                                            _t(Cm[b, :, g]))
            _close(y[b, :, h], yn.numpy())


@pytest.mark.parametrize("seq,chunk,batch", [(4096, 128, 8), (1024, 64, 8),
                                             (128, 64, 1)])
def test_kernel_cost_equals_reference(seq, chunk, batch):
    kw = dict(seq_len=seq, chunk=chunk, nheads=24, ngroups=1, headdim=64,
              state=128)
    want = jssd.kernel_cost(jssd.SSDSpec(**kw), batch=batch)
    got = tssd.kernel_cost(tssd.SSDSpec(**kw), batch=batch)
    assert {k: got[k] for k in want} == want
    assert got["state_bytes_resident"] < got["hbm_bytes"] / (seq // chunk)
    # the work the function needs: the causal entries of C B^T and M
    # (counted here from the mask) and the full C h and state update
    causal = int(np.tril(np.ones((chunk, chunk))).sum())
    chunks = batch * 24 * (seq // chunk)
    assert got["needed_flops"] == chunks * (
        2 * causal * 128 + 2 * causal * 64 + 4 * chunk * 128 * 64
        + 6 * causal)
    assert got["needed_flops"] < got["flops"]
    # this port's call: bf16 inputs, float32 dt/A/y/h_final
    mb = tssd.kernel_cost(tssd.SSDSpec(**kw), batch=batch,
                          in_dtype=torch.bfloat16)["min_bytes"]
    tok = batch * seq
    assert mb == (tok * (24 * 64 + 2 * 128) * 2 + tok * 24 * 4 + 24 * 4
                  + tok * 24 * 64 * 4 + batch * 24 * 128 * 64 * 4)


def test_plain_and_cuda_dispatch():
    """CPU tensors run the plain version and count no launch; ``meta``
    tensors (the dry run's) get their outputs' shapes and B2's
    `kernel_cost` recorded, no launch counted; another device type
    raises."""
    from types import SimpleNamespace

    args = _inputs(1, 8, 2, 1, 4, 4)
    before = tssd.launches
    y, h = _port_scan(*args, 4)
    assert tssd.launches == before
    spec = _spec(8, 4, 2, 1, 4, 4, tssd, torch.float32)
    pl_y, pl_h = tssd.ssd_scan_plain(spec, *(_t(a) for a in args[:5]))
    assert torch.equal(y, pl_y) and torch.equal(h, pl_h)
    meta = [torch.empty(t.shape, device="meta") for t in
            (_t(a) for a in args[:5])]
    tssd.meta_calls.clear()
    my, mh = tssd.ssd_scan(spec, *meta)
    assert (my.device.type, my.shape, mh.shape) == ("meta", y.shape, h.shape)
    assert tssd.launches == before and len(tssd.meta_calls) == 1
    tssd.meta_calls.clear()
    other = SimpleNamespace(device=torch.device("xla"))
    with pytest.raises(ValueError, match="device"):
        tssd._scan(spec, other, *meta[1:], None)


# ---------------------------------------------------------------------------
# Kernel B2's tensor-core schedule, replayed on the CPU
# ---------------------------------------------------------------------------

def _bf16(t):
    """`t` rounded to bf16 (to nearest, ties to even: the kernel's
    __float2bfloat16_rn), back in float32."""
    return t.to(torch.bfloat16).to(torch.float32)


def _pieces(t, n):
    """The kernel's split of a float32 operand into n bf16 pieces, each the
    bf16 rounding of what the pieces before it left (n = 1: one unsplit
    bf16 pass)."""
    out, rest = [], t
    for _ in range(n):
        out.append(_bf16(rest))
        rest = rest - out[-1]
    return out


def _tc_replay(spec, x, dtv, Bm, Cm, A, h0, pieces):
    """`ssd_scan_plain`'s chunk loop with the rounding of B2's tensor-core
    schedule (csrc/ssd_scan.cu, schedule 1): x, B and C exact (bf16 here),
    C B^T in float32, and the float32 operand of each other product, M,
    the state h and sd o x (the update as B^T (sd o x)), split into
    `pieces` bf16 pieces whose products are summed in float32, the
    smallest first.  What it does not replay is the order in which the
    tensor cores sum within a product."""
    Bsz, S, H, P = x.shape
    G, N = Bm.shape[2], Bm.shape[3]
    rep, Q = H // G, spec.chunk
    xf = x.permute(0, 2, 1, 3)
    dtf = dtv.permute(0, 2, 1)
    Bh = Bm.repeat_interleave(rep, dim=2).permute(0, 2, 1, 3)
    Ch = Cm.repeat_interleave(rep, dim=2).permute(0, 2, 1, 3)
    a = A[None, :, None]
    h = torch.zeros((Bsz, H, N, P)) if h0 is None else h0.clone()
    causal = torch.ones((Q, Q), dtype=torch.bool).tril()
    y = torch.empty((Bsz, H, S, P))

    def product(left, right):
        # sum of left x piece (or piece x right), smallest piece first
        if isinstance(left, list):
            parts = [p @ right for p in reversed(left)]
        else:
            parts = [left @ p for p in reversed(right)]
        out = parts[0]
        for p in parts[1:]:
            out = out + p
        return out

    for c in range(spec.nchunks):
        sl = slice(c * Q, (c + 1) * Q)
        xq, dtq, Bq, Cq = xf[:, :, sl], dtf[:, :, sl], Bh[:, :, sl], \
            Ch[:, :, sl]
        Lc = tssd._cumsum(dtq * a)
        LQ = Lc[..., -1:]
        D = torch.where(causal, torch.exp(Lc[..., :, None]
                                          - Lc[..., None, :]), 0.0)
        M = (Cq @ Bq.transpose(-1, -2)) * D * dtq[..., None, :]
        y[:, :, sl] = (product(_pieces(M, pieces), xq)
                       + torch.exp(Lc)[..., None]
                       * product(Cq, _pieces(h, pieces)))
        sdx = (torch.exp(LQ - Lc) * dtq)[..., None] * xq
        h = (torch.exp(LQ)[..., None] * h
             + product(Bq.transpose(-1, -2), _pieces(sdx, pieces)))
    return y.permute(0, 2, 1, 3).contiguous(), h


# (N, P, Q, S) of the replays: mamba2-130m's head shape with four chunks,
# zamba2-2.7b's with four chunks (there exp(Lc) spans twice the range it
# spans at Q = 64)
REPLAY_SHAPES = {"mamba2-130m": (128, 64, 64, 256),
                 "zamba2-2.7b": (64, 64, 128, 512)}


def _replay_errors(shape, with_h0, pieces):
    """(max|diff| / max|plain|, elements outside rtol 1e-4 / atol 1e-5 x
    max(1, max|plain|)) of the replay against `ssd_scan_plain`, for y and
    h_final, at a head shape of `REPLAY_SHAPES` (N, P, Q, S), four heads
    of one group, bf16 x, B and C."""
    N, P, Q, S = REPLAY_SHAPES[shape]
    x, dtv, Bm, Cm, A, h0 = _inputs(1, S, 4, 1, N, P, seed=11,
                                    with_h0=with_h0)
    x, Bm, Cm = (_bf16(_t(v)) for v in (x, Bm, Cm))
    spec = _spec(S, Q, 4, 1, N, P, tssd, torch.float32)
    got = _tc_replay(spec, x, _t(dtv), Bm, Cm, _t(A), _t(h0), pieces)
    want = tssd.ssd_scan_plain(spec, x, _t(dtv), Bm, Cm, _t(A), h0=_t(h0))
    out = []
    for g, w in zip(got, want):
        diff, scale = (g - w).abs(), float(w.abs().max())
        outside = int((diff > ATOL * max(1.0, scale) + RTOL * w.abs()).sum())
        out.append((float(diff.max()) / scale, outside))
    return out


@pytest.mark.parametrize("shape", sorted(REPLAY_SHAPES))
@pytest.mark.parametrize("with_h0", [False, True])
def test_tensor_core_split_keeps_the_bounds(shape, with_h0):
    """B2's tensor-core schedule splits M, h and sd o x into three bf16
    pieces (24 significant bits): replayed on the CPU at both head shapes
    it takes, it keeps the kernel-vs-plain bounds (`chip_smoke.check_ssd`,
    tests/test_torch_cuda.py): max|diff| / max|plain| <= 1e-5, and every
    element within rtol 1e-4, atol 1e-5 x max(1, max|plain|)."""
    for rel, outside in _replay_errors(shape, with_h0, pieces=3):
        assert rel <= 1e-5, rel
        assert outside == 0


@pytest.mark.parametrize("shape", sorted(REPLAY_SHAPES))
def test_unsplit_single_pass_misses_the_bound(shape):
    """The reason for the split: one unsplit bf16 pass on M, h and sd o x
    (8 significant bits) puts y and h_final far beyond max|diff| /
    max|plain| = 1e-5 (about 2e-3 at both shapes, with elements outside
    the per-element bound), so the schedule may not take it."""
    (rel_y, out_y), (rel_h, out_h) = _replay_errors(shape, True, pieces=1)
    assert rel_y > 1e1 * 1e-5 and rel_h > 1e1 * 1e-5, (rel_y, rel_h)
    assert out_y > 0 and out_h > 0


# ---------------------------------------------------------------------------
# Kernel B2's tensor-core schedule: its shapes, intra-chunk parts and
# shared memory (the Python mirrors of csrc/ssd_scan.cu's tables)
# ---------------------------------------------------------------------------

CU = (Path(tssd.__file__).parent / "csrc" / "ssd_scan.cu").read_text()


@pytest.mark.parametrize("N,P,Q", [(128, 64, 64), (64, 64, 128),
                                   (8, 8, 4), (128, 64, 128),
                                   (64, 64, 64), (128, 80, 64)])
@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32])
def test_schedule_of_takes_the_tensor_cores_at_both_head_shapes(N, P, Q,
                                                               dtype):
    """bf16 inputs at mamba2-130m's (128, 64, 64) and zamba2-2.7b's (64,
    64, 128) take the tensor cores; float32 inputs, and every other
    shape, the float32 cores."""
    spec = _spec(4 * Q, Q, 2, 1, N, P, tssd, torch.float32)
    tc = dtype == torch.bfloat16 and (N, P, Q) in ((128, 64, 64),
                                                   (64, 64, 128))
    assert tssd.schedule_of(spec, dtype) == ("tensor cores" if tc
                                             else "float32 cores")


@pytest.mark.parametrize("Q", [64, 128])
def test_intra_jobs_cover_each_causal_block_once(Q):
    """Every 16x16 block on and below the diagonal of M in exactly one
    warp's part, none above; at most one part a warp; a row block in at
    most two parts, which share a named barrier (1..15), the first stored
    (mode 1), the second added to it (mode 2); the decay warp (4, the
    table's last slot) has the smallest part or none; each warp
    scheduler's (warp w on w % 4) parts within one block of the others'."""
    R = Q // 16
    jobs = tssd.tc_intra_jobs(Q)
    assert len(jobs) == tssd.TC_WARPS == 8
    seen = np.zeros((R, R), int)
    rows = {}
    for r, kb0, kb1, mode, bar in jobs:
        if r < 0:
            continue
        assert 0 <= kb0 < kb1 <= r + 1
        seen[r, kb0:kb1] += 1
        rows.setdefault(r, []).append((kb0, mode, bar))
    assert (seen == np.tril(np.ones((R, R), int))).all()
    for r, parts in rows.items():
        if len(parts) == 1:
            assert parts[0][1:] == (0, 0)
        else:
            (_, m1, b1), (_, m2, b2) = sorted(parts)
            assert (m1, m2) == (1, 2) and b1 == b2 and 1 <= b1 <= 15
    size = [kb1 - kb0 if r >= 0 else 0 for r, kb0, kb1, _, _ in jobs]
    assert size[4] == min(size)
    load = [size[s] + size[s + 4] for s in range(4)]
    assert max(load) - min(load) <= 1 and sum(load) == R * (R + 1) // 2


def test_intra_jobs_at_both_head_shapes():
    """The tables `tc::intra_jobs` gives at Q = 64 (mamba2-130m's: the
    schedule's first, hand-written table with warps 4 and 6 swapped, the
    decay warp 4) and
    Q = 128 (zamba2-2.7b's: the 8 row blocks whole, 9 blocks a
    scheduler)."""
    assert tssd.tc_intra_jobs(64) == [
        (3, 0, 2, 1, 1), (3, 2, 4, 2, 1), (2, 0, 2, 1, 2), (1, 0, 2, 0, 0),
        (-1, 0, 0, 0, 0), (-1, 0, 0, 0, 0), (0, 0, 1, 0, 0),
        (2, 2, 3, 2, 2)]
    assert [j[0] for j in tssd.tc_intra_jobs(128)] == [7, 6, 5, 4, 0, 1, 2,
                                                       3]
    assert all(j[1:] == (0, j[0] + 1, 0, 0) for j in tssd.tc_intra_jobs(128))


def test_tc_constants_equal_the_source():
    """The mirror's warps, decay warp, two-blocks-an-SM limit and shapes
    are the ones csrc/ssd_scan.cu states."""
    assert re.search(r"constexpr int THREADS = 256;", CU)
    assert re.search(r"constexpr int DECAY_WARP = 4;", CU)
    m = re.search(r"TWO_A_SM = \((\d+) \* 1024 - (\d+) \* 1024\) / 2;", CU)
    assert (int(m[1]) * 1024 - int(m[2]) * 1024) // 2 == tssd.TC_TWO_A_SM
    shapes = re.findall(r"n == (\d+) && p == (\d+) && q == (\d+)\) "
                        r"f\(TcShape<(\d+), (\d+), (\d+)>", CU)
    assert [tuple(map(int, s[:3])) for s in shapes] == list(tssd.TC_SHAPES)
    assert all(s[:3] == s[3:] for s in shapes)


@pytest.mark.parametrize("N,P,Q,own,want", [(128, 64, 64, True, 108544),
                                            (64, 64, 128, False, 114688)])
def test_tc_smem_bytes_equal_the_source_layout(N, P, Q, own, want):
    """`tc::Smem<N, P, Q>`'s bytes, summed from its members (two buffers
    of bf16 x, B and C with rows padded by 8, four float32 scalars a step
    twice, and the float32 intra-chunk y where two blocks still fit an
    SM): 108,544 at mamba2-130m's shape (the y of its own), 114,688 at
    zamba2-2.7b's (with it, 151,552: one block an SM), both at most the
    two-blocks-an-SM limit."""
    xld, bld, yld = P + 8, N + 8, P + 8
    ops = 2 * (Q * xld + Q * bld + Q * bld)
    scalars = 4 * 2 * Q * 4
    y = 4 * Q * yld
    assert (ops * 2 + scalars + y <= tssd.TC_TWO_A_SM) == own
    assert tssd.tc_smem_bytes(N, P, Q) == (want, own)
    assert want == 2 * ops + scalars + (y if own else 0)
    assert want <= tssd.TC_TWO_A_SM
    assert y <= ops                  # the y fits a chunk's buffer
