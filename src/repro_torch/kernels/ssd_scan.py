"""Mamba2 SSD chunked scan: the hand-written CUDA kernel for Hopper and its
plain PyTorch version (port of `repro.kernels.ssd_scan`).

The paper's temporal-blocking schedule on a 1-D linear recurrence: the
sequence is processed in chunks of Q timesteps, a chunk is advanced in
fast memory (the intra-chunk term is two small matrix products), and only
the (N, P) state, the "wavefront", crosses chunk boundaries.

Per chunk (head h, state N x P, chunk Q):
    l      = dt * A                      (Q,)   log-decay
    Lc     = cumsum(l)                   (Q,)   inclusive
    D[i,j] = exp(Lc[i] - Lc[j])  (i>=j)  (Q, Q)
    M      = (C B^T) * D * dt[j]         (Q, Q)
    y      = M @ x + exp(Lc) * (C @ h)   (Q, P)
    h      = exp(Lc[Q-1]) h + B^T diag(exp(Lc[Q-1]-Lc) dt) x

`ssd_scan` dispatches on where its tensors lie: CPU tensors run
`ssd_scan_plain`; CUDA tensors launch kernel B2 (``csrc/ssd_scan.cu``: one
thread block per (batch, head), the state resident on chip) or raise.
B2 has two schedules, picked a launch by `schedule_of` from the input
dtype and (N, P, Q): the tensor-core one for bf16 inputs at mamba2-130m's
and zamba2-2.7b's head shapes (`TC_SHAPES`), the float32-core one (the
first design) for everything else.
`launches` counts kernel launches, so a run can show it went through the
kernel.  Unlike the reference's `ssd_scan`, both take an optional initial
state `h0` (zeros when None), as the reference's
`models.mamba2._ssd_chunked` does.  Both take M in float32 whatever the
input dtype; the reference's `_ssd_chunked` rounds M to x's dtype before
M x, so with bf16 inputs they differ from it by that rounding.  The
float32-core schedule equals `ssd_scan_plain` bit for bit; the tensor-core
one sums in another order (and its float32 operands in three bf16
pieces), so it is close to it, not equal.

Gradients (training): under grad mode, with an input that requires grad,
`ssd_scan` goes through `SSDScanFn`.  Its forward is the same call (B2 on
the card, the plain version on the CPU); its backward is the vector-
Jacobian product of the port's copy of the reference's `_ssd_chunked`
(`models.mamba2._ssd_chunked`, M in float32), taken by
`torch.autograd` in float32.  That is how the reference gets the scan's
gradient too: its models differentiate the jnp `_ssd_chunked` with XLA's
autodiff, outside any Pallas kernel, and the JAX package has no backward
kernel.  So no kernel of this module computes a gradient, and none is
left out: B2 runs the forward, and again where activation checkpointing
(`layers.maybe_remat`) recomputes a layer in the backward.  A CUDA launch
reached under grad mode with an input that requires grad, but outside
`SSDScanFn`, raises rather than cut the graph.
"""
from __future__ import annotations

import ctypes
import dataclasses
from typing import Optional

import torch

# kernel launches made by `ssd_scan` (set it to 0 before a counted run)
launches = 0
# the calls the dry run traced on ``meta`` tensors (`_scan_meta`), one
# `kernel_cost` each: what B2 would do there.  The dry run empties it
# before a trace and sums it after (`launch.dryrun.analyze`)
meta_calls: list = []


@dataclasses.dataclass(frozen=True)
class SSDSpec:
    seq_len: int
    chunk: int
    nheads: int
    ngroups: int
    headdim: int      # P
    state: int        # N
    dtype: torch.dtype = torch.float32    # of y

    @property
    def nchunks(self) -> int:
        assert self.seq_len % self.chunk == 0
        return self.seq_len // self.chunk


# ---------------------------------------------------------------------------
# Plain PyTorch version
# ---------------------------------------------------------------------------

def _cumsum(l):
    """Inclusive prefix sum over the last axis, one step after another in
    float32, as the kernel's running sum adds them (torch.cumsum's order
    differs by device, and at |Lc| ~ 30 a last-place difference moves
    exp(Lc) by ~4e-6 relative)."""
    out = torch.empty_like(l)
    run = torch.zeros_like(l[..., 0])
    for q in range(l.shape[-1]):
        run = run + l[..., q]
        out[..., q] = run
    return out


def causal_exp(L, causal):
    """exp(L) where `causal` holds, 0 elsewhere, taking exp of the causal
    entries only: above the diagonal a log-decay difference may overflow,
    and autograd through exp-then-mask would take 0 * inf there (ROADMAP
    C8).  The values are those of the masked exp.  Shared by
    `ssd_scan_plain` and `models.mamba2._ssd_chunked`."""
    return torch.where(causal, torch.exp(torch.where(causal, L, 0.0)), 0.0)


def ssd_scan_plain(spec: SSDSpec, x, dtv, Bm, Cm, A,
                   h0: Optional[torch.Tensor] = None):
    """The TPU kernel's per-(batch, head) program, step by step over the
    chunks, with (batch, head) as the batch axes of each product and the
    log-decay's prefix sum taken in order.  Inputs are cast to float32
    (float64 where x is float64: the kernel takes no float64); y is written
    in `spec.dtype`, h_final is in the cast dtype.  Runs on any device.
    Shapes as `ssd_scan`."""
    Bsz, S, H, P = x.shape
    G, N = Bm.shape[2], Bm.shape[3]
    rep = H // G
    Q = spec.chunk
    f32 = torch.promote_types(x.dtype, torch.float32)
    dev = x.device
    # (B, H, S, *): each head with its group's B and C
    xf = x.to(f32).permute(0, 2, 1, 3)
    dtf = dtv.to(f32).permute(0, 2, 1)
    Bh = Bm.to(f32).repeat_interleave(rep, dim=2).permute(0, 2, 1, 3)
    Ch = Cm.to(f32).repeat_interleave(rep, dim=2).permute(0, 2, 1, 3)
    a = A.to(f32)[None, :, None]
    h = (torch.zeros((Bsz, H, N, P), dtype=f32, device=dev) if h0 is None
         else h0.to(f32).clone())
    causal = torch.ones((Q, Q), dtype=torch.bool, device=dev).tril()
    y = torch.empty((Bsz, H, S, P), dtype=spec.dtype, device=dev)
    for c in range(spec.nchunks):
        sl = slice(c * Q, (c + 1) * Q)
        xq, dtq, Bq, Cq = xf[:, :, sl], dtf[:, :, sl], Bh[:, :, sl], \
            Ch[:, :, sl]
        Lc = _cumsum(dtq * a)                              # (B, H, Q)
        LQ = Lc[..., -1:]
        D = causal_exp(Lc[..., :, None] - Lc[..., None, :], causal)
        M = (Cq @ Bq.transpose(-1, -2)) * D * dtq[..., None, :]
        yq = M @ xq + torch.exp(Lc)[..., None] * (Cq @ h)
        y[:, :, sl] = yq.to(spec.dtype)
        sdecay = torch.exp(LQ - Lc) * dtq                  # (B, H, Q)
        h = (torch.exp(LQ)[..., None] * h
             + (Bq * sdecay[..., None]).transpose(-1, -2) @ xq)
    return y.permute(0, 2, 1, 3).contiguous(), h


# ---------------------------------------------------------------------------
# CUDA kernel wrapper
# ---------------------------------------------------------------------------

_IO_DTYPES = (torch.float32, torch.bfloat16)

# kernel B2's schedules, by the index its C entry takes
SCHEDULES = ("float32 cores", "tensor cores")
# (N, P, Q) the tensor-core schedule is instantiated at (csrc/ssd_scan.cu,
# `with_tc_shape`): mamba2-130m's heads and zamba2-2.7b's
TC_SHAPES = ((128, 64, 64), (64, 64, 128))
TC_WARPS = 8
# shared memory a block may take for two to fit an H100 SM (tc::TWO_A_SM)
TC_TWO_A_SM = (228 * 1024 - 2 * 1024) // 2


def schedule_of(spec: SSDSpec, in_dtype: torch.dtype) -> str:
    """The schedule a CUDA launch of kernel B2 takes: "tensor cores" for
    bf16 x, B and C at an (N, P, Q) of `TC_SHAPES` (the serving path's
    calls, `models.mamba2.block_forward`), "float32 cores" (the first
    design) for float32 inputs and every other shape."""
    if in_dtype == torch.bfloat16 and \
            (spec.state, spec.headdim, spec.chunk) in TC_SHAPES:
        return "tensor cores"
    return "float32 cores"


def tc_smem_bytes(N: int, P: int, Q: int):
    """(bytes of shared memory a block, whether the intra-chunk y has room
    of its own) of the tensor-core schedule at (N, P, Q), as `tc::Smem`
    lays it out: two buffers of bf16 x (Q x (P + 8)), B and C (Q x (N + 8)
    each), four float32 scalars a step twice, and the float32 intra-chunk
    y (Q x (P + 8)) where two blocks still fit an SM, else in the chunk's
    buffer."""
    base = 2 * 2 * (Q * (P + 8) + 2 * Q * (N + 8)) + 4 * 8 * Q
    y = 4 * Q * (P + 8)
    own = base + y <= TC_TWO_A_SM
    return base + (y if own else 0), own


def tc_intra_jobs(Q: int):
    """The tensor-core schedule's intra-chunk parts at chunk Q, one a warp:
    (row block r, first column block, end column block, mode, named
    barrier), r = -1 for none; mode 0 alone, 1 stored first, 2 added to
    the first (`tc::intra_jobs`).  Each of the Q/16 row blocks (row block
    r has the r + 1 16x16 blocks on and below the diagonal) is cut into at
    most two parts of at most m blocks, m the least for which the parts
    are at most the warps; the parts, largest first, go to the four warp
    schedulers (warp w on w % 4) a round of four at a time, every other
    round reversed."""
    R = Q // 16
    assert Q % 16 == 0 and 1 <= R <= TC_WARPS
    m = next(m for m in range((R + 1) // 2, R + 1)
             if sum(2 if r + 1 > m else 1 for r in range(R)) <= TC_WARPS)
    parts, bar = [], 0
    for r in range(R - 1, -1, -1):
        if r + 1 > m:
            bar += 1
            parts += [(r, 0, m, 1, bar), (r, m, r + 1, 2, bar)]
        else:
            parts.append((r, 0, r + 1, 0, 0))
    parts.sort(key=lambda j: j[1] - j[2])          # stable: largest first
    jobs = [(-1, 0, 0, 0, 0)] * TC_WARPS
    for i, part in enumerate(parts):
        rnd, k = divmod(i, 4)
        jobs[(3 - k if rnd % 2 else k) + 4 * rnd] = part
    return jobs


def declare(lib: ctypes.CDLL) -> ctypes.CDLL:
    """Set the C signatures of a library built from ``csrc/ssd_scan.cu``."""
    p, i = ctypes.c_void_p, ctypes.c_int
    lib.repro_ssd_scan.argtypes = [i] + [p] * 8 + [i] * 10 + [p]
    lib.repro_ssd_scan.restype = i
    lib.repro_ssd_smem_bytes.argtypes = [i] * 4
    lib.repro_ssd_smem_bytes.restype = ctypes.c_longlong
    lib.repro_ssd_blocks_per_sm.argtypes = [i] * 5
    lib.repro_ssd_blocks_per_sm.restype = i
    lib.repro_ssd_intra_jobs.argtypes = [i, p]
    lib.repro_ssd_intra_jobs.restype = i
    lib.repro_cuda_error_string.argtypes = [i]
    lib.repro_cuda_error_string.restype = ctypes.c_char_p
    return lib


def _bind():
    from repro_torch.kernels import _build
    lib = _build.load("ssd_scan")
    return declare(lib) if lib.repro_ssd_scan.argtypes is None else lib


def _check(name, t, shape, dtypes, dev):
    if t.device != dev:
        raise ValueError(f"{name} is on {t.device}, expected {dev}")
    if t.dtype not in dtypes:
        raise TypeError(f"{name} has dtype {t.dtype}, the kernel takes "
                        + " or ".join(str(d) for d in dtypes))
    if tuple(t.shape) != tuple(shape):
        raise ValueError(f"{name} has shape {tuple(t.shape)}, expected "
                         f"{tuple(shape)}")
    if not t.is_contiguous():
        raise ValueError(f"{name} must be contiguous")


def _needs_grad(*tensors) -> bool:
    """Whether autograd would record a call on these tensors."""
    return torch.is_grad_enabled() and any(
        t is not None and t.requires_grad for t in tensors)


def _ssd_scan_cuda(spec: SSDSpec, x, dtv, Bm, Cm, A, h0):
    if _needs_grad(x, dtv, Bm, Cm, A, h0):
        raise RuntimeError("ssd_scan's CUDA launch has no gradient of its "
                           "own: an input requires grad, so the call must "
                           "go through SSDScanFn (`ssd_scan` does that)")
    dev = x.device
    f32 = torch.float32
    if x.dim() != 4 or Bm.dim() != 4:
        raise ValueError(f"x must be (B, S, H, P) and B/C (B, S, G, N), got "
                         f"{tuple(x.shape)} and {tuple(Bm.shape)}")
    Bsz, S, H, P = x.shape
    G, N = spec.ngroups, spec.state
    if (S, H, P) != (spec.seq_len, spec.nheads, spec.headdim):
        raise ValueError(f"x {tuple(x.shape)} disagrees with {spec}")
    if S % spec.chunk or H % G:
        raise ValueError(f"seq_len {S} must divide by chunk {spec.chunk} "
                         f"and nheads {H} by ngroups {G}")
    if not 1 <= Bsz <= 65535:
        raise ValueError(f"batch {Bsz}: the kernel takes 1..65535")
    if spec.dtype not in _IO_DTYPES:
        raise TypeError(f"spec.dtype {spec.dtype}: the kernel writes y in "
                        "float32 or bfloat16")
    _check("x", x, (Bsz, S, H, P), _IO_DTYPES, dev)
    _check("B", Bm, (Bsz, S, G, N), (x.dtype,), dev)
    _check("C", Cm, (Bsz, S, G, N), (x.dtype,), dev)
    _check("dt", dtv, (Bsz, S, H), (f32,), dev)
    _check("A", A, (H,), (f32,), dev)
    if h0 is not None:
        _check("h0", h0, (Bsz, H, N, P), (f32,), dev)
    lib = _bind()
    sched = SCHEDULES.index(schedule_of(spec, x.dtype))
    smem = lib.repro_ssd_smem_bytes(N, P, spec.chunk, sched)
    optin = torch.cuda.get_device_properties(dev).shared_memory_per_block_optin
    if smem > optin:
        raise ValueError(f"(N, P, Q) = ({N}, {P}, {spec.chunk}) needs {smem} "
                         f"bytes of shared memory a block; the card gives "
                         f"{optin}")
    y = torch.empty((Bsz, S, H, P), dtype=spec.dtype, device=dev)
    h_final = torch.empty((Bsz, H, N, P), dtype=f32, device=dev)
    ptr = lambda t: ctypes.c_void_p(  # noqa: E731
        t.data_ptr() if t is not None else None)
    stream = torch.cuda.current_stream(dev).cuda_stream
    rc = lib.repro_ssd_scan(
        dev.index if dev.index is not None else torch.cuda.current_device(),
        ptr(x), ptr(dtv), ptr(Bm), ptr(Cm), ptr(A), ptr(h0), ptr(y),
        ptr(h_final), int(x.dtype == torch.bfloat16),
        int(spec.dtype == torch.bfloat16), Bsz, S, H, G, N, P, spec.chunk,
        sched, ctypes.c_void_p(stream))
    if rc != 0:
        raise RuntimeError("ssd_scan CUDA launch failed: "
                           + lib.repro_cuda_error_string(rc).decode())
    global launches
    launches += 1
    return y, h_final


def _scan(spec: SSDSpec, x, dtv, Bm, Cm, A, h0):
    """The forward call, by device: the plain version or kernel B2."""
    dev = x.device
    if dev.type == "cpu":
        return ssd_scan_plain(spec, x, dtv, Bm, Cm, A, h0)
    if dev.type == "cuda":
        return _ssd_scan_cuda(spec, x, dtv, Bm, Cm, A, h0)
    if dev.type == "meta":
        return _scan_meta(spec, x, h0)
    raise ValueError(f"no SSD scan for device {dev}")


def _scan_meta(spec: SSDSpec, x, h0):
    """The dry run's call on ``meta`` tensors: y and h_final with their
    shapes and dtypes and no data, and B2's `kernel_cost` at this call
    (its FLOPs and bytes, not the plain version's einsums') appended to
    `meta_calls`.  Serves ``meta`` tensors only; a CUDA tensor launches
    the kernel or raises."""
    Bsz, S, H, P = x.shape
    cost = kernel_cost(spec, Bsz, in_dtype=x.dtype)
    cost["has_h0"] = h0 is not None
    meta_calls.append(cost)
    return (torch.empty((Bsz, S, H, P), dtype=spec.dtype, device="meta"),
            torch.empty((Bsz, H, spec.state, P), dtype=torch.float32,
                        device="meta"))


class SSDScanFn(torch.autograd.Function):
    """The scan with a gradient: forward = `_scan` (kernel B2 on CUDA
    tensors, on the schedule `schedule_of` picks; `ssd_scan_plain` on CPU
    tensors), with the inputs saved.  Backward = the vector-Jacobian
    product of `models.mamba2._ssd_chunked` at the saved inputs, cast to
    float32 (M in float32: the function B2 computes), by
    `torch.autograd.grad` of its plain array operations, as the reference
    differentiates its jnp `_ssd_chunked` with XLA's autodiff (the JAX
    package has no backward kernel).  Takes cotangents of y and h_final;
    returns the gradients of x, dt, B, C, A and h0 (None when h0 is None)
    in the inputs' dtypes."""

    @staticmethod
    def forward(ctx, spec, x, dtv, Bm, Cm, A, h0):
        ctx.spec = spec
        ctx.save_for_backward(x, dtv, Bm, Cm, A, h0)
        return _scan(spec, x, dtv, Bm, Cm, A, h0)

    @staticmethod
    def backward(ctx, gy, gh):
        from repro_torch.models.mamba2 import _ssd_chunked
        f32 = torch.float32
        saved = ctx.saved_tensors
        ins = [None if t is None else t.detach().to(f32).requires_grad_()
               for t in saved]
        with torch.enable_grad():
            y, h = _ssd_chunked(*ins[:5], ctx.spec.chunk, h0=ins[5])
            leaves = [t for t in ins if t is not None]
            grads = iter(torch.autograd.grad((y, h), leaves,
                                             (gy.to(f32), gh.to(f32))))
        out = [None if t is None else next(grads).to(t.dtype)
               for t in saved]
        return (None, *out)


def ssd_scan(spec: SSDSpec, x, dtv, Bm, Cm, A,
             h0: Optional[torch.Tensor] = None):
    """Chunked SSD scan.

    x: (B, S, H, P) float32 or bf16; dtv: (B, S, H) float32 post-softplus;
    Bm/Cm: (B, S, G, N) in x's dtype; A: (H,) float32, negative; h0: None
    (zeros) or (B, H, N, P) float32.  S must be a multiple of spec.chunk.
    Returns (y (B, S, H, P) in spec.dtype, h_final (B, H, N, P) float32).

    CPU tensors run `ssd_scan_plain`; CUDA tensors launch kernel B2 once,
    on the schedule `schedule_of` picks (contiguous operands of those
    dtypes), or raise.  The launch goes on the
    current stream and does not synchronise.  Under grad mode with an
    input that requires grad the call goes through `SSDScanFn` (the same
    forward; the backward autodiff of `_ssd_chunked`), on either device.
    """
    if _needs_grad(x, dtv, Bm, Cm, A, h0):
        return SSDScanFn.apply(spec, x, dtv, Bm, Cm, A, h0)
    return _scan(spec, x, dtv, Bm, Cm, A, h0)


def kernel_cost(spec: SSDSpec, batch: int, in_dtype=None) -> dict:
    """Per-call analytic cost.  ``flops``, ``hbm_bytes`` and
    ``state_bytes_resident`` are the reference's (every operand priced in
    `spec.dtype`; ``flops`` prices the full Q x Q products C B^T and M x).
    ``needed_flops`` is the work the function needs, the operations term
    of the roofline bound: only the causal (lower-triangle, diagonal
    included) half of C B^T and of M x, and the reference's six
    elementwise operations an entry of M on that half, Q(Q+1)/2 entries;
    C h and the state update are full, 2QNP each.  ``min_bytes`` is the
    least traffic of this port's call without h0: x, B and C read once in
    `in_dtype` (default `spec.dtype`), dt and A in float32, y written once
    in `spec.dtype` and h_final in float32 — the bytes term of the
    bound."""
    Q, N, P = spec.chunk, spec.state, spec.headdim
    chunks = batch * spec.nheads * spec.nchunks
    per_chunk = 2 * Q * Q * N + 2 * Q * Q * P + 2 * Q * N * P * 2 + 6 * Q * Q
    flops = chunks * per_chunk
    causal = Q * (Q + 1) // 2
    needed = chunks * (2 * causal * N + 2 * causal * P + 4 * Q * N * P
                       + 6 * causal)
    itemsize = spec.dtype.itemsize
    hbm = batch * spec.seq_len * (
        spec.nheads * P * 2 + spec.nheads + 2 * spec.ngroups * N) * itemsize
    ins = (in_dtype or spec.dtype).itemsize
    tokens = batch * spec.seq_len
    min_bytes = (tokens * (spec.nheads * P + 2 * spec.ngroups * N) * ins
                 + tokens * spec.nheads * 4 + spec.nheads * 4
                 + tokens * spec.nheads * P * itemsize
                 + batch * spec.nheads * N * P * 4)
    return {"flops": float(flops), "needed_flops": float(needed),
            "hbm_bytes": float(hbm),
            "state_bytes_resident": spec.nheads * N * P * 4,
            "min_bytes": float(min_bytes)}
