"""Mamba2 (SSD — state-space duality) blocks (port of `repro.models.mamba2`).

The SSD chunked algorithm is temporal blocking of a linear recurrence: a
chunk of Q timesteps is advanced while resident in fast memory, and only
the per-chunk state crosses chunk boundaries.  `block_forward` (prefill
and forward) runs the scan through `kernels.ssd_scan.ssd_scan`: kernel B2
on a card, its plain version on CPU tensors; under a gradient through
`ssd_scan.SSDScanFn`, whose backward differentiates this module's copy
of the reference's jnp `_ssd_chunked`.  The reference's model path calls
its `_ssd_chunked` there.  With no initial state (prefill and
forward never pass one) and float32 activations, that is the function the
kernel computes.  With bf16 activations (the config's own) they differ:
the reference's `_ssd_chunked` rounds the score matrix M to bf16 before
M x, while B2, its plain version and this module's copy keep M in
float32.  The bf16 models then differ by that
rounding and by the frameworks' own bf16 rounding orders
(`tests/test_torch_mamba2.py::test_bf16_model_tracks_reference` records
the gap).

Recurrence (per head h, state N x P):
    h_t = exp(dt_t A) h_{t-1} + dt_t B_t (x)_t^T
    y_t = C_t . h_t + D x_t

Tensor parallelism (`block_forward`): with in_z / in_x and the x conv
split over the model axis (`distributed.ShardingRules`), a rank holds a
contiguous block of the heads (d_inner is head-major: channel h * P + p)
and scans only those; in_bc and the BC conv split the 2 G N columns (at
two ranks one holds B, the other C), gathered after the conv, since every
head reads its group's B and C; in_dt, dt_bias, A_log and D stay whole
and a rank takes its heads' entries; the gated RMSNorm's sum of squares is
summed over the model axis; out_proj is row-parallel, then g.  The
normalised input enters through f.

Parameters are a dict as in the reference: ``embed/embedding``,
``blocks/*`` stacked over layers (leading axis L) and ``final_norm``; the
reference's `layer_scan` is a Python loop over the layers, its body
under `layers.maybe_remat` in `forward` (the training forward), as in
the reference.
"""
from __future__ import annotations

import math
from typing import NamedTuple, Optional

import torch
import torch.nn.functional as F

from repro_torch._device import resolve_device
from repro_torch.configs.base import ModelConfig
from repro_torch.distributed import process_group as pg
from repro_torch.kernels import ssd_scan as ssd
from repro_torch.models import layers as L


def dims(cfg: ModelConfig):
    d_inner = cfg.ssm_expand * cfg.d_model
    nheads = d_inner // cfg.ssm_headdim
    conv_ch = d_inner + 2 * cfg.ssm_ngroups * cfg.ssm_state
    return d_inner, nheads, conv_ch


def init_block(gen: torch.Generator, cfg: ModelConfig) -> dict:
    """One block's parameters; the projections are split per tensor (z /
    x / BC / dt, conv likewise), as in the reference.  A_log 0 (A = -1),
    D 1, dt_bias 0."""
    D = cfg.d_model
    d_inner, H, conv_ch = dims(cfg)
    G, N, W = cfg.ssm_ngroups, cfg.ssm_state, cfg.ssm_conv_width
    dt = L.dtype_of(cfg)
    dev = gen.device
    f32 = torch.float32
    return {
        "norm": torch.ones((D,), dtype=dt, device=dev),
        "in_z": L.dense_init(gen, D, d_inner, dt),
        "in_x": L.dense_init(gen, D, d_inner, dt),
        "in_bc": L.dense_init(gen, D, 2 * G * N, dt),
        "in_dt": L.dense_init(gen, D, H, dt),
        "conv_x_w": L.normal(gen, (W, d_inner), dt, 1.0 / math.sqrt(W)),
        "conv_x_b": torch.zeros((d_inner,), dtype=dt, device=dev),
        "conv_bc_w": L.normal(gen, (W, 2 * G * N), dt, 1.0 / math.sqrt(W)),
        "conv_bc_b": torch.zeros((2 * G * N,), dtype=dt, device=dev),
        "A_log": torch.zeros((H,), dtype=f32, device=dev),
        "D": torch.ones((H,), dtype=f32, device=dev),
        "dt_bias": torch.zeros((H,), dtype=f32, device=dev),
        "gate_norm": torch.ones((d_inner,), dtype=dt, device=dev),
        "out_proj": L.dense_init(gen, d_inner, D, dt),
    }


def init(gen: torch.Generator, cfg: ModelConfig) -> dict:
    """Random parameters on the generator's device, blocks stacked over
    layers."""
    embed = L.init_embed(gen, cfg)
    return {
        "embed": embed,
        "blocks": L.stacked(cfg.num_layers, lambda: init_block(gen, cfg)),
        "final_norm": torch.ones((cfg.d_model,), dtype=L.dtype_of(cfg),
                                 device=gen.device),
    }


def block_shapes(cfg: ModelConfig) -> dict:
    """One block's parameter shapes, by name (`init_block`'s tree)."""
    D = cfg.d_model
    d_inner, H, conv_ch = dims(cfg)
    GN2, W = 2 * cfg.ssm_ngroups * cfg.ssm_state, cfg.ssm_conv_width
    return {"norm": (D,), "in_z": (D, d_inner), "in_x": (D, d_inner),
            "in_bc": (D, GN2), "in_dt": (D, H), "conv_x_w": (W, d_inner),
            "conv_x_b": (d_inner,), "conv_bc_w": (W, GN2),
            "conv_bc_b": (GN2,), "A_log": (H,), "D": (H,), "dt_bias": (H,),
            "gate_norm": (d_inner,), "out_proj": (d_inner, D)}


def param_shapes(cfg: ModelConfig) -> dict:
    """Every parameter's shape, keyed ``embed/<name>``, ``blocks/<name>``
    (leading axis L) and ``final_norm``: the tree `init` makes."""
    out = L.embed_shapes(cfg)
    out.update({f"blocks/{k}": (cfg.num_layers,) + v
                for k, v in block_shapes(cfg).items()})
    out["final_norm"] = (cfg.d_model,)
    return out


def _softplus(x):
    """jax.nn.softplus: log(1 + exp(x)) as logaddexp(x, 0)."""
    return torch.logaddexp(x, torch.zeros_like(x))


def _causal_conv(xbc, w, b, init_state: Optional[torch.Tensor] = None):
    """Depthwise causal conv along S.  xbc: (B, S, C); w: (W, C).

    init_state: (B, W-1, C) left context; defaults to zeros.  The taps are
    summed in float32 in tap order.  Returns (out (B, S, C) in xbc's dtype,
    new_state (B, W-1, C): the last W-1 inputs)."""
    B, S, C = xbc.shape
    W = w.shape[0]
    if init_state is None:
        init_state = xbc.new_zeros((B, W - 1, C))
    full = torch.cat([init_state.to(xbc.dtype), xbc], dim=1)
    wf = w.float()
    out = torch.zeros((B, S, C), dtype=torch.float32, device=xbc.device)
    for k in range(W):
        out = out + full[:, k:k + S].float() * wf[k]
    out = out + b.float()
    return L.silu(out).to(xbc.dtype), full[:, S:]


def _split_proj(p, x, heads=slice(None)):
    """The separate z / x / BC / dt projections (dt of the heads
    `heads`)."""
    return (torch.matmul(x, p["in_z"]), torch.matmul(x, p["in_x"]),
            torch.matmul(x, p["in_bc"]),
            torch.matmul(x, p["in_dt"][:, heads]))


def _ssd_chunked(xh, dtv, Bm, Cm, A, chunk: int,
                 h0: Optional[torch.Tensor] = None):
    """The reference's jnp chunked SSD scan (`repro.models.mamba2.
    _ssd_chunked`), op for op in plain PyTorch: the intra-chunk term from
    the (B, nc, H, Q, Q) score matrix M, the chunk states, a loop over the
    chunks for the states carried between them, the inter-chunk term.

    xh: (B, S, H, P); dtv: (B, S, H) (post-softplus); Bm/Cm: (B, S, G, N);
    A: (H,) negative; h0: None (zeros) or (B, H, N, P).  S must be a
    multiple of `chunk`.  Returns (y (B, S, H, P) float32, h_final
    (B, H, N, P) float32).  Two departures from the reference: M x is
    taken in float32 (the reference rounds M and x to x's dtype first),
    so that this is the function kernel B2 computes; and the decay
    exp(Lc_i - Lc_j) is taken of the causal entries only
    (`ssd_scan.causal_exp`), so its gradient stays finite where a chunk's
    log-decay spans more than float32's exp range (the reference's is NaN
    there, ROADMAP C8; the values are the same).  The model's scan is
    `ssd_scan` (kernel B2); `ssd_scan.SSDScanFn` differentiates this
    function, on float32 inputs, for its gradient."""
    f32 = torch.float32
    Bsz, S, H, P = xh.shape
    G, N = Bm.shape[2], Bm.shape[3]
    rep = H // G
    Q = chunk
    nc = S // Q

    xr = xh.reshape(Bsz, nc, Q, H, P)
    dtr = dtv.reshape(Bsz, nc, Q, H)
    Br = Bm.reshape(Bsz, nc, Q, G, N)
    Cr = Cm.reshape(Bsz, nc, Q, G, N)

    l = dtr * A                                           # (B, nc, Q, H)
    Lc = torch.cumsum(l, dim=2)                           # inclusive
    LQ = Lc[:, :, -1]                                     # (B, nc, H)

    # intra-chunk "attention" term
    CB = torch.einsum("bcqgn,bckgn->bcgqk", Cr.to(f32), Br.to(f32))
    Ldiff = Lc[:, :, :, None, :] - Lc[:, :, None, :, :]   # (B, nc, Q, K, H)
    mask = torch.ones((Q, Q), dtype=torch.bool,
                      device=xh.device).tril()[None, None, :, :, None]
    decay = ssd.causal_exp(Ldiff, mask)
    CBh = CB.repeat_interleave(rep, dim=2) if rep > 1 else CB
    dtk = dtr.permute(0, 1, 3, 2)[:, :, :, None, :]       # dt_j on k axis
    M = CBh * decay.permute(0, 1, 4, 2, 3) * dtk          # (B, nc, H, Q, Q)
    y_intra = torch.einsum("bchqk,bckhp->bcqhp", M, xr.to(f32))

    # chunk states: S_c = sum_j exp(LQ - L_j) dt_j B_j x_j^T
    sdecay = torch.exp(LQ[:, :, None, :] - Lc) * dtr      # (B, nc, Q, H)
    Brep = Br.repeat_interleave(rep, dim=3) if rep > 1 else Br
    S_c = torch.einsum("bcqhn,bcqhp->bchnp",
                       sdecay[..., None] * Brep.to(f32), xr.to(f32))

    # inter-chunk scan: the state before each chunk
    h = (torch.zeros((Bsz, H, N, P), dtype=f32, device=xh.device)
         if h0 is None else h0.to(f32))
    starts = []
    for c in range(nc):
        starts.append(h)
        h = torch.exp(LQ[:, c])[:, :, None, None] * h + S_c[:, c]
    h_starts = torch.stack(starts, dim=1)                 # (B, nc, H, N, P)

    # inter-chunk contribution: C_i exp(L_i) h_start
    Crep = Cr.repeat_interleave(rep, dim=3) if rep > 1 else Cr
    y_inter = torch.einsum("bcqhn,bchnp->bcqhp",
                           Crep.to(f32) * torch.exp(Lc)[..., None], h_starts)
    return (y_intra + y_inter).reshape(Bsz, S, H, P), h


def _whole_if_cut(p, cfg: ModelConfig) -> dict:
    """`p` as the block runs it: as it is, unless its leaves are split
    over the model axis where a block of d_inner would cut a head (the
    reference's rules split d_inner = 1536 of mamba2-130m's 24 heads over
    16 ranks: 1.5 heads a rank).  Then every split leaf is gathered whole
    (`process_group.whole_from_model`) and every rank runs the whole
    block alike, as GSPMD gathers what it cannot keep split."""
    d_inner, H, _ = dims(cfg)
    local = p["in_x"].shape[-1]
    if local == d_inner or H % (d_inner // local) == 0:
        return p
    whole = block_shapes(cfg)
    out = {}
    for k, t in p.items():
        want = whole[k]
        cut = [d for d in range(t.dim()) if t.shape[d] != want[d]]
        out[k] = pg.whole_from_model(t, cut[0]) if cut else t
    return out


def _head_block(p, cfg: ModelConfig):
    """(first head, heads, first group, groups, split): this rank's
    contiguous block of the heads (all of them where in_x is whole) and
    the groups of B and C those heads read."""
    d_inner, H, _ = dims(cfg)
    G = cfg.ssm_ngroups
    m, n = pg.model_block(p["in_x"].shape[-1], d_inner)
    if H % n:
        raise NotImplementedError(
            f"{H} heads over a model axis of {n}: a block of d_inner would "
            "cut a head")
    hl, rep = H // n, H // G
    if hl % rep and rep % hl:
        raise NotImplementedError(
            f"{hl} heads a rank do not map onto whole groups of {rep}")
    return m * hl, hl, m * hl // rep, max(hl // rep, 1), n > 1


def _gated_norm(v, w, eps: float, width: int):
    """`layers.rms_norm` over all `width` channels of d_inner: where v and
    w hold this rank's block of them, the float32 sum of squares is summed
    over the model axis."""
    if v.shape[-1] == width:
        return L.rms_norm(v, w, eps)
    vf = v.float()
    var = pg.sum_over_model(torch.sum(vf * vf, dim=-1, keepdim=True)) / width
    y = vf * torch.rsqrt(var + eps)
    return (y * w.float()).to(v.dtype)


def block_forward(p, cfg: ModelConfig, x,
                  conv_state: Optional[torch.Tensor] = None,
                  ssm_state: Optional[torch.Tensor] = None):
    """One Mamba2 block (pre-norm residual).  x: (B, S, D).  The scan runs
    through `ssd_scan` with float32 y (kernel B2 on a card), over this
    rank's heads where the block is split over the model axis.

    Returns (y, (new_conv_state, new_ssm_state)) so prefill can seed decode.
    """
    N, P = cfg.ssm_state, cfg.ssm_headdim
    GN = cfg.ssm_ngroups * N
    Bsz, S, D = x.shape
    p = _whole_if_cut(p, cfg)
    h0, H, g0, G, split = _head_block(p, cfg)   # this rank's heads, groups
    heads = slice(h0, h0 + H)

    h = L.rms_norm(x, p["norm"], cfg.norm_eps)
    if split:
        h = pg.copy_to_model(h)
    z, xi, bc, dt_raw = _split_proj(p, h, heads)
    d_inner = xi.shape[-1]
    conv_x_st = conv_bc_st = None
    if conv_state is not None:
        conv_x_st = conv_state[..., :d_inner]
        conv_bc_st = conv_state[..., d_inner:]
    xi, new_conv_x = _causal_conv(xi, p["conv_x_w"], p["conv_x_b"],
                                  conv_x_st)
    bc, new_conv_bc = _causal_conv(bc, p["conv_bc_w"], p["conv_bc_b"],
                                   conv_bc_st)
    new_conv = torch.cat([new_conv_x, new_conv_bc], dim=-1)
    if bc.shape[-1] < 2 * GN:            # B and C split over the model axis
        bc = pg.gather_from_model(bc, -1)

    dtv = _softplus(dt_raw.float() + p["dt_bias"][heads])
    # in float32 for the scan; A_log is float32 at init, and in the
    # param dtype once an optimizer step has cast every param to it (the
    # reference's exp then rounds to that dtype too, before the products
    # promote it)
    A = (-torch.exp(p["A_log"][heads])).float()
    xh = xi.reshape(Bsz, S, H, P)

    # pad S to a chunk multiple (padded tokens have dt=0 -> identity decay,
    # zero input; they do not disturb the state)
    Q = cfg.ssm_chunk
    pad = (-S) % Q
    xs = F.pad(xh, (0, 0, 0, 0, 0, pad))
    dts = F.pad(dtv, (0, 0, 0, pad))
    bcs = F.pad(bc, (0, 0, 0, pad))
    groups = slice(g0, g0 + G)
    Bm = bcs[..., :GN].unflatten(-1, (-1, N))[:, :, groups].contiguous()
    Cm = bcs[..., GN:].unflatten(-1, (-1, N))[:, :, groups].contiguous()

    spec = ssd.SSDSpec(seq_len=S + pad, chunk=Q, nheads=H, ngroups=G,
                       headdim=P, state=N, dtype=torch.float32)
    y, h_final = ssd.ssd_scan(spec, xs.contiguous(), dts.contiguous(), Bm,
                              Cm, A.contiguous(), h0=ssm_state)
    y = y[:, :S]
    y = y + p["D"][heads][None, None, :, None] * xh.float()
    y = y.reshape(Bsz, S, d_inner).to(x.dtype)
    y = _gated_norm(y * L.silu(z), p["gate_norm"][h0 * P:(h0 + H) * P],
                    cfg.norm_eps, dims(cfg)[0])
    out = torch.matmul(y, p["out_proj"])
    if split:
        out = pg.reduce_from_model(out)
    return x + out, (new_conv, h_final)


def block_decode(p, cfg: ModelConfig, x, conv_state, ssm_state):
    """One-token recurrent update.  x: (B, 1, D); conv_state (B, W-1, C);
    ssm_state (B, H, N, P) float32.  Split over the model axis as
    `block_forward` is: this rank's heads, its x channels and B/C columns
    of the conv state ([x block | B/C block]), B and C gathered, the
    gated norm's sum of squares summed, out_proj then g."""
    G_all, N, P = cfg.ssm_ngroups, cfg.ssm_state, cfg.ssm_headdim
    GN = G_all * N
    Bsz = x.shape[0]
    p = _whole_if_cut(p, cfg)
    h0, H, g0, G, split = _head_block(p, cfg)   # this rank's heads, groups
    heads = slice(h0, h0 + H)

    h = L.rms_norm(x, p["norm"], cfg.norm_eps)
    if split:
        h = pg.copy_to_model(h)
    z, xi_t, bc_t, dt_raw = _split_proj(p, h, heads)    # (B, 1, *)
    d_inner = xi_t.shape[-1]

    def one_step_conv(state, new_col, w, b):
        window = torch.cat([state, new_col[:, None]], dim=1)
        out = torch.einsum("bwc,wc->bc", window.float(), w.float()) \
            + b.float()
        return L.silu(out), window[:, 1:]

    xi, new_conv_x = one_step_conv(conv_state[..., :d_inner], xi_t[:, 0],
                                   p["conv_x_w"], p["conv_x_b"])
    bc, new_conv_bc = one_step_conv(conv_state[..., d_inner:], bc_t[:, 0],
                                    p["conv_bc_w"], p["conv_bc_b"])
    new_conv = torch.cat([new_conv_x, new_conv_bc], dim=-1)
    if bc.shape[-1] < 2 * GN:            # B and C split over the model axis
        bc = pg.gather_from_model(bc, -1)
    groups = slice(g0, g0 + G)
    Bm = bc[:, :GN].reshape(Bsz, G_all, N)[:, groups]
    Cm = bc[:, GN:].reshape(Bsz, G_all, N)[:, groups]
    dtv = _softplus(dt_raw[:, 0].float() + p["dt_bias"][heads])
    A = -torch.exp(p["A_log"][heads])
    xh = xi.reshape(Bsz, H, P)
    rep = H // G
    Brep = Bm.repeat_interleave(rep, dim=1) if rep > 1 else Bm  # (B, H, N)
    Crep = Cm.repeat_interleave(rep, dim=1) if rep > 1 else Cm

    a = torch.exp(dtv * A)                                  # (B, H)
    h_new = (a[:, :, None, None] * ssm_state
             + (dtv[:, :, None] * Brep)[..., None] * xh[:, :, None, :])
    y = torch.einsum("bhn,bhnp->bhp", Crep, h_new)
    y = y + p["D"][heads][None, :, None] * xh
    y = y.reshape(Bsz, 1, d_inner).to(x.dtype)
    y = _gated_norm(y * L.silu(z), p["gate_norm"][h0 * P:(h0 + H) * P],
                    cfg.norm_eps, dims(cfg)[0])
    out = torch.matmul(y, p["out_proj"])
    if split:
        out = pg.reduce_from_model(out)
    return x + out, (new_conv, h_new)


class SSMCache(NamedTuple):
    """Stacked-over-layers recurrent cache for decode."""

    conv: torch.Tensor    # (L, B, W-1, conv_ch)
    state: torch.Tensor   # (L, B, H, N, P) float32
    length: torch.Tensor  # (B,) int32

    @classmethod
    def zeros(cls, cfg: ModelConfig, batch: int, dtype=torch.bfloat16,
              device="cuda"):
        dev = resolve_device(device)
        d_inner, H, conv_ch = dims(cfg)
        return cls(
            torch.zeros((cfg.num_layers, batch, cfg.ssm_conv_width - 1,
                         conv_ch), dtype=dtype, device=dev),
            torch.zeros((cfg.num_layers, batch, H, cfg.ssm_state,
                         cfg.ssm_headdim), dtype=torch.float32, device=dev),
            torch.zeros((batch,), dtype=torch.int32, device=dev))


def forward(params, cfg: ModelConfig, tokens, features_only: bool = False):
    """Logits (B, S, vocab) float32 (or the final-norm features) and the
    aux loss 0.0."""
    x = L.embed(params["embed"], cfg, tokens)
    body = L.maybe_remat(lambda c, i: block_forward(
        L.index(params["blocks"], i), cfg, c)[0], cfg)
    for i in range(cfg.num_layers):
        x = body(x, i)
    x = L.rms_norm(x, params["final_norm"], cfg.norm_eps)
    if features_only:
        return x, 0.0
    return L.unembed(params["embed"], cfg, x), 0.0


def make_cache(cfg: ModelConfig, batch: int, max_len: int,
               dtype=torch.bfloat16, device="cuda") -> SSMCache:
    """An empty cache; the SSM cache has no length axis, so `max_len` is
    unused, as in the reference."""
    return SSMCache.zeros(cfg, batch, dtype, device=device)


def prefill(params, cfg: ModelConfig, tokens, max_len: Optional[int] = None,
            cache_dtype=torch.bfloat16):
    """(logits (B, S, vocab) float32, SSMCache after the prompt).
    `max_len` is unused: the SSM cache has no length axis."""
    x = L.embed(params["embed"], cfg, tokens)
    B, S = tokens.shape
    convs, states = [], []
    for i in range(cfg.num_layers):
        x, (conv, state) = block_forward(L.index(params["blocks"], i), cfg, x)
        convs.append(conv.to(cache_dtype))
        states.append(state)
    x = L.rms_norm(x, params["final_norm"], cfg.norm_eps)
    logits = L.unembed(params["embed"], cfg, x)
    cache = SSMCache(conv=torch.stack(convs), state=torch.stack(states),
                     length=torch.full((B,), S, dtype=torch.int32,
                                       device=tokens.device))
    return logits, cache


def decode_step(params, cfg: ModelConfig, tokens, cache: SSMCache):
    """One token (B, 1) against `cache`: (logits (B, 1, vocab), new cache)."""
    x = L.embed(params["embed"], cfg, tokens)
    convs, states = [], []
    for i in range(cfg.num_layers):
        conv = cache.conv[i]
        x, (new_conv, new_state) = block_decode(
            L.index(params["blocks"], i), cfg, x, conv.to(x.dtype), cache.state[i])
        convs.append(new_conv.to(conv.dtype))
        states.append(new_state)
    x = L.rms_norm(x, params["final_norm"], cfg.norm_eps)
    logits = L.unembed(params["embed"], cfg, x)
    return logits, SSMCache(conv=torch.stack(convs),
                            state=torch.stack(states),
                            length=cache.length + 1)
