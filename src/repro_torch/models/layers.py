"""Building blocks the ported models share (port of `repro.models.layers`):
activation checkpointing (`maybe_remat`), dtypes, the dense initialiser,
RMSNorm and LayerNorm, RoPE, attention
(GQA, optional qk-norm and qkv bias; full, one token against a KV cache,
or cross-attention to an encoder's k and v), the SwiGLU and GELU MLPs, and
the token embedding with its (tied) unembedding.

Parameters are plain dicts of tensors, as the reference's are pytrees, in
the reference's layouts (``wq`` (D, H, hd), ``wo`` (H, hd, D)); the
products take (D, H * hd) views of them.  The rounding order is the
reference's: products in the activation dtype, attention scores cast to
float32 before the scale, the mask (-1e30) and the softmax, the weights
cast back to q's dtype before the product with v; RoPE in float32, cast
back.  Attention is plain PyTorch: the reference computes it outside any
Pallas kernel.  Random init draws from an explicit `torch.Generator`: the
numbers differ from `jax.random`'s, so the tests carry the reference's
parameters across (`repro_torch.interop`).

Tensor parallelism: a leaf may hold this rank's block of a dimension over
the model axis, as `distributed.ShardingRules` cut it (q heads, the FFN's
hidden width, the vocabulary).  Each block reads its leaves' shapes
against the config's (`process_group.model_block`) and runs the Megatron
form that GSPMD gives the reference: f (`process_group.copy_to_model`) at
the input of the column-parallel products, g (`reduce_from_model`) after
the row-parallel one; a whole leaf is used whole.  Where the kv heads do
not divide the model axis, wk and wv stay whole and a rank takes the kv
heads its q heads read.
"""
from __future__ import annotations

import math
from typing import Optional

import numpy as np
import torch
from torch.utils.checkpoint import (CheckpointPolicy, checkpoint,
                                    create_selective_checkpoint_contexts)

from repro_torch.configs.base import ModelConfig
from repro_torch.distributed import process_group as pg


def _dots_policy(ctx, op, *args, **kwargs):
    """Selective checkpointing's policy for ``remat="dots"``: keep the
    outputs of matrix products, recompute the rest (the counterpart of
    JAX's `dots_with_no_batch_dims_saveable`)."""
    aten = torch.ops.aten
    if op in (aten.mm.default, aten.bmm.default, aten.addmm.default,
              aten.matmul.default):
        return CheckpointPolicy.MUST_SAVE
    return CheckpointPolicy.PREFER_RECOMPUTE


def maybe_remat(fn, cfg: ModelConfig):
    """`fn` (a layer loop's body) under the configured activation-
    checkpointing policy, as the reference's `maybe_remat`: ``"none"``
    returns it as it is; ``"full"`` keeps none of its activations for the
    backward and runs it again there
    (`torch.utils.checkpoint.checkpoint`, non-reentrant); ``"dots"`` keeps
    the matrix products' outputs and recomputes the rest.  Outside grad
    mode, or where no argument of the body (its parameter dict included)
    requires grad (serving, eval), the body just runs.  Recomputing
    changes no number: the backward sees the same values."""
    if cfg.remat not in ("none", "full", "dots"):
        raise ValueError(f"remat {cfg.remat!r}: expected none, full or dots")
    if cfg.remat == "none":
        return fn
    kw = {"use_reentrant": False}
    if cfg.remat == "dots":
        kw["context_fn"] = lambda: create_selective_checkpoint_contexts(
            _dots_policy)

    def remat(*args):
        if not (torch.is_grad_enabled() and any(
                isinstance(t, torch.Tensor) and t.requires_grad
                for t in torch.utils._pytree.tree_leaves(args))):
            return fn(*args)
        return checkpoint(fn, *args, **kw)

    return remat


def dtype_of(cfg: ModelConfig) -> torch.dtype:
    return getattr(torch, cfg.param_dtype)


def act_dtype_of(cfg: ModelConfig) -> torch.dtype:
    return getattr(torch, cfg.activation_dtype)


def normal(gen: torch.Generator, shape, dtype, stddev: float):
    """N(0, stddev^2) drawn in float32 on the generator's device, then cast
    (the reference's `_normal`)."""
    return (torch.randn(shape, generator=gen, dtype=torch.float32,
                        device=gen.device) * stddev).to(dtype)


def dense_init(gen: torch.Generator, in_dim: int, out_dim, dtype):
    """An (in_dim, *out_dim) weight with stddev 1 / sqrt(in_dim); out_dim
    an int or a tuple (the attention projections' (heads, head_dim))."""
    out = tuple(out_dim) if isinstance(out_dim, (tuple, list)) else (out_dim,)
    return normal(gen, (in_dim,) + out, dtype, 1.0 / math.sqrt(in_dim))


def stacked(n: int, make) -> dict:
    """`make()` called n times (a nested dict of tensors each time),
    stacked leaf by leaf on a new leading axis: the reference's `vmap`ped
    init over layers.  Each stacked leaf is allocated once and filled, so
    a model's blocks are never held twice."""
    out = None
    for i in range(n):
        one = make()
        if out is None:
            out = _map(lambda t: t.new_empty((n,) + tuple(t.shape)), one)
        _fill(out, one, i)
    return out


def _map(fn, tree):
    return {k: _map(fn, v) if isinstance(v, dict) else fn(v)
            for k, v in tree.items()}


def _fill(out, one, i):
    for k, v in one.items():
        if isinstance(v, dict):
            _fill(out[k], v, i)
        else:
            out[k][i] = v


def index(tree: dict, *idx) -> dict:
    """The slice `idx` of every leaf of a nested dict (a layer's
    parameters out of the stacked ones; views, no copy).  Under FSDP
    (`process_group.fsdp`) a leaf split over the data axis is gathered
    whole here (`fsdp_whole`): the layer loops call this inside the
    remat'd body, so a full remat gathers again in the recompute instead
    of keeping the whole leaves for the backward."""
    return _map(lambda t: pg.fsdp_whole(t[idx]), tree)


def compute_dtype(dtype: torch.dtype) -> torch.dtype:
    """The dtype the models upcast to: float32 for bf16 and float32 (the
    reference's ``astype(jnp.float32)``), float64 for float64, so that a
    float64 model runs in float64 end to end."""
    return torch.promote_types(dtype, torch.float32)


def upcast(x: torch.Tensor) -> torch.Tensor:
    """x in `compute_dtype(x.dtype)`."""
    return x.to(compute_dtype(x.dtype))


def rms_norm(x: torch.Tensor, w: torch.Tensor, eps: float) -> torch.Tensor:
    """RMSNorm over the last axis, in float32 (float64 for a float64 x),
    cast back to x's dtype."""
    xf = upcast(x)
    var = torch.mean(xf * xf, dim=-1, keepdim=True)
    y = xf * torch.rsqrt(var + eps)
    return (y * w.to(xf.dtype)).to(x.dtype)


def layer_norm(x: torch.Tensor, w: torch.Tensor, b: torch.Tensor,
               eps: float) -> torch.Tensor:
    """LayerNorm over the last axis in float32 (float64 for a float64 x;
    the population variance, the mean of the centred squares, as
    `jnp.var`), cast back to x's dtype once."""
    xf = upcast(x)
    centred = xf - torch.mean(xf, dim=-1, keepdim=True)
    var = torch.mean(centred * centred, dim=-1, keepdim=True)
    y = centred * torch.rsqrt(var + eps)
    return (y * w.to(xf.dtype) + b.to(xf.dtype)).to(x.dtype)


def sigmoid(x):
    """jax.nn.sigmoid as XLA expands it: 1 / (1 + exp(-x)), each step
    rounded to x's dtype (in bf16 `torch.sigmoid`, rounded once, differs
    from it in about a third of the elements)."""
    return 1 / (1 + torch.exp(-x))


def silu(x):
    """jax.nn.silu: x * sigmoid(x), in x's dtype."""
    return x * sigmoid(x)


# ---------------------------------------------------------------------------
# Rotary position embedding
# ---------------------------------------------------------------------------

def rope(x: torch.Tensor, positions: torch.Tensor,
         theta: float) -> torch.Tensor:
    """Apply RoPE.  x: (B, S, H, hd); positions: (B, S) int.  The
    frequencies are the reference's numpy float32 ones; angles and the
    rotation are float32 (float64 for a float64 x), cast back to x's
    dtype."""
    hd = x.shape[-1]
    half = hd // 2
    up = compute_dtype(x.dtype)
    freqs = torch.tensor(
        (1.0 / (theta ** (np.arange(0, half, dtype=np.float32) / half)))
        .tolist(), dtype=up, device=x.device)
    ang = positions[..., None].to(up) * freqs            # (B, S, half)
    cos = torch.cos(ang)[:, :, None, :]
    sin = torch.sin(ang)[:, :, None, :]
    x1, x2 = x[..., :half], x[..., half:]
    y1 = x1 * cos - x2 * sin
    y2 = x2 * cos + x1 * sin
    return torch.cat([y1, y2], dim=-1).to(x.dtype)


# ---------------------------------------------------------------------------
# Attention (GQA, optional qk-norm / qkv-bias, full or cached)
# ---------------------------------------------------------------------------

def init_attention(gen: torch.Generator, cfg: ModelConfig) -> dict:
    D, H, Hkv, hd = cfg.d_model, cfg.num_heads, cfg.num_kv_heads, cfg.hd()
    dt = dtype_of(cfg)
    dev = gen.device
    p = {
        "wq": dense_init(gen, D, (H, hd), dt),
        "wk": dense_init(gen, D, (Hkv, hd), dt),
        "wv": dense_init(gen, D, (Hkv, hd), dt),
        "wo": normal(gen, (H, hd, D), dt, 1.0 / math.sqrt(H * hd)),
    }
    if cfg.qkv_bias:
        p["bq"] = torch.zeros((H, hd), dtype=dt, device=dev)
        p["bk"] = torch.zeros((Hkv, hd), dtype=dt, device=dev)
        p["bv"] = torch.zeros((Hkv, hd), dtype=dt, device=dev)
    if cfg.qk_norm:
        p["q_norm"] = torch.ones((hd,), dtype=dt, device=dev)
        p["k_norm"] = torch.ones((hd,), dtype=dt, device=dev)
    return p


def attention_shapes(cfg: ModelConfig) -> dict:
    """`init_attention`'s shapes, by name."""
    D, H, Hkv, hd = cfg.d_model, cfg.num_heads, cfg.num_kv_heads, cfg.hd()
    out = {"wq": (D, H, hd), "wk": (D, Hkv, hd), "wv": (D, Hkv, hd),
           "wo": (H, hd, D)}
    if cfg.qkv_bias:
        out.update(bq=(H, hd), bk=(Hkv, hd), bv=(Hkv, hd))
    if cfg.qk_norm:
        out.update(q_norm=(hd,), k_norm=(hd,))
    return out


def _heads(x, w):
    """einsum("bsd,dhk->bshk", x, w) as one product with w's (D, H * hd)
    view."""
    return torch.matmul(x, w.reshape(w.shape[0], -1)).unflatten(
        -1, tuple(w.shape[1:]))


def _q_block(p, cfg: ModelConfig):
    """(index, count): this rank's block of the q heads ((0, 1): wq
    whole)."""
    return pg.model_block(p["wq"].shape[-2], cfg.num_heads)


def _column_input(p, cfg: ModelConfig, x):
    """x as the q/k/v products' input: through f where the heads are
    split."""
    return pg.copy_to_model(x) if _q_block(p, cfg)[1] > 1 else x


def _kv_heads(p, cfg: ModelConfig, w):
    """`w` (wk, wv, bk or bv; heads on dim -2) as this rank's q heads read
    it: as it is where it is split with wq, or nothing is split; where it
    is whole while wq is split (num_kv_heads does not divide the model
    axis), the kv heads of this rank's q heads, in order (one copy a q
    head where a block of q heads does not map onto whole kv groups)."""
    m, n = _q_block(p, cfg)
    if n == 1 or w.shape[-2] < cfg.num_kv_heads:
        return w
    hl = cfg.num_heads // n
    rep = cfg.num_heads // cfg.num_kv_heads
    if hl % rep == 0 or rep % hl == 0:
        return w.narrow(-2, m * hl // rep, max(hl // rep, 1))
    idx = torch.arange(m * hl, (m + 1) * hl, device=w.device) // rep
    return w.index_select(w.dim() - 2, idx)


def _out(p, cfg: ModelConfig, o):
    """einsum("bshk,hkd->bsd", o, wo); with the heads split, this rank's
    part summed over the model axis (g)."""
    wo = p["wo"]
    out = torch.matmul(o.flatten(-2), wo.reshape(-1, wo.shape[-1]))
    return pg.reduce_from_model(out) if _q_block(p, cfg)[1] > 1 else out


def _qkv(p, cfg: ModelConfig, x, positions):
    x = _column_input(p, cfg, x)
    q = _heads(x, p["wq"])
    k = _heads(x, _kv_heads(p, cfg, p["wk"]))
    v = _heads(x, _kv_heads(p, cfg, p["wv"]))
    if cfg.qkv_bias:
        q = q + p["bq"]
        k = k + _kv_heads(p, cfg, p["bk"])
        v = v + _kv_heads(p, cfg, p["bv"])
    if cfg.qk_norm:
        q = rms_norm(q, p["q_norm"], cfg.norm_eps)
        k = rms_norm(k, p["k_norm"], cfg.norm_eps)
    if positions is not None:
        q = rope(q, positions, cfg.rope_theta)
        k = rope(k, positions, cfg.rope_theta)
    return q, k, v


def sdpa(q, k, v, *, causal: bool, q_positions=None, kv_len=None):
    """Scaled dot-product attention with GQA.

    q: (B, Sq, H, hd); k, v: (B, Skv, Hkv, hd); q head h uses kv head
    h // (H / Hkv).  causal: mask col > row (rows offset by `q_positions`
    when given).  kv_len: (B,) valid prefix length of k/v (decode against
    a padded cache).  Softmax in float32.

    When `runtime.ATTN_Q_CHUNK` is set and Sq exceeds it and divides by
    it, the queries go in chunks of that size, so the float32 scores are
    (B, H, chunk, Skv) instead of (B, H, Sq, Skv): the memory-bounded
    schedule of long-context prefill (the same math a row at a time, as
    the reference's `lax.scan` over the chunks).
    """
    from repro_torch.models import runtime

    B, Sq = q.shape[:2]
    qc = runtime.ATTN_Q_CHUNK
    if qc and Sq > qc and Sq % qc == 0:
        if q_positions is None:
            q_positions = torch.arange(Sq, device=q.device).expand(B, Sq)
        return torch.cat([
            _sdpa_full(q[:, i:i + qc], k, v, causal=causal,
                       q_positions=q_positions[:, i:i + qc], kv_len=kv_len)
            for i in range(0, Sq, qc)], dim=1)
    return _sdpa_full(q, k, v, causal=causal, q_positions=q_positions,
                      kv_len=kv_len)


def _scores(q, k):
    """(B, Hkv, rep, Sq, Skv) float32 scores q.k / sqrt(hd) (float64 for
    a float64 q): the product in q's dtype, then upcast, a copy in either
    dtype, so the in-place
    steps after it touch neither the caller's tensors nor the product
    itself (which `maybe_remat`'s "dots" policy keeps)."""
    B, Sq, H, hd = q.shape
    Hkv = k.shape[2]
    qr = q.reshape(B, Sq, Hkv, H // Hkv, hd)
    scores = torch.einsum("bqhrd,bkhd->bhrqk", qr, k).to(
        compute_dtype(q.dtype), copy=True)
    return scores.div_(float(np.float32(np.sqrt(hd))))


def _sdpa_full(q, k, v, *, causal: bool, q_positions=None, kv_len=None):
    B, Sq, H, hd = q.shape
    Skv = k.shape[1]
    scores = _scores(q, k)
    cols = torch.arange(Skv, device=q.device)
    if causal:
        rows = (q_positions if q_positions is not None
                else torch.arange(Sq, device=q.device).expand(B, Sq))
        mask = cols[None, None, :] <= rows[:, :, None]       # (B, Sq, Skv)
        scores.masked_fill_(~mask[:, None, None], -1e30)
    if kv_len is not None:
        lmask = cols[None, :] < kv_len[:, None]              # (B, Skv)
        scores.masked_fill_(~lmask[:, None, None, None, :], -1e30)
    w = torch.softmax(scores, dim=-1).to(q.dtype)
    out = torch.einsum("bhrqk,bkhd->bqhrd", w, v)
    return out.reshape(B, Sq, H, hd)


def sdpa_split(q, k, v, kv_len, first: int, group):
    """`sdpa` (not causal) of queries against this rank's block of the
    keys and values, positions [first, first + Skv), the others' blocks
    on the other ranks of `group` (a cache whose sequence is split over
    the data axis): the softmax split over the ranks.  The float32
    scores' max over the ranks (detached: it cancels), then each rank's
    sum of exp and exp-weighted values all-reduced in float32 together,
    divided and cast to q's dtype.  A position at or past kv_len adds 0."""
    B, Sq, H, hd = q.shape
    Skv, Hkv = k.shape[1], k.shape[2]
    scores = _scores(q, k)
    cols = first + torch.arange(Skv, device=q.device)
    lmask = cols[None, :] < kv_len[:, None]                  # (B, Skv)
    scores.masked_fill_(~lmask[:, None, None, None, :], -1e30)
    top = group.all_reduce_(torch.amax(scores, dim=-1, keepdim=True),
                            op=torch.distributed.ReduceOp.MAX)
    e = torch.exp(scores - top)
    e = torch.where(lmask[:, None, None, None, :], e, 0)
    o = torch.einsum("bhrqk,bkhd->bhrqd", e, upcast(v))
    both = group.all_reduce_(torch.cat([o, e.sum(-1, keepdim=True)], -1))
    out = both[..., :hd] / both[..., hd:]
    return out.permute(0, 3, 1, 2, 4).reshape(B, Sq, H, hd).to(q.dtype)


def attention_block(p, cfg: ModelConfig, x, positions, *, causal=True):
    """Full (prefill / forward) self-attention.  Returns (out, (k, v))."""
    q, k, v = _qkv(p, cfg, x, positions)
    o = sdpa(q, k, v, causal=causal)
    return _out(p, cfg, o), (k, v)


def attention_decode(p, cfg: ModelConfig, x, k_cache, v_cache, pos):
    """One-token decode against a KV cache.

    x: (B, 1, D); k_cache/v_cache: (B, Smax, Hkv, hd); pos: (B,) current
    lengths.  Row b's new k and v are written at pos[b], in place (the
    reference selects them in with a one-hot mask: the same values), and
    the query attends to the first pos + 1 entries.  Returns (out,
    k_cache, v_cache), the caches the same tensors as given.

    With the cache's sequence split over the data axis
    (`process_group.kv_sequence`), the caches hold this rank's block of
    the positions: the rank holding pos[b] writes it (the others write
    back what they hold) and the softmax is split over the ranks
    (`sdpa_split`)."""
    B = x.shape[0]
    q, k, v = _qkv(p, cfg, x, pos[:, None])
    rows, at = torch.arange(B, device=x.device), pos.long()
    seq = pg.kv_sequence_group()
    if seq is None:
        k_cache[rows, at] = k[:, 0].to(k_cache.dtype)
        v_cache[rows, at] = v[:, 0].to(v_cache.dtype)
        o = sdpa(q, k_cache.to(q.dtype), v_cache.to(q.dtype), causal=False,
                 kv_len=pos + 1)
        return _out(p, cfg, o), k_cache, v_cache
    n = k_cache.shape[1]
    first = seq.rank * n
    local = at - first
    mine = ((local >= 0) & (local < n))[:, None, None]
    local = local.clamp(0, n - 1)
    for cache, new in ((k_cache, k), (v_cache, v)):
        cache[rows, local] = torch.where(mine, new[:, 0].to(cache.dtype),
                                         cache[rows, local])
    o = sdpa_split(q, k_cache.to(q.dtype), v_cache.to(q.dtype), pos + 1,
                   first, seq)
    return _out(p, cfg, o), k_cache, v_cache


def kv_cache_shape(p, cfg: ModelConfig, batch: int, max_len: int) -> tuple:
    """(batch, positions, kv heads, hd) of one layer's k (or v) cache of
    capacity `max_len` as this rank holds it: the kv heads its q heads
    read (`_kv_heads`: this rank's block where they are split), and its
    block of the positions where the sequence is split over the data axis
    (`process_group.kv_sequence`)."""
    seq = pg.kv_sequence_group()
    if seq is not None and max_len % seq.world:
        raise ValueError(f"a cache of {max_len} positions does not split "
                         f"over {seq.world} ranks")
    n = max_len // seq.world if seq is not None else max_len
    return (batch, n, _kv_heads(p, cfg, p["wk"]).shape[-2], cfg.hd())


def write_prompt_kv(cache, new):
    """The prompt's k (or v) (B, S, Hkv, hd) written into one layer's
    cache (B, Smax, Hkv, hd) from position 0: where the sequence is split
    over the data axis, the prompt's positions in this rank's block."""
    S = new.shape[1]
    seq = pg.kv_sequence_group()
    if seq is None:
        cache[:, :S] = new
        return
    n = cache.shape[1]
    lo, hi = seq.rank * n, min((seq.rank + 1) * n, S)
    if hi > lo:
        cache[:, :hi - lo] = new[:, lo:hi]


def cross_attention_block(p, cfg: ModelConfig, x, enc_kv):
    """Cross-attention (whisper's decoder): x's queries against enc_kv =
    (k, v), computed once from the encoder's output (`encoder_kv`); no
    RoPE, no mask."""
    q = _heads(_column_input(p, cfg, x), p["wq"])
    if cfg.qkv_bias:
        q = q + p["bq"]
    k, v = enc_kv
    return _out(p, cfg, sdpa(q, k, v, causal=False))


def encoder_kv(p, cfg: ModelConfig, enc_out):
    """The cross-attention's (k, v), each (B, S_enc, Hkv, hd) (this
    rank's kv heads where the heads are split), from the encoder's output
    (B, S_enc, D)."""
    enc_out = _column_input(p, cfg, enc_out)
    k = _heads(enc_out, _kv_heads(p, cfg, p["wk"]))
    v = _heads(enc_out, _kv_heads(p, cfg, p["wv"]))
    if cfg.qkv_bias:
        k = k + _kv_heads(p, cfg, p["bk"])
        v = v + _kv_heads(p, cfg, p["bv"])
    return k, v


# ---------------------------------------------------------------------------
# MLPs: SwiGLU, and the classic 2-matrix GELU with biases (granite)
# ---------------------------------------------------------------------------

def init_mlp(gen: torch.Generator, cfg: ModelConfig,
             d_ff: Optional[int] = None) -> dict:
    D, Fd, dt = cfg.d_model, d_ff or cfg.d_ff, dtype_of(cfg)
    return {
        "w_gate": dense_init(gen, D, Fd, dt),
        "w_up": dense_init(gen, D, Fd, dt),
        "w_down": dense_init(gen, Fd, D, dt),
    }


def mlp_shapes(cfg: ModelConfig) -> dict:
    """The shapes of `init_mlp_gelu` when cfg.mlp_type is "gelu", else of
    `init_mlp`, by name."""
    if cfg.mlp_type == "gelu":
        return mlp_gelu_shapes(cfg)
    D, Fd = cfg.d_model, cfg.d_ff
    return {"w_gate": (D, Fd), "w_up": (D, Fd), "w_down": (Fd, D)}


def mlp_gelu_shapes(cfg: ModelConfig) -> dict:
    """`init_mlp_gelu`'s shapes, by name."""
    D, Fd = cfg.d_model, cfg.d_ff
    return {"w_in": (D, Fd), "b_in": (Fd,), "w_out": (Fd, D), "b_out": (D,)}


def _ff_split(p, name: str, d_ff: Optional[int]) -> bool:
    """Whether the FFN's hidden width is split over the model axis: its
    leaf `name` (hidden width last) holds a block of `d_ff` (None: the
    leaves are whole)."""
    n = p[name].shape[-1]
    return pg.model_block(n, d_ff or n)[1] > 1


def mlp_block(p, x, d_ff: Optional[int] = None):
    """SwiGLU.  `d_ff`, the config's hidden width: where the leaves hold a
    block of it, column-parallel w_gate/w_up and row-parallel w_down (f
    before, g after)."""
    split = _ff_split(p, "w_gate", d_ff)
    if split:
        x = pg.copy_to_model(x)
    g = torch.matmul(x, p["w_gate"])
    u = torch.matmul(x, p["w_up"])
    out = torch.matmul(silu(g) * u, p["w_down"])
    return pg.reduce_from_model(out) if split else out


def init_mlp_gelu(gen: torch.Generator, cfg: ModelConfig,
                  d_ff: Optional[int] = None) -> dict:
    D, Fd, dt = cfg.d_model, d_ff or cfg.d_ff, dtype_of(cfg)
    dev = gen.device
    return {
        "w_in": dense_init(gen, D, Fd, dt),
        "b_in": torch.zeros((Fd,), dtype=dt, device=dev),
        "w_out": dense_init(gen, Fd, D, dt),
        "b_out": torch.zeros((D,), dtype=dt, device=dev),
    }


def gelu(x):
    """jax.nn.gelu's default, the tanh approximation, step by step in x's
    dtype with its constants rounded to that dtype, as the reference
    computes it."""
    def const(v):
        return torch.tensor(v, dtype=x.dtype, device=x.device)

    inner = const(float(np.sqrt(2 / np.pi))) * (
        x + const(0.044715) * (x * x * x))
    return x * (0.5 * (1.0 + torch.tanh(inner)))


def mlp_gelu_block(p, x, d_ff: Optional[int] = None):
    """The GELU MLP with biases; with the hidden width split (`d_ff` as in
    `mlp_block`), w_in/b_in column-parallel, w_out row-parallel, and the
    whole b_out added once, after g."""
    split = _ff_split(p, "w_in", d_ff)
    if split:
        x = pg.copy_to_model(x)
    h = torch.matmul(x, p["w_in"]) + p["b_in"]
    out = torch.matmul(gelu(h), p["w_out"])
    if split:
        out = pg.reduce_from_model(out)
    return out + p["b_out"]


# ---------------------------------------------------------------------------
# Embedding / head
# ---------------------------------------------------------------------------

def init_embed(gen: torch.Generator, cfg: ModelConfig) -> dict:
    p = {"embedding": normal(gen, (cfg.vocab_size, cfg.d_model),
                             dtype_of(cfg), 0.02)}
    if not cfg.tie_embeddings:
        p["lm_head"] = dense_init(gen, cfg.d_model, cfg.vocab_size,
                                  dtype_of(cfg))
    return p


def embed_shapes(cfg: ModelConfig) -> dict:
    """`init_embed`'s shapes, keyed ``embed/<name>``."""
    D, V = cfg.d_model, cfg.vocab_size
    out = {"embed/embedding": (V, D)}
    if not cfg.tie_embeddings:
        out["embed/lm_head"] = (D, V)
    return out


def positions(B: int, S: int, device) -> torch.Tensor:
    """Token positions (B, S) int32, 0..S-1 on every row (left-padded
    prompts included, as in the reference)."""
    return torch.arange(S, dtype=torch.int32, device=device).expand(B, S)


def embed(p: dict, cfg: ModelConfig, tokens: torch.Tensor) -> torch.Tensor:
    """The tokens' rows of the embedding, in the activation dtype.  With
    the vocabulary split over the model axis: each rank looks up the
    tokens in its block (others zero) and g sums the ranks' rows."""
    w = p["embedding"]
    m, n = pg.model_block(w.shape[0], cfg.vocab_size)
    if n == 1:
        return w[tokens.long()].to(act_dtype_of(cfg))
    t = tokens.long() - m * w.shape[0]
    inside = (t >= 0) & (t < w.shape[0])
    rows = w[t.clamp(0, w.shape[0] - 1)].to(act_dtype_of(cfg))
    return pg.reduce_from_model(torch.where(inside[..., None], rows, 0))


def unembedding(p: dict, cfg: ModelConfig) -> torch.Tensor:
    """The (D, vocab) unembedding: the tied embedding's transpose or
    lm_head (this rank's block of the vocabulary where it is split)."""
    return p["embedding"].t() if cfg.tie_embeddings else p["lm_head"]


def vocab_first(p: dict, cfg: ModelConfig) -> Optional[int]:
    """The first vocabulary entry of this rank's logits: None where the
    unembedding is whole, else its block's start."""
    n = unembedding(p, cfg).shape[-1]
    m, count = pg.model_block(n, cfg.vocab_size)
    return None if count == 1 else m * n


def unembed(p: dict, cfg: ModelConfig, x: torch.Tensor) -> torch.Tensor:
    """Logits (..., vocab) in float32 (float64 for a float64 x); the
    product is taken in x's dtype,
    as the reference's einsum is.  With the vocabulary split over the
    model axis: this rank's block of the logits (from `vocab_first`), x
    through f."""
    w = unembedding(p, cfg)
    if vocab_first(p, cfg) is not None:
        x = pg.copy_to_model(x)
    return upcast(torch.matmul(x, w))
