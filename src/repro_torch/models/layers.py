"""Building blocks the ported models share (port of `repro.models.layers`):
dtypes, the dense initialiser, RMSNorm and LayerNorm, RoPE, attention
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
"""
from __future__ import annotations

import math
from typing import Optional

import numpy as np
import torch

from repro_torch.configs.base import ModelConfig


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
    parameters out of the stacked ones; views, no copy)."""
    return _map(lambda t: t[idx], tree)


def rms_norm(x: torch.Tensor, w: torch.Tensor, eps: float) -> torch.Tensor:
    """RMSNorm over the last axis, in float32, cast back to x's dtype."""
    xf = x.float()
    var = torch.mean(xf * xf, dim=-1, keepdim=True)
    y = xf * torch.rsqrt(var + eps)
    return (y * w.float()).to(x.dtype)


def layer_norm(x: torch.Tensor, w: torch.Tensor, b: torch.Tensor,
               eps: float) -> torch.Tensor:
    """LayerNorm over the last axis in float32 (the population variance,
    the mean of the centred squares, as `jnp.var`), cast back to x's
    dtype once."""
    xf = x.float()
    centred = xf - torch.mean(xf, dim=-1, keepdim=True)
    var = torch.mean(centred * centred, dim=-1, keepdim=True)
    y = centred * torch.rsqrt(var + eps)
    return (y * w.float() + b.float()).to(x.dtype)


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
    rotation are float32, cast back to x's dtype."""
    hd = x.shape[-1]
    half = hd // 2
    freqs = torch.as_tensor(
        1.0 / (theta ** (np.arange(0, half, dtype=np.float32) / half)),
        device=x.device)
    ang = positions[..., None].float() * freqs            # (B, S, half)
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


def _out(p, o):
    """einsum("bshk,hkd->bsd", o, wo)."""
    wo = p["wo"]
    return torch.matmul(o.flatten(-2), wo.reshape(-1, wo.shape[-1]))


def _qkv(p, cfg: ModelConfig, x, positions):
    q, k, v = _heads(x, p["wq"]), _heads(x, p["wk"]), _heads(x, p["wv"])
    if cfg.qkv_bias:
        q = q + p["bq"]
        k = k + p["bk"]
        v = v + p["bv"]
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

    The scores are (B, H, Sq, Skv) at once.  The reference's
    query-chunked branch (`runtime.ATTN_Q_CHUNK`) is set only by its
    language-model dry run (`launch/dryrun.run_cell`), which the port does
    not have (ROADMAP A11).
    """
    B, Sq, H, hd = q.shape
    Skv, Hkv = k.shape[1], k.shape[2]
    rep = H // Hkv
    qr = q.reshape(B, Sq, Hkv, rep, hd)
    # the product in q's dtype, then float32 (a fresh tensor in either
    # dtype: the in-place steps below touch nothing of the caller's)
    scores = torch.einsum("bqhrd,bkhd->bhrqk", qr, k).float()
    scores.div_(float(np.float32(np.sqrt(hd))))
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


def attention_block(p, cfg: ModelConfig, x, positions, *, causal=True):
    """Full (prefill / forward) self-attention.  Returns (out, (k, v))."""
    q, k, v = _qkv(p, cfg, x, positions)
    o = sdpa(q, k, v, causal=causal)
    return _out(p, o), (k, v)


def attention_decode(p, cfg: ModelConfig, x, k_cache, v_cache, pos):
    """One-token decode against a KV cache.

    x: (B, 1, D); k_cache/v_cache: (B, Smax, Hkv, hd); pos: (B,) current
    lengths.  Row b's new k and v are written at pos[b], in place (the
    reference selects them in with a one-hot mask: the same values), and
    the query attends to the first pos + 1 entries.  Returns (out,
    k_cache, v_cache), the caches the same tensors as given."""
    B = x.shape[0]
    q, k, v = _qkv(p, cfg, x, pos[:, None])
    rows, at = torch.arange(B, device=x.device), pos.long()
    k_cache[rows, at] = k[:, 0].to(k_cache.dtype)
    v_cache[rows, at] = v[:, 0].to(v_cache.dtype)
    o = sdpa(q, k_cache.to(q.dtype), v_cache.to(q.dtype), causal=False,
             kv_len=pos + 1)
    return _out(p, o), k_cache, v_cache


def cross_attention_block(p, cfg: ModelConfig, x, enc_kv):
    """Cross-attention (whisper's decoder): x's queries against enc_kv =
    (k, v), computed once from the encoder's output (`encoder_kv`); no
    RoPE, no mask."""
    q = _heads(x, p["wq"])
    if cfg.qkv_bias:
        q = q + p["bq"]
    k, v = enc_kv
    return _out(p, sdpa(q, k, v, causal=False))


def encoder_kv(p, cfg: ModelConfig, enc_out):
    """The cross-attention's (k, v), each (B, S_enc, Hkv, hd), from the
    encoder's output (B, S_enc, D)."""
    k, v = _heads(enc_out, p["wk"]), _heads(enc_out, p["wv"])
    if cfg.qkv_bias:
        k = k + p["bk"]
        v = v + p["bv"]
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


def mlp_block(p, x):
    g = torch.matmul(x, p["w_gate"])
    u = torch.matmul(x, p["w_up"])
    return torch.matmul(silu(g) * u, p["w_down"])


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


def mlp_gelu_block(p, x):
    h = torch.matmul(x, p["w_in"]) + p["b_in"]
    return torch.matmul(gelu(h), p["w_out"]) + p["b_out"]


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
    return p["embedding"][tokens.long()].to(act_dtype_of(cfg))


def unembed(p: dict, cfg: ModelConfig, x: torch.Tensor) -> torch.Tensor:
    """Logits (..., vocab) in float32; the product is taken in x's dtype,
    as the reference's einsum is."""
    if cfg.tie_embeddings:
        logits = torch.matmul(x, p["embedding"].t())
    else:
        logits = torch.matmul(x, p["lm_head"])
    return logits.float()
