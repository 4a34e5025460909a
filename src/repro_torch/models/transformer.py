"""Decoder-only transformer LM, the dense family (port of
`repro.models.transformer`): GQA, qk-norm, qkv bias, tied embeddings, the
SwiGLU or GELU MLP, and an `inputs_embeds` path.  The MoE FFN comes with
the moe family (ROADMAP A11); a moe config raises here.

Layer parameters are stacked on a leading axis, in the reference's
layout; its layer scan is a Python loop over the layers.

Three entry points:
  forward(params, cfg, tokens | inputs_embeds) -> logits, aux
  prefill(params, cfg, tokens, max_len)       -> logits, KVCache
  decode_step(params, cfg, tokens, KVCache)   -> logits, KVCache
"""
from __future__ import annotations

from typing import NamedTuple, Optional

import torch

from repro_torch._device import resolve_device
from repro_torch.configs.base import ModelConfig
from repro_torch.models import layers as L


class KVCache(NamedTuple):
    """Stacked-over-layers KV cache.  k, v: (L, B, Smax, Hkv, hd); length:
    (B,) valid prefix.  Decode writes k and v in place."""

    k: torch.Tensor
    v: torch.Tensor
    length: torch.Tensor

    @classmethod
    def zeros(cls, cfg: ModelConfig, batch: int, max_len: int,
              dtype=torch.bfloat16, device="cuda"):
        dev = resolve_device(device)
        shape = (cfg.num_layers, batch, max_len, cfg.num_kv_heads, cfg.hd())
        return cls(torch.zeros(shape, dtype=dtype, device=dev),
                   torch.zeros(shape, dtype=dtype, device=dev),
                   torch.zeros((batch,), dtype=torch.int32, device=dev))


def make_cache(cfg: ModelConfig, batch: int, max_len: int,
               dtype=torch.bfloat16, device="cuda") -> KVCache:
    return KVCache.zeros(cfg, batch, max_len, dtype, device=device)


def _dense_only(cfg: ModelConfig):
    if cfg.family != "dense":
        raise NotImplementedError(
            f"the port's transformer runs the dense family; {cfg.name} is "
            f"{cfg.family!r} (ROADMAP A11)")


def init_block(gen: torch.Generator, cfg: ModelConfig) -> dict:
    dt, dev = L.dtype_of(cfg), gen.device
    return {
        "attn_norm": torch.ones((cfg.d_model,), dtype=dt, device=dev),
        "mlp_norm": torch.ones((cfg.d_model,), dtype=dt, device=dev),
        "attn": L.init_attention(gen, cfg),
        "mlp": (L.init_mlp_gelu(gen, cfg) if cfg.mlp_type == "gelu"
                else L.init_mlp(gen, cfg)),
    }


def init(gen: torch.Generator, cfg: ModelConfig) -> dict:
    """Random parameters on the generator's device; every leaf of
    ``blocks`` has leading dim num_layers."""
    _dense_only(cfg)
    embed = L.init_embed(gen, cfg)
    return {
        "embed": embed,
        "blocks": L.stacked(cfg.num_layers, lambda: init_block(gen, cfg)),
        "final_norm": torch.ones((cfg.d_model,), dtype=L.dtype_of(cfg),
                                 device=gen.device),
    }


def param_shapes(cfg: ModelConfig) -> dict:
    """Every parameter's shape, keyed by its path in `init`'s tree
    (``blocks/attn/wq``, ...; blocks with leading axis L)."""
    Lyr, D = (cfg.num_layers,), (cfg.d_model,)
    out = L.embed_shapes(cfg)
    out["blocks/attn_norm"] = Lyr + D
    out["blocks/mlp_norm"] = Lyr + D
    out.update({f"blocks/attn/{k}": Lyr + v
                for k, v in L.attention_shapes(cfg).items()})
    out.update({f"blocks/mlp/{k}": Lyr + v
                for k, v in L.mlp_shapes(cfg).items()})
    out["final_norm"] = D
    return out


def _mlp_apply(cfg: ModelConfig, bp: dict, h):
    if cfg.mlp_type == "gelu":
        return L.mlp_gelu_block(bp["mlp"], h)
    return L.mlp_block(bp["mlp"], h)


def _embed(params, cfg, tokens, inputs_embeds):
    if inputs_embeds is None:
        return L.embed(params["embed"], cfg, tokens)
    return inputs_embeds.to(L.act_dtype_of(cfg))


def _block(cfg: ModelConfig, bp: dict, x, positions):
    """One pre-norm block: (output, (k, v) of its attention)."""
    h = L.rms_norm(x, bp["attn_norm"], cfg.norm_eps)
    attn_out, kv = L.attention_block(bp["attn"], cfg, h, positions,
                                     causal=True)
    x = x + attn_out
    h = L.rms_norm(x, bp["mlp_norm"], cfg.norm_eps)
    return x + _mlp_apply(cfg, bp, h), kv


def forward(params: dict, cfg: ModelConfig, tokens: Optional[torch.Tensor],
            inputs_embeds: Optional[torch.Tensor] = None,
            features_only: bool = False):
    """Full causal forward.  tokens: (B, S) (or inputs_embeds (B, S, D)).
    Returns (logits (B, S, V) float32, aux loss 0.0), or the final (B, S,
    D) features when `features_only`."""
    _dense_only(cfg)
    x = _embed(params, cfg, tokens, inputs_embeds)
    positions = L.positions(*x.shape[:2], x.device)
    for i in range(cfg.num_layers):
        x, _ = _block(cfg, L.index(params["blocks"], i), x, positions)
    x = L.rms_norm(x, params["final_norm"], cfg.norm_eps)
    if features_only:
        return x, 0.0
    return L.unembed(params["embed"], cfg, x), 0.0


def prefill(params: dict, cfg: ModelConfig, tokens: torch.Tensor,
            max_len: int, inputs_embeds: Optional[torch.Tensor] = None,
            cache_dtype=torch.bfloat16):
    """Forward + a KV cache of capacity max_len holding the prompt's k and
    v: (logits (B, S, V) float32, KVCache)."""
    _dense_only(cfg)
    x = _embed(params, cfg, tokens, inputs_embeds)
    B, S = x.shape[:2]
    positions = L.positions(B, S, x.device)
    cache = KVCache.zeros(cfg, B, max_len, cache_dtype, device=x.device)
    for i in range(cfg.num_layers):
        x, (k, v) = _block(cfg, L.index(params["blocks"], i), x, positions)
        cache.k[i, :, :S] = k
        cache.v[i, :, :S] = v
    x = L.rms_norm(x, params["final_norm"], cfg.norm_eps)
    logits = L.unembed(params["embed"], cfg, x)
    cache.length.fill_(S)
    return logits, cache


def decode_step(params: dict, cfg: ModelConfig, tokens: torch.Tensor,
                cache: KVCache):
    """One decode step.  tokens: (B, 1).  Returns (logits (B, 1, V), the
    cache with k and v written in place and length + 1)."""
    _dense_only(cfg)
    x = L.embed(params["embed"], cfg, tokens)
    pos = cache.length
    for i in range(cfg.num_layers):
        bp = L.index(params["blocks"], i)
        h = L.rms_norm(x, bp["attn_norm"], cfg.norm_eps)
        attn_out, _, _ = L.attention_decode(bp["attn"], cfg, h, cache.k[i],
                                            cache.v[i], pos)
        x = x + attn_out
        h = L.rms_norm(x, bp["mlp_norm"], cfg.norm_eps)
        x = x + _mlp_apply(cfg, bp, h)
    x = L.rms_norm(x, params["final_norm"], cfg.norm_eps)
    logits = L.unembed(params["embed"], cfg, x)
    return logits, KVCache(k=cache.k, v=cache.v, length=cache.length + 1)
