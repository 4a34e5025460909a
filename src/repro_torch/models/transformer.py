"""Decoder-only transformer LM, the dense and MoE families and llava's
backbone (port of `repro.models.transformer`): GQA, qk-norm, qkv bias,
tied embeddings, the SwiGLU or GELU MLP or the MoE FFN (`models.moe`),
and an `inputs_embeds` path.

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
from repro_torch.models import moe


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


def _is_moe(cfg: ModelConfig) -> bool:
    return cfg.family == "moe" and cfg.num_experts > 0


def init_block(gen: torch.Generator, cfg: ModelConfig) -> dict:
    dt, dev = L.dtype_of(cfg), gen.device
    p = {
        "attn_norm": torch.ones((cfg.d_model,), dtype=dt, device=dev),
        "mlp_norm": torch.ones((cfg.d_model,), dtype=dt, device=dev),
        "attn": L.init_attention(gen, cfg),
    }
    if _is_moe(cfg):
        p["moe"] = moe.init_moe(gen, cfg)
    elif cfg.mlp_type == "gelu":
        p["mlp"] = L.init_mlp_gelu(gen, cfg)
    else:
        p["mlp"] = L.init_mlp(gen, cfg)
    return p


def init(gen: torch.Generator, cfg: ModelConfig) -> dict:
    """Random parameters on the generator's device; every leaf of
    ``blocks`` has leading dim num_layers."""
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
    ffn, shapes = (("moe", moe.moe_shapes(cfg)) if _is_moe(cfg)
                   else ("mlp", L.mlp_shapes(cfg)))
    out.update({f"blocks/{ffn}/{k}": Lyr + v for k, v in shapes.items()})
    out["final_norm"] = D
    return out


def _ffn(cfg: ModelConfig, bp: dict, h):
    """The block's FFN: (output, its aux loss; 0.0 but for the MoE)."""
    if _is_moe(cfg):
        return moe.moe_block(bp["moe"], cfg, h)
    if cfg.mlp_type == "gelu":
        return L.mlp_gelu_block(bp["mlp"], h), 0.0
    return L.mlp_block(bp["mlp"], h), 0.0


def _embed(params, cfg, tokens, inputs_embeds):
    if inputs_embeds is None:
        return L.embed(params["embed"], cfg, tokens)
    return inputs_embeds.to(L.act_dtype_of(cfg))


def _block(cfg: ModelConfig, bp: dict, x, positions):
    """One pre-norm block: (output, (k, v) of its attention, aux loss)."""
    h = L.rms_norm(x, bp["attn_norm"], cfg.norm_eps)
    attn_out, kv = L.attention_block(bp["attn"], cfg, h, positions,
                                     causal=True)
    x = x + attn_out
    h = L.rms_norm(x, bp["mlp_norm"], cfg.norm_eps)
    out, aux = _ffn(cfg, bp, h)
    return x + out, kv, aux


def forward(params: dict, cfg: ModelConfig, tokens: Optional[torch.Tensor],
            inputs_embeds: Optional[torch.Tensor] = None,
            features_only: bool = False):
    """Full causal forward.  tokens: (B, S) (or inputs_embeds (B, S, D)).
    Returns (logits (B, S, V) float32, the layers' aux losses summed: 0.0
    but for the MoE), or the final (B, S, D) features when
    `features_only`."""
    x = _embed(params, cfg, tokens, inputs_embeds)
    positions = L.positions(*x.shape[:2], x.device)
    aux = 0.0
    for i in range(cfg.num_layers):
        x, _, a = _block(cfg, L.index(params["blocks"], i), x, positions)
        aux = aux + a
    x = L.rms_norm(x, params["final_norm"], cfg.norm_eps)
    if features_only:
        return x, aux
    return L.unembed(params["embed"], cfg, x), aux


def prefill(params: dict, cfg: ModelConfig, tokens: torch.Tensor,
            max_len: int, inputs_embeds: Optional[torch.Tensor] = None,
            cache_dtype=torch.bfloat16):
    """Forward + a KV cache of capacity max_len holding the prompt's k and
    v: (logits (B, S, V) float32, KVCache)."""
    x = _embed(params, cfg, tokens, inputs_embeds)
    B, S = x.shape[:2]
    positions = L.positions(B, S, x.device)
    cache = KVCache.zeros(cfg, B, max_len, cache_dtype, device=x.device)
    for i in range(cfg.num_layers):
        x, (k, v), _ = _block(cfg, L.index(params["blocks"], i), x,
                              positions)
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
    x = L.embed(params["embed"], cfg, tokens)
    pos = cache.length
    for i in range(cfg.num_layers):
        bp = L.index(params["blocks"], i)
        h = L.rms_norm(x, bp["attn_norm"], cfg.norm_eps)
        attn_out, _, _ = L.attention_decode(bp["attn"], cfg, h, cache.k[i],
                                            cache.v[i], pos)
        x = x + attn_out
        h = L.rms_norm(x, bp["mlp_norm"], cfg.norm_eps)
        x = x + _ffn(cfg, bp, h)[0]
    x = L.rms_norm(x, params["final_norm"], cfg.norm_eps)
    logits = L.unembed(params["embed"], cfg, x)
    return logits, KVCache(k=cache.k, v=cache.v, length=cache.length + 1)
