"""Zamba2-style hybrid (port of `repro.models.zamba2`): a Mamba2 backbone
plus one *shared* attention block applied every `shared_attn_every`
layers, its weights reused at each application.  zamba2-2.7b's 54 layers
with every = 6 make 9 super-blocks of (6 Mamba2 blocks, 1 shared
attention + MLP call).

The Mamba2 blocks are the port's own (`mamba2.block_forward`, whose
prefill scan is kernel B2 on a card, and `mamba2.block_decode`).  Their
parameters keep the reference's layout, leaves (n_super, k_every, ...);
the reference's two nested layer scans are two Python loops.  The shared
block's KV cache has one slot per application (9 here).
"""
from __future__ import annotations

from typing import NamedTuple

import torch

from repro_torch._device import resolve_device
from repro_torch.configs.base import ModelConfig
from repro_torch.models import layers as L
from repro_torch.models import mamba2


def n_superblocks(cfg: ModelConfig) -> int:
    k = cfg.shared_attn_every
    assert k and cfg.num_layers % k == 0, \
        f"num_layers={cfg.num_layers} must divide by shared_attn_every={k}"
    return cfg.num_layers // k


class HybridCache(NamedTuple):
    """SSM cache for all Mamba2 layers + a KV cache per shared-attention
    application.  Decode writes k and v in place."""

    conv: torch.Tensor     # (L, B, W-1, conv_ch), the cache dtype
    state: torch.Tensor    # (L, B, H, N, P) float32
    k: torch.Tensor        # (n_super, B, Smax, Hkv, hd), the cache dtype
    v: torch.Tensor
    length: torch.Tensor   # (B,) int32

    @classmethod
    def zeros(cls, cfg: ModelConfig, batch: int, max_len: int,
              dtype=torch.bfloat16, device="cuda"):
        dev = resolve_device(device)
        d_inner, H, conv_ch = mamba2.dims(cfg)
        kv = (n_superblocks(cfg), batch, max_len, cfg.num_kv_heads,
              cfg.hd())
        return cls(
            torch.zeros((cfg.num_layers, batch, cfg.ssm_conv_width - 1,
                         conv_ch), dtype=dtype, device=dev),
            torch.zeros((cfg.num_layers, batch, H, cfg.ssm_state,
                         cfg.ssm_headdim), dtype=torch.float32, device=dev),
            torch.zeros(kv, dtype=dtype, device=dev),
            torch.zeros(kv, dtype=dtype, device=dev),
            torch.zeros((batch,), dtype=torch.int32, device=dev))


def init(gen: torch.Generator, cfg: ModelConfig) -> dict:
    """Random parameters on the generator's device: the Mamba2 blocks
    stacked to (n_super, k_every, ...), the shared block once."""
    ns, k_every = n_superblocks(cfg), cfg.shared_attn_every
    embed = L.init_embed(gen, cfg)
    blocks = L.stacked(cfg.num_layers, lambda: mamba2.init_block(gen, cfg))
    dt, dev = L.dtype_of(cfg), gen.device
    shared = {
        "attn_norm": torch.ones((cfg.d_model,), dtype=dt, device=dev),
        "attn": L.init_attention(gen, cfg),
        "mlp_norm": torch.ones((cfg.d_model,), dtype=dt, device=dev),
        "mlp": L.init_mlp(gen, cfg),
    }
    return {
        "embed": embed,
        "mamba_blocks": {k: v.reshape((ns, k_every) + tuple(v.shape[1:]))
                         for k, v in blocks.items()},
        "shared": shared,
        "final_norm": torch.ones((cfg.d_model,), dtype=dt, device=dev),
    }


def param_shapes(cfg: ModelConfig) -> dict:
    """Every parameter's shape, keyed by its path in `init`'s tree
    (``mamba_blocks/in_x``, ``shared/attn/wq``, ...)."""
    lead = (n_superblocks(cfg), cfg.shared_attn_every)
    out = L.embed_shapes(cfg)
    out.update({f"mamba_blocks/{k}": lead + v
                for k, v in mamba2.block_shapes(cfg).items()})
    out["shared/attn_norm"] = (cfg.d_model,)
    out.update({f"shared/attn/{k}": v
                for k, v in L.attention_shapes(cfg).items()})
    out["shared/mlp_norm"] = (cfg.d_model,)
    out.update({f"shared/mlp/{k}": v
                for k, v in L.mlp_shapes(cfg).items()})
    out["final_norm"] = (cfg.d_model,)
    return out


def _shared_apply(shared, cfg: ModelConfig, x, positions):
    h = L.rms_norm(x, shared["attn_norm"], cfg.norm_eps)
    attn_out, kv = L.attention_block(shared["attn"], cfg, h, positions,
                                     causal=True)
    x = x + attn_out
    h = L.rms_norm(x, shared["mlp_norm"], cfg.norm_eps)
    return x + L.mlp_block(shared["mlp"], h, cfg.d_ff), kv


def forward(params, cfg: ModelConfig, tokens, features_only: bool = False):
    """Logits (B, S, vocab) float32 (or the final-norm features) and the
    aux loss 0.0."""
    x = L.embed(params["embed"], cfg, tokens)
    positions = L.positions(*tokens.shape, tokens.device)

    def super_body(c, s):
        for j in range(cfg.shared_attn_every):
            c, _ = mamba2.block_forward(
                L.index(params["mamba_blocks"], s, j), cfg, c)
        return _shared_apply(params["shared"], cfg, c, positions)[0]

    super_body = L.maybe_remat(super_body, cfg)
    for s in range(n_superblocks(cfg)):
        x = super_body(x, s)
    x = L.rms_norm(x, params["final_norm"], cfg.norm_eps)
    if features_only:
        return x, 0.0
    return L.unembed(params["embed"], cfg, x), 0.0


def make_cache(cfg: ModelConfig, batch: int, max_len: int,
               dtype=torch.bfloat16, device="cuda") -> HybridCache:
    return HybridCache.zeros(cfg, batch, max_len, dtype, device=device)


def prefill(params, cfg: ModelConfig, tokens, max_len: int,
            cache_dtype=torch.bfloat16):
    """(logits (B, S, vocab) float32, HybridCache of capacity max_len after
    the prompt).  Under a model axis the cache holds this rank's heads and
    channels as the blocks split them (`mamba2.block_forward`,
    `layers.kv_cache_shape`)."""
    x = L.embed(params["embed"], cfg, tokens)
    B, S = tokens.shape
    dev = tokens.device
    positions = L.positions(B, S, dev)
    shape = (n_superblocks(cfg),) + L.kv_cache_shape(
        params["shared"]["attn"], cfg, B, max_len)
    ks, vs = (torch.zeros(shape, dtype=cache_dtype, device=dev)
              for _ in range(2))
    convs, states = [], []
    k_every = cfg.shared_attn_every
    for s in range(n_superblocks(cfg)):
        for j in range(k_every):
            x, (conv, state) = mamba2.block_forward(
                L.index(params["mamba_blocks"], s, j), cfg, x)
            convs.append(conv.to(cache_dtype))
            states.append(state)
        x, (k, v) = _shared_apply(params["shared"], cfg, x, positions)
        L.write_prompt_kv(ks[s], k)
        L.write_prompt_kv(vs[s], v)
    x = L.rms_norm(x, params["final_norm"], cfg.norm_eps)
    logits = L.unembed(params["embed"], cfg, x)
    cache = HybridCache(torch.stack(convs), torch.stack(states), ks, vs,
                        torch.full((B,), S, dtype=torch.int32, device=dev))
    return logits, cache


def decode_step(params, cfg: ModelConfig, tokens, cache: HybridCache):
    """One token (B, 1) against `cache`: (logits (B, 1, vocab), the new
    cache; its k and v are the given ones, written in place)."""
    x = L.embed(params["embed"], cfg, tokens)
    shared = params["shared"]
    pos = cache.length
    k_every = cfg.shared_attn_every
    convs, states = [], []
    for s in range(n_superblocks(cfg)):
        for j in range(k_every):
            conv = cache.conv[s * k_every + j]
            x, (new_conv, new_state) = mamba2.block_decode(
                L.index(params["mamba_blocks"], s, j), cfg, x,
                conv.to(x.dtype), cache.state[s * k_every + j])
            convs.append(new_conv.to(conv.dtype))
            states.append(new_state)
        h = L.rms_norm(x, shared["attn_norm"], cfg.norm_eps)
        attn_out, _, _ = L.attention_decode(shared["attn"], cfg, h,
                                            cache.k[s], cache.v[s], pos)
        x = x + attn_out
        h = L.rms_norm(x, shared["mlp_norm"], cfg.norm_eps)
        x = x + L.mlp_block(shared["mlp"], h, cfg.d_ff)
    x = L.rms_norm(x, params["final_norm"], cfg.norm_eps)
    logits = L.unembed(params["embed"], cfg, x)
    return logits, HybridCache(conv=torch.stack(convs),
                               state=torch.stack(states), k=cache.k,
                               v=cache.v, length=cache.length + 1)
