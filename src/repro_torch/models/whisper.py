"""Whisper-style encoder-decoder backbone, the encdec family (port of
`repro.models.whisper`).

The conv frontend is a stub, as in the reference: the batch carries
precomputed frame embeddings (B, S_enc, D).  The backbone is whisper's:
pre-LN transformer blocks with LayerNorm (+ bias), GELU MLPs, MHA, learned
positions; the encoder's attention has no mask and no RoPE, the decoder's
self-attention is causal with RoPE (as the reference's), and each decoder
block cross-attends to the encoder's output.  The reference's layer scans
are Python loops over the stacked layers.

Decode writes the self-attention cache in place; the cross-attention k
and v are computed once, at prefill, and kept in the cache.
"""
from __future__ import annotations

from typing import NamedTuple

import torch

from repro_torch._device import resolve_device
from repro_torch.configs.base import ModelConfig
from repro_torch.models import layers as L


def dec_seq_len(seq_len: int) -> int:
    """The shape convention: decoder length = seq_len // 4."""
    return max(seq_len // 4, 1)


def _init_ln(cfg: ModelConfig, dev) -> dict:
    dt = L.dtype_of(cfg)
    return {"w": torch.ones((cfg.d_model,), dtype=dt, device=dev),
            "b": torch.zeros((cfg.d_model,), dtype=dt, device=dev)}


def init_enc_block(gen: torch.Generator, cfg: ModelConfig) -> dict:
    return {
        "attn_norm": _init_ln(cfg, gen.device),
        "attn": L.init_attention(gen, cfg),
        "mlp_norm": _init_ln(cfg, gen.device),
        "mlp": L.init_mlp_gelu(gen, cfg),
    }


def init_dec_block(gen: torch.Generator, cfg: ModelConfig) -> dict:
    return {
        "self_norm": _init_ln(cfg, gen.device),
        "self_attn": L.init_attention(gen, cfg),
        "cross_norm": _init_ln(cfg, gen.device),
        "cross_attn": L.init_attention(gen, cfg),
        "mlp_norm": _init_ln(cfg, gen.device),
        "mlp": L.init_mlp_gelu(gen, cfg),
    }


def init(gen: torch.Generator, cfg: ModelConfig, max_enc: int = 0,
         max_dec: int = 0) -> dict:
    """Random parameters on the generator's device: position tables of
    max_enc (default `cfg.max_source_positions`) and max_dec (default
    max_enc) rows; block leaves stacked over layers."""
    dt, dev = L.dtype_of(cfg), gen.device
    max_enc = max_enc or cfg.max_source_positions
    return {
        "embed": L.init_embed(gen, cfg),
        "enc_pos": L.normal(gen, (max_enc, cfg.d_model), dt, 0.02),
        "dec_pos": L.normal(gen, (max_dec or max_enc, cfg.d_model), dt,
                            0.02),
        "enc_blocks": L.stacked(cfg.num_layers,
                                lambda: init_enc_block(gen, cfg)),
        "dec_blocks": L.stacked(cfg.num_decoder_layers,
                                lambda: init_dec_block(gen, cfg)),
        "enc_final_norm": _init_ln(cfg, dev),
        "dec_final_norm": _init_ln(cfg, dev),
    }


def param_shapes(cfg: ModelConfig, max_enc: int, max_dec: int) -> dict:
    """Every parameter's shape, keyed by its path in `init`'s tree."""
    D = (cfg.d_model,)
    ln = {"w": D, "b": D}
    attn = L.attention_shapes(cfg)
    mlp = L.mlp_gelu_shapes(cfg)
    enc = {"attn_norm": ln, "attn": attn, "mlp_norm": ln, "mlp": mlp}
    dec = {"self_norm": ln, "self_attn": attn, "cross_norm": ln,
           "cross_attn": attn, "mlp_norm": ln, "mlp": mlp}
    out = L.embed_shapes(cfg)
    out["enc_pos"] = (max_enc, cfg.d_model)
    out["dec_pos"] = (max_dec, cfg.d_model)
    for name, tree, n in (("enc_blocks", enc, cfg.num_layers),
                          ("dec_blocks", dec, cfg.num_decoder_layers)):
        out.update({f"{name}/{k}/{j}": (n,) + s
                    for k, sub in tree.items() for j, s in sub.items()})
    for name in ("enc_final_norm", "dec_final_norm"):
        out.update({f"{name}/{j}": s for j, s in ln.items()})
    return out


def _ln(x, p, eps):
    return L.layer_norm(x, p["w"], p["b"], eps)


def encode(params, cfg: ModelConfig, frame_embeds):
    """frame_embeds: (B, S_enc, D) from the stubbed conv frontend ->
    the encoder's output (B, S_enc, D)."""
    S = frame_embeds.shape[1]
    x = frame_embeds.to(L.act_dtype_of(cfg)) + params["enc_pos"][:S]

    def body(c, i):
        bp = L.index(params["enc_blocks"], i)
        h = _ln(c, bp["attn_norm"], cfg.norm_eps)
        attn_out, _ = L.attention_block(bp["attn"], cfg, h, None,
                                        causal=False)
        c = c + attn_out
        h = _ln(c, bp["mlp_norm"], cfg.norm_eps)
        return c + L.mlp_gelu_block(bp["mlp"], h, cfg.d_ff)

    body = L.maybe_remat(body, cfg)
    for i in range(cfg.num_layers):
        x = body(x, i)
    return _ln(x, params["enc_final_norm"], cfg.norm_eps)


def _dec_block(cfg: ModelConfig, bp: dict, x, positions, enc_kv):
    """One teacher-forced decoder block: (output, its self-attention's
    (k, v))."""
    h = _ln(x, bp["self_norm"], cfg.norm_eps)
    self_out, kv = L.attention_block(bp["self_attn"], cfg, h, positions,
                                     causal=True)
    x = x + self_out
    h = _ln(x, bp["cross_norm"], cfg.norm_eps)
    x = x + L.cross_attention_block(bp["cross_attn"], cfg, h, enc_kv)
    h = _ln(x, bp["mlp_norm"], cfg.norm_eps)
    return x + L.mlp_gelu_block(bp["mlp"], h, cfg.d_ff), kv


def _dec_embed(params, cfg: ModelConfig, tokens):
    return L.embed(params["embed"], cfg, tokens) \
        + params["dec_pos"][:tokens.shape[1]]


def decode_train(params, cfg: ModelConfig, tokens, enc_out,
                 features_only: bool = False):
    """Teacher-forced decoder pass: (B, S_dec, V) float32 logits, or the
    final features when `features_only`."""
    x = _dec_embed(params, cfg, tokens)
    positions = L.positions(*tokens.shape, tokens.device)

    def body(c, i):
        bp = L.index(params["dec_blocks"], i)
        enc_kv = L.encoder_kv(bp["cross_attn"], cfg, enc_out)
        return _dec_block(cfg, bp, c, positions, enc_kv)[0]

    body = L.maybe_remat(body, cfg)
    for i in range(cfg.num_decoder_layers):
        x = body(x, i)
    x = _ln(x, params["dec_final_norm"], cfg.norm_eps)
    if features_only:
        return x
    return L.unembed(params["embed"], cfg, x)


def forward(params, cfg: ModelConfig, frame_embeds, tokens,
            features_only: bool = False):
    """(logits (B, S_dec, V) float32 or the features, aux loss 0.0)."""
    enc_out = encode(params, cfg, frame_embeds)
    return decode_train(params, cfg, tokens, enc_out,
                        features_only=features_only), 0.0


class EncDecCache(NamedTuple):
    """Self-attention KV cache and the cross-attention k, v of every
    decoder layer.  Decode writes k and v in place."""

    k: torch.Tensor        # (Ld, B, Smax, Hkv, hd) self-attention
    v: torch.Tensor
    cross_k: torch.Tensor  # (Ld, B, S_enc, Hkv, hd)
    cross_v: torch.Tensor
    length: torch.Tensor   # (B,) int32

    @classmethod
    def zeros(cls, cfg: ModelConfig, batch: int, max_len: int, enc_len: int,
              dtype=torch.bfloat16, device="cuda"):
        dev = resolve_device(device)
        Ld = cfg.num_decoder_layers
        kv = (Ld, batch, max_len, cfg.num_kv_heads, cfg.hd())
        ckv = (Ld, batch, enc_len, cfg.num_kv_heads, cfg.hd())
        return cls(*(torch.zeros(s, dtype=dtype, device=dev)
                     for s in (kv, kv, ckv, ckv)),
                   torch.zeros((batch,), dtype=torch.int32, device=dev))


def make_cache(cfg: ModelConfig, batch: int, max_len: int, enc_len: int,
               dtype=torch.bfloat16, device="cuda") -> EncDecCache:
    return EncDecCache.zeros(cfg, batch, max_len, enc_len, dtype,
                             device=device)


def prefill(params, cfg: ModelConfig, frame_embeds, tokens, max_len: int,
            cache_dtype=torch.bfloat16):
    """Encode, then the teacher-forced decoder over the prompt: (logits
    (B, S_dec, V) float32, EncDecCache of capacity max_len holding the
    prompt's k and v and every layer's cross-attention k and v)."""
    enc_out = encode(params, cfg, frame_embeds)
    B, S = tokens.shape
    x = _dec_embed(params, cfg, tokens)
    positions = L.positions(B, S, tokens.device)
    shape = (cfg.num_decoder_layers,) + L.kv_cache_shape(
        params["dec_blocks"]["self_attn"], cfg, B, max_len)
    ks, vs = (torch.zeros(shape, dtype=cache_dtype, device=tokens.device)
              for _ in range(2))
    cks, cvs = [], []
    for i in range(cfg.num_decoder_layers):
        bp = L.index(params["dec_blocks"], i)
        ck, cv = L.encoder_kv(bp["cross_attn"], cfg, enc_out)
        x, (k, v) = _dec_block(cfg, bp, x, positions, (ck, cv))
        L.write_prompt_kv(ks[i], k)
        L.write_prompt_kv(vs[i], v)
        cks.append(ck.to(cache_dtype))
        cvs.append(cv.to(cache_dtype))
    x = _ln(x, params["dec_final_norm"], cfg.norm_eps)
    logits = L.unembed(params["embed"], cfg, x)
    cache = EncDecCache(ks, vs, torch.stack(cks), torch.stack(cvs),
                        torch.full((B,), S, dtype=torch.int32,
                                   device=tokens.device))
    return logits, cache


def decode_step(params, cfg: ModelConfig, tokens, cache: EncDecCache):
    """One token (B, 1) against `cache`: (logits (B, 1, V), the cache with
    k and v written in place and length + 1)."""
    pos = cache.length
    x = L.embed(params["embed"], cfg, tokens) \
        + params["dec_pos"][pos.long()][:, None, :]
    for i in range(cfg.num_decoder_layers):
        bp = L.index(params["dec_blocks"], i)
        h = _ln(x, bp["self_norm"], cfg.norm_eps)
        self_out, _, _ = L.attention_decode(bp["self_attn"], cfg, h,
                                            cache.k[i], cache.v[i], pos)
        x = x + self_out
        h = _ln(x, bp["cross_norm"], cfg.norm_eps)
        x = x + L.cross_attention_block(
            bp["cross_attn"], cfg, h,
            (cache.cross_k[i].to(x.dtype), cache.cross_v[i].to(x.dtype)))
        h = _ln(x, bp["mlp_norm"], cfg.norm_eps)
        x = x + L.mlp_gelu_block(bp["mlp"], h, cfg.d_ff)
    x = _ln(x, params["dec_final_norm"], cfg.norm_eps)
    logits = L.unembed(params["embed"], cfg, x)
    return logits, cache._replace(length=cache.length + 1)
