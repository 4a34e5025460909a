"""Family-dispatched model API (port of `repro.models.api`): all six
families.

    init(seed, cfg, shape=None, device=)           -> params
    forward(params, cfg, batch)                    -> (logits, aux_loss)
    forward_features(params, cfg, batch)           -> (features, aux_loss)
    prefill(params, cfg, batch, max_len)           -> (logits, cache)
    decode_step(params, cfg, tokens, cache)        -> (logits, cache)
    make_cache(cfg, batch_size, max_len, enc_len)  -> cache

Batches are dicts in the reference's layouts:
  dense/moe/ssm/hybrid: tokens (B, S)
  vlm:    tokens (B, S - n_img), image_embeds (B, n_img, D)
  encdec: frame_embeds (B, S, D), tokens (B, S/4)
`loss_targets` and the cross-entropies come with training (ROADMAP A11).
"""
from __future__ import annotations

from typing import Optional

import torch

from repro_torch._device import resolve_device
from repro_torch.configs.base import ModelConfig, ShapeConfig
from repro_torch.models import llava, mamba2, transformer, whisper, zamba2

_MODULES = {"dense": transformer, "moe": transformer, "ssm": mamba2,
            "hybrid": zamba2, "encdec": whisper, "vlm": llava}


def _module(cfg: ModelConfig):
    return _MODULES[cfg.family]


def _inputs(cfg: ModelConfig, batch: dict) -> tuple:
    """The family's model inputs out of a batch, in its functions' order."""
    if cfg.family == "vlm":
        return batch["tokens"], batch["image_embeds"]
    if cfg.family == "encdec":
        return batch["frame_embeds"], batch["tokens"]
    return (batch["tokens"],)


def init(seed: int, cfg: ModelConfig, shape: Optional[ShapeConfig] = None,
         device="cuda"):
    """Random parameters on `device`, drawn from a `torch.Generator` there
    seeded with `seed`.  The numbers differ from the reference's
    `jax.random` ones (the tests carry the reference's parameters across
    with `repro_torch.interop`).  As in the reference, only the encdec
    family reads `shape`: its position tables hold shape.seq_len encoder
    and seq_len // 4 decoder positions (at least 16 each;
    `cfg.max_source_positions` when no shape is given)."""
    gen = torch.Generator(device=resolve_device(device)).manual_seed(seed)
    if cfg.family == "encdec":
        seq = shape.seq_len if shape is not None else cfg.max_source_positions
        return whisper.init(gen, cfg, max_enc=max(seq, 16),
                            max_dec=max(whisper.dec_seq_len(seq), 16))
    return _module(cfg).init(gen, cfg)


def forward(params, cfg: ModelConfig, batch: dict):
    return _module(cfg).forward(params, cfg, *_inputs(cfg, batch))


def forward_features(params, cfg: ModelConfig, batch: dict):
    """Forward up to (not including) the unembedding: (B, S, D) features
    and the aux loss."""
    return _module(cfg).forward(params, cfg, *_inputs(cfg, batch),
                                features_only=True)


def prefill(params, cfg: ModelConfig, batch: dict, max_len: int,
            cache_dtype=torch.bfloat16):
    """The attention caches hold max_len positions (whisper's decoder
    self-attention; llava's counts the image's); the SSM cache has no
    length axis, so the ssm family ignores `max_len`, as in the
    reference."""
    return _module(cfg).prefill(params, cfg, *_inputs(cfg, batch), max_len,
                                cache_dtype=cache_dtype)


def decode_step(params, cfg: ModelConfig, tokens, cache):
    return _module(cfg).decode_step(params, cfg, tokens, cache)


def make_cache(cfg: ModelConfig, batch: int, max_len: int,
               enc_len: Optional[int] = None, dtype=torch.bfloat16,
               device="cuda"):
    """An empty cache; the encdec family's holds enc_len (default max_len)
    encoder positions of cross-attention k and v."""
    if cfg.family == "encdec":
        return whisper.make_cache(cfg, batch, max_len, enc_len or max_len,
                                  dtype, device=device)
    return _module(cfg).make_cache(cfg, batch, max_len, dtype, device=device)
