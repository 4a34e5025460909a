"""Family-dispatched model API (port of `repro.models.api`: the ssm, hybrid
and dense families).

    init(seed, cfg, shape=None, device=)      -> params
    forward(params, cfg, batch)               -> (logits, aux_loss)
    forward_features(params, cfg, batch)      -> (features, aux_loss)
    prefill(params, cfg, batch, max_len)      -> (logits, cache)
    decode_step(params, cfg, tokens, cache)   -> (logits, cache)
    make_cache(cfg, batch_size, max_len)      -> cache

Batches are dicts with ``tokens`` (B, S).  The moe, encdec and vlm
families raise `NotImplementedError` naming ROADMAP A11; `loss_targets`
and the cross-entropies come with training.
"""
from __future__ import annotations

from typing import Optional

import torch

from repro_torch._device import resolve_device
from repro_torch.configs.base import ModelConfig, ShapeConfig
from repro_torch.models import mamba2, transformer, zamba2

_MODULES = {"ssm": mamba2, "hybrid": zamba2, "dense": transformer}


def _module(cfg: ModelConfig):
    if cfg.family not in _MODULES:
        raise NotImplementedError(
            f"family {cfg.family!r} ({cfg.name}) is not ported to "
            "repro_torch yet (ROADMAP A11)")
    return _MODULES[cfg.family]


def init(seed: int, cfg: ModelConfig, shape: Optional[ShapeConfig] = None,
         device="cuda"):
    """Random parameters on `device`, drawn from a `torch.Generator` there
    seeded with `seed`.  The numbers differ from the reference's
    `jax.random` ones (the tests carry the reference's parameters across
    with `repro_torch.interop`).  `shape` is unused by the ported
    families, as in the reference."""
    mod = _module(cfg)
    dev = resolve_device(device)
    return mod.init(torch.Generator(device=dev).manual_seed(seed), cfg)


def forward(params, cfg: ModelConfig, batch: dict):
    return _module(cfg).forward(params, cfg, batch["tokens"])


def forward_features(params, cfg: ModelConfig, batch: dict):
    """Forward up to (not including) the unembedding: (B, S, D) features
    and the aux loss."""
    return _module(cfg).forward(params, cfg, batch["tokens"],
                                features_only=True)


def prefill(params, cfg: ModelConfig, batch: dict, max_len: int,
            cache_dtype=torch.bfloat16):
    """The hybrid and dense caches hold max_len positions; the SSM cache
    has no length axis, so the ssm family ignores `max_len`, as in the
    reference."""
    return _module(cfg).prefill(params, cfg, batch["tokens"], max_len,
                                cache_dtype=cache_dtype)


def decode_step(params, cfg: ModelConfig, tokens, cache):
    return _module(cfg).decode_step(params, cfg, tokens, cache)


def make_cache(cfg: ModelConfig, batch: int, max_len: int,
               dtype=torch.bfloat16, device="cuda"):
    return _module(cfg).make_cache(cfg, batch, max_len, dtype, device=device)
