"""Building blocks the ported models share (port of `repro.models.layers`,
the parts Mamba2 uses): dtypes, the dense initialiser, RMSNorm and the
token embedding with its (tied) unembedding.

Parameters are plain dicts of tensors, as the reference's are pytrees.
Random init draws from an explicit `torch.Generator`: the numbers differ
from `jax.random`'s, so the tests carry the reference's parameters across
(`repro_torch.interop.mamba2_params_from_numpy`).
"""
from __future__ import annotations

import math

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


def dense_init(gen: torch.Generator, in_dim: int, out_dim: int, dtype):
    """An (in_dim, out_dim) weight with stddev 1 / sqrt(in_dim)."""
    return normal(gen, (in_dim, out_dim), dtype, 1.0 / math.sqrt(in_dim))


def rms_norm(x: torch.Tensor, w: torch.Tensor, eps: float) -> torch.Tensor:
    """RMSNorm over the last axis, in float32, cast back to x's dtype."""
    xf = x.float()
    var = torch.mean(xf * xf, dim=-1, keepdim=True)
    y = xf * torch.rsqrt(var + eps)
    return (y * w.float()).to(x.dtype)


def init_embed(gen: torch.Generator, cfg: ModelConfig) -> dict:
    p = {"embedding": normal(gen, (cfg.vocab_size, cfg.d_model),
                             dtype_of(cfg), 0.02)}
    if not cfg.tie_embeddings:
        p["lm_head"] = dense_init(gen, cfg.d_model, cfg.vocab_size,
                                  dtype_of(cfg))
    return p


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
