"""Serving step functions (port of the serving half of
`repro.launch.steps`), single device: the reference's ``rules=None``
case, with no sharding constraints.  Every family goes through them, its
batch in `models.api`'s layout (the vlm and encdec batches carry their
stub embeddings beside the tokens); the train and eval steps come with
training (ROADMAP A11)."""
from __future__ import annotations

import torch

from repro_torch.configs.base import ModelConfig
from repro_torch.models import api


def make_prefill_step(cfg: ModelConfig, max_len: int):
    """prefill_step(params, batch) -> (next token (B, 1) int32, cache): the
    argmax of the last position's logits."""

    def prefill_step(params, batch):
        logits, cache = api.prefill(params, cfg, batch, max_len)
        next_tok = torch.argmax(logits[:, -1:], dim=-1).to(torch.int32)
        return next_tok, cache

    return prefill_step


def make_decode_step(cfg: ModelConfig):
    """decode_step(params, tokens (B, 1), cache) -> (next token, cache)."""

    def decode_step(params, tokens, cache):
        logits, cache = api.decode_step(params, cfg, tokens, cache)
        next_tok = torch.argmax(logits, dim=-1).to(torch.int32)
        return next_tok, cache

    return decode_step
