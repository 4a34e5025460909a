"""Batched generation engine (port of `repro.serving.engine`).

Greedy (argmax) generation over a fixed-capacity batch: requests are padded
to a common prompt grid, prefilled once, then decoded step by step with
the family's cache.  Per-sequence EOS and length bookkeeping happen on the
host; the device work is the two step functions of `launch.steps`, shared
by all requests.

Left padding: shorter prompts are left-padded so every sequence's last
prompt token sits at the same position, as in the reference.

With `rules` (`distributed.ShardingRules` over a mesh of a process
group) there is one engine a rank, every rank given the same requests:
the steps take the global batch and return the global next tokens
(`launch.steps`), chosen alike on every rank (the argmax of logits made
whole over the vocabulary), so every rank's outputs are the same.
"""
from __future__ import annotations

import dataclasses
from typing import List, Optional, Sequence

import numpy as np
import torch

from repro_torch._device import resolve_device
from repro_torch.configs.base import ModelConfig
from repro_torch.launch.steps import make_decode_step, make_prefill_step


@dataclasses.dataclass
class Request:
    prompt: np.ndarray                 # (len,) int32
    max_new_tokens: int = 16
    eos_id: Optional[int] = None
    # filled by the engine:
    output: Optional[np.ndarray] = None


class GenerationEngine:
    """`params` must lie on `device` (default the card, which raises
    without one; the CPU runs when asked for): with `rules`, this rank's
    shards of them (`distributed.sharding.shard_of` under the rules'
    specs) on its device."""

    def __init__(self, params, cfg: ModelConfig, max_len: int,
                 batch_size: int, device="cuda", rules=None):
        self.device = resolve_device(device)
        self.params = params
        self.cfg = cfg
        self.max_len = max_len
        self.batch_size = batch_size
        self._prefill = make_prefill_step(cfg, max_len, rules)
        self._decode = make_decode_step(cfg, rules)

    def _make_batch(self, requests: Sequence[Request]):
        B = self.batch_size
        if len(requests) > B:
            raise ValueError(f"{len(requests)} requests > capacity {B}")
        plen = max(r.prompt.shape[0] for r in requests)
        toks = np.zeros((B, plen), np.int32)
        for i, r in enumerate(requests):
            toks[i, plen - r.prompt.shape[0]:] = r.prompt  # left pad
        return torch.as_tensor(toks, device=self.device)

    def generate(self, requests: List[Request]) -> List[Request]:
        """Run all requests to completion (greedy)."""
        toks = self._make_batch(requests)
        next_tok, cache = self._prefill(self.params, {"tokens": toks})
        max_new = max(r.max_new_tokens for r in requests)
        outs = [next_tok]
        for _ in range(max_new - 1):
            next_tok, cache = self._decode(self.params, next_tok, cache)
            outs.append(next_tok)
        gen = torch.cat(outs, dim=1).cpu().numpy()
        for i, r in enumerate(requests):
            seq = gen[i, :r.max_new_tokens]
            if r.eos_id is not None:
                hits = np.nonzero(seq == r.eos_id)[0]
                if hits.size:
                    seq = seq[:hits[0] + 1]
            r.output = seq
        return requests
