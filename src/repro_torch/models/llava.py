"""LLaVA-NeXT (anyres) style VLM on a Mistral-7B backbone, the vlm family
(port of `repro.models.llava`).

The vision tower and projector are a stub, as in the reference: the batch
carries precomputed anyres patch embeddings (B, num_image_tokens, D),
5 tiles x 576 patches = 2880 positions for llava-next-mistral-7b.  They
are put before the text tokens' embeddings ([image; text]), where the
projector's output is spliced in, and the dense transformer runs on the
whole sequence.  Decode is text only: the transformer's.
"""
from __future__ import annotations

import torch

from repro_torch._device import resolve_device
from repro_torch.configs.base import ModelConfig
from repro_torch.models import layers as L
from repro_torch.models import transformer

# the backbone's parameters and cache (the vision tower is stubbed)
init = transformer.init
make_cache = transformer.make_cache
decode_step = transformer.decode_step


def splice_embeddings(params, cfg: ModelConfig, tokens, image_embeds):
    """[image; text] -> (B, S_img + S_text, D) input embeddings."""
    tok_embeds = L.embed(params["embed"], cfg, tokens)
    return torch.cat([image_embeds.to(tok_embeds.dtype), tok_embeds], dim=1)


def forward(params, cfg: ModelConfig, tokens, image_embeds,
            features_only: bool = False):
    """tokens: (B, S_text); image_embeds: (B, S_img, D)."""
    x = splice_embeddings(params, cfg, tokens, image_embeds)
    return transformer.forward(params, cfg, None, inputs_embeds=x,
                               features_only=features_only)


def prefill(params, cfg: ModelConfig, tokens, image_embeds, max_len: int,
            cache_dtype=torch.bfloat16):
    x = splice_embeddings(params, cfg, tokens, image_embeds)
    return transformer.prefill(params, cfg, None, max_len, inputs_embeds=x,
                               cache_dtype=cache_dtype)


def text_loss_mask(cfg: ModelConfig, batch: int, total_len: int,
                   device="cuda") -> torch.Tensor:
    """Loss mask (batch, total_len) float32: next-token loss only on the
    text positions (after the image's)."""
    pos = torch.arange(total_len, device=resolve_device(device))
    mask = (pos >= cfg.num_image_tokens).float()
    return mask.expand(batch, total_len)
