"""Family-dispatched model API (port of `repro.models.api`): all six
families.

    init(seed, cfg, shape=None, device=)           -> params
    forward(params, cfg, batch)                    -> (logits, aux_loss)
    forward_features(params, cfg, batch)           -> (features, aux_loss)
    loss_targets(cfg, batch)                       -> (labels, loss_mask)
    cross_entropy(logits, labels, mask[, first])   -> mean next-token CE
    chunked_cross_entropy(params, cfg, feats, labels, mask) -> the same,
                                                      a chunk at a time
    prefill(params, cfg, batch, max_len)           -> (logits, cache)
    decode_step(params, cfg, tokens, cache)        -> (logits, cache)
    make_cache(cfg, batch_size, max_len, enc_len)  -> cache
    param_specs(cfg, shape) / cache_specs(...) / input_specs(cfg, shape)
                                                   -> the same trees as
                                                      ``meta`` tensors

Batches are dicts in the reference's layouts (training batches carry
``labels`` too, `data.pipeline.make_batch`):
  dense/moe/ssm/hybrid: tokens (B, S), labels (B, S)
  vlm:    tokens (B, S - n_img), image_embeds (B, n_img, D), labels (B, S)
  encdec: frame_embeds (B, S, D), tokens (B, S/4), labels (B, S/4)
"""
from __future__ import annotations

from typing import Optional

import torch
from torch.utils.checkpoint import checkpoint

from repro_torch._device import resolve_device
from repro_torch.configs.base import ModelConfig, ShapeConfig
from repro_torch.distributed import process_group as pg
from repro_torch.models import layers as L
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
    return _init(gen, cfg, shape)


class _MetaGenerator(torch.Generator):
    """A generator whose `device` is ``meta``: every tensor `init` draws
    or fills there has a shape and a dtype and no data."""

    @property
    def device(self):
        return torch.device("meta")


def _init(gen: torch.Generator, cfg: ModelConfig,
          shape: Optional[ShapeConfig]):
    if cfg.family == "encdec":
        seq = shape.seq_len if shape is not None else cfg.max_source_positions
        return whisper.init(gen, cfg, max_enc=max(seq, 16),
                            max_dec=max(whisper.dec_seq_len(seq), 16))
    return _module(cfg).init(gen, cfg)


def param_specs(cfg: ModelConfig, shape: Optional[ShapeConfig] = None):
    """`init`'s tree as ``meta`` tensors: every parameter's shape and
    dtype without allocating (the reference's `jax.eval_shape` of its
    init), so the sharding rules can be held at full size."""
    return _init(_MetaGenerator(), cfg, shape)


def forward(params, cfg: ModelConfig, batch: dict):
    return _module(cfg).forward(params, cfg, *_inputs(cfg, batch))


def forward_features(params, cfg: ModelConfig, batch: dict):
    """Forward up to (not including) the unembedding: (B, S, D) features
    and the aux loss."""
    return _module(cfg).forward(params, cfg, *_inputs(cfg, batch),
                                features_only=True)


def loss_targets(cfg: ModelConfig, batch: dict):
    """(labels, loss mask float32): the vlm family's mask keeps only the
    text positions (`llava.text_loss_mask`), every other family's is all
    ones."""
    labels = batch["labels"]
    if cfg.family == "vlm":
        mask = llava.text_loss_mask(cfg, labels.shape[0], labels.shape[1],
                                    device=labels.device)
    else:
        mask = torch.ones(labels.shape, dtype=torch.float32,
                          device=labels.device)
    return labels, mask


def token_log_probs(logits, labels, first: Optional[int] = None):
    """log p(label) (B, S) from float32 logits (B, S, V): all of the
    vocabulary's, or, where `first` is given, this rank's block of it from
    `first` on (`layers.vocab_first`; the vocabulary split over the model
    axis).  Then the softmax is taken across the ranks, as GSPMD takes the
    reference's: the max over the model axis (detached, it cancels), the
    sum of exp and the label's shifted logit (zero on the ranks whose
    block does not hold it) summed by g."""
    if first is None:
        logp = torch.log_softmax(logits, dim=-1)
        return torch.gather(logp, -1, labels.long()[..., None])[..., 0]
    n = logits.shape[-1]
    shifted = logits - pg.max_over_model(torch.amax(logits, dim=-1))[..., None]
    t = labels.long() - first
    inside = (t >= 0) & (t < n)
    picked = torch.gather(shifted, -1, t.clamp(0, n - 1)[..., None])[..., 0]
    sums = pg.reduce_from_model(torch.stack(
        [torch.sum(torch.exp(shifted), dim=-1),
         torch.where(inside, picked, 0)]))
    return sums[1] - torch.log(sums[0])


def cross_entropy(logits, labels, mask, first: Optional[int] = None):
    """Next-token CE over (B, S, V) float32 logits (or a rank's block of
    the vocabulary's, from `first`: `token_log_probs`), averaged over the
    mask; labels are already aligned (labels[t] is position t's
    target)."""
    ll = token_log_probs(logits, labels, first)
    return -torch.sum(ll * mask) / torch.clamp(torch.sum(mask), min=1.0)


def _loss_chunk(cfg: ModelConfig, seq_len: int, max_chunk: int = 512) -> int:
    """The largest chunk of at most `max_chunk` positions dividing
    seq_len."""
    c = min(seq_len, max_chunk)
    while seq_len % c:
        c -= 1
    return c


def chunked_cross_entropy(params, cfg: ModelConfig, feats, labels, mask,
                          max_chunk: int = 512):
    """`cross_entropy` of the unembedded features, a sequence chunk at a
    time (`_loss_chunk`), so the (B, S, V) float32 logits are never whole
    in memory.  Each chunk's body runs under `torch.utils.checkpoint`, as
    the reference's under `jax.checkpoint`: the backward recomputes its
    logits and holds one chunk of them too.  With the vocabulary split
    over the model axis, each chunk's softmax is vocabulary-parallel
    (`token_log_probs`), the features entering the product through f."""
    B, S, D = feats.shape
    c = _loss_chunk(cfg, S, max_chunk)
    first = L.vocab_first(params["embed"], cfg)

    def body(f, lab, m):
        logits = L.unembed(params["embed"], cfg, f)
        return torch.sum(token_log_probs(logits, lab, first) * m)

    total = torch.zeros((), dtype=torch.float32, device=feats.device)
    for i in range(0, S, c):
        sl = slice(i, i + c)
        args = (feats[:, sl], labels[:, sl], mask[:, sl])
        part = (checkpoint(body, *args, use_reentrant=False)
                if torch.is_grad_enabled() else body(*args))
        total = total - part
    return total / torch.clamp(torch.sum(mask), min=1.0)


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


def cache_specs(cfg: ModelConfig, batch: int, max_len: int,
                enc_len: Optional[int] = None, dtype=torch.bfloat16):
    """`make_cache`'s tree as ``meta`` tensors (shapes and dtypes)."""
    return make_cache(cfg, batch, max_len, enc_len, dtype, device="meta")


def input_specs(cfg: ModelConfig, shape: ShapeConfig) -> dict:
    """The batch of `shape` as ``meta`` tensors, in the family's layout:
    a train batch carries labels; prefill the prompt; decode one new
    token (B, 1) against a cache of capacity seq_len."""
    B, S = shape.global_batch, shape.seq_len
    i32, act, D = torch.int32, L.act_dtype_of(cfg), cfg.d_model

    def spec(dims, dtype=i32):
        return torch.empty(dims, dtype=dtype, device="meta")

    if shape.kind == "decode":
        return {"tokens": spec((B, 1))}
    if cfg.family == "vlm":
        n_img = cfg.num_image_tokens
        out = {"tokens": spec((B, S - n_img)),
               "image_embeds": spec((B, n_img, D), act)}
        labels = (B, S)
    elif cfg.family == "encdec":
        Sd = whisper.dec_seq_len(S)
        out = {"frame_embeds": spec((B, S, D), act), "tokens": spec((B, Sd))}
        labels = (B, Sd)
    else:
        out = {"tokens": spec((B, S))}
        labels = (B, S)
    if shape.kind == "train":
        out["labels"] = spec(labels)
    return out
