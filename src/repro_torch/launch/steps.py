"""Step functions (port of `repro.launch.steps`), single device: the
reference's ``rules=None`` case, with no sharding constraints.

    make_train_step(cfg, opt_cfg) -> (params, opt_state, batch)
                                     -> (params, opt_state, metrics)
    make_eval_step(cfg)           -> (params, batch) -> mean CE
    make_prefill_step / make_decode_step: serving's

Every family goes through them, its batch in `models.api`'s layout (the
vlm and encdec batches carry their stub embeddings beside the tokens).
The params stay a plain dict of tensors: a train step takes the
gradients with `torch.autograd.grad` over its leaves (`loss_and_grads`)
and hands them to the functional `optim.adamw_update`, which returns new
params, as the reference's pure step does.
"""
from __future__ import annotations

import torch

from repro_torch.configs.base import ModelConfig
from repro_torch.models import api
from repro_torch.models import layers as L
from repro_torch.optim import AdamWConfig, adamw_update
from repro_torch.optim.adamw import tree_leaves, tree_map

AUX_LOSS_WEIGHT = 0.01


def loss_and_grads(params: dict, cfg: ModelConfig, batch: dict,
                   fused_loss: bool = True):
    """((loss, ce, aux), grads): the reference's training loss, ce +
    AUX_LOSS_WEIGHT * aux, and its gradient with respect to every leaf of
    `params` (a dict of the same tree).  fused_loss=True takes the CE
    chunk by chunk over the sequence (`api.chunked_cross_entropy`), so
    the (B, S, V) float32 logits are never whole in memory; False takes
    it from the full logits."""
    labels, mask = api.loss_targets(cfg, batch)
    p = tree_map(lambda t: t.detach().requires_grad_(), params)
    if fused_loss:
        feats, aux = api.forward_features(p, cfg, batch)
        ce = api.chunked_cross_entropy(p, cfg, feats, labels, mask)
    else:
        logits, aux = api.forward(p, cfg, batch)
        ce = api.cross_entropy(logits, labels, mask)
    aux = torch.as_tensor(aux, dtype=torch.float32, device=ce.device)
    loss = ce + AUX_LOSS_WEIGHT * aux
    leaves = tree_leaves(p)
    by_id = dict(zip(map(id, leaves), torch.autograd.grad(loss, leaves)))
    return ((loss.detach(), ce.detach(), aux.detach()),
            tree_map(lambda t: by_id[id(t)], p))


def make_train_step(cfg: ModelConfig, opt_cfg: AdamWConfig,
                    fused_loss: bool = True):
    """train_step(params, opt_state, batch) -> (params, opt_state,
    metrics {loss, ce, aux, grad_norm, lr, clip_scale}), the metrics as
    0-d float32 tensors on the device.  The new params are in the
    config's param dtype."""

    def train_step(params, opt_state, batch):
        (loss, ce, aux), grads = loss_and_grads(params, cfg, batch,
                                                fused_loss)
        new_params, new_opt, om = adamw_update(
            grads, opt_state, opt_cfg, param_dtype=L.dtype_of(cfg))
        metrics = {"loss": loss, "ce": ce, "aux": aux, **om}
        return new_params, new_opt, metrics

    return train_step


def make_eval_step(cfg: ModelConfig):
    """eval_step(params, batch) -> the mean CE of the full logits, with
    no gradient recorded."""

    def eval_step(params, batch):
        labels, mask = api.loss_targets(cfg, batch)
        with torch.no_grad():
            logits, _ = api.forward(params, cfg, batch)
            return api.cross_entropy(logits, labels, mask)

    return eval_step


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
