"""Step functions (port of `repro.launch.steps`).

    make_train_step(cfg, opt_cfg, rules=None) -> (params, opt_state, batch)
                                     -> (params, opt_state, metrics)
    make_eval_step(cfg, rules=None) -> (params, batch) -> mean CE
    make_prefill_step / make_decode_step: serving's

``rules=None`` is one device.  With `distributed.ShardingRules` over a
mesh of a process group (`launch.mesh.make_host_mesh(group=)`) the steps
are data-parallel, the reference's GSPMD step written out: each rank
takes its own rows of the global batch; its loss is weighted by its share
of the global mask count, so the gradients summed over the ranks
(`DataParallel.all_reduce_grads`, in float32) are the whole batch's; the
MoE's load-balancing statistics are averaged over the ranks inside the
forward (`process_group.reducing`); the optimizer is ZeRO-1
(`optim.zero1_update`: the opt state is this rank's shard, the norm and
the clip are the reduced gradient's, the new params gathered whole).
Tensor parallelism (a model axis above 1) waits for ROADMAP A9c.

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
from repro_torch.distributed import process_group
from repro_torch.models import api
from repro_torch.models import layers as L
from repro_torch.optim import AdamWConfig, adamw_update
from repro_torch.optim.adamw import AdamWState, zero1_update
from repro_torch.tree import tree_leaves, tree_map

AUX_LOSS_WEIGHT = 0.01


def loss_and_grads(params: dict, cfg: ModelConfig, batch: dict,
                   fused_loss: bool = True, ce_weight=1.0):
    """((loss, ce, aux), grads): the reference's training loss, ce +
    AUX_LOSS_WEIGHT * aux, and its gradient with respect to every leaf of
    `params` (a dict of the same tree).  fused_loss=True takes the CE
    chunk by chunk over the sequence (`api.chunked_cross_entropy`), so
    the (B, S, V) float32 logits are never whole in memory; False takes
    it from the full logits.  `ce_weight` scales the CE in the loss and
    in the returned ce (a data-parallel rank's share of the batch)."""
    labels, mask = api.loss_targets(cfg, batch)
    p = tree_map(lambda t: t.detach().requires_grad_(), params)
    if fused_loss:
        feats, aux = api.forward_features(p, cfg, batch)
        ce = api.chunked_cross_entropy(p, cfg, feats, labels, mask)
    else:
        logits, aux = api.forward(p, cfg, batch)
        ce = api.cross_entropy(logits, labels, mask)
    ce = ce * ce_weight
    aux = torch.as_tensor(aux, dtype=torch.float32, device=ce.device)
    loss = ce + AUX_LOSS_WEIGHT * aux
    leaves = tree_leaves(p)
    by_id = dict(zip(map(id, leaves), torch.autograd.grad(loss, leaves)))
    return ((loss.detach(), ce.detach(), aux.detach()),
            tree_map(lambda t: by_id[id(t)], p))


def _group_of(rules):
    """The process group a rules' mesh runs over; refuses what the port
    does not execute yet."""
    group = getattr(rules.mesh, "process_group", None)
    if group is None:
        raise ValueError("a data-parallel step needs a mesh over a process "
                         "group (launch.mesh.make_host_mesh(group=...))")
    if rules.tp_size > 1:
        raise NotImplementedError(
            f"model axis {rules.tp_size}: tensor/expert parallelism waits "
            "for ROADMAP A9c")
    return group


def zero1_specs(rules, params: dict) -> dict:
    """The ZeRO-1 spec of every param's master, mu and nu (one tree: the
    three have the params' shapes)."""
    return rules.opt_pspecs(AdamWState((), params, params, params)).master


def make_train_step(cfg: ModelConfig, opt_cfg: AdamWConfig,
                    rules=None, fused_loss: bool = True):
    """train_step(params, opt_state, batch) -> (params, opt_state,
    metrics {loss, ce, aux, grad_norm, lr, clip_scale}), the metrics as
    0-d float32 tensors on the device.  The new params are in the
    config's param dtype.  With `rules`: data-parallel over the rules'
    process group, `batch` this rank's rows and `opt_state` its ZeRO-1
    shards (`optim.zero1_init`); the metrics are the global batch's, the
    same on every rank."""
    if rules is not None:
        return _dp_train_step(cfg, opt_cfg, rules, fused_loss)

    def train_step(params, opt_state, batch):
        (loss, ce, aux), grads = loss_and_grads(params, cfg, batch,
                                                fused_loss)
        new_params, new_opt, om = adamw_update(
            grads, opt_state, opt_cfg, param_dtype=L.dtype_of(cfg))
        metrics = {"loss": loss, "ce": ce, "aux": aux, **om}
        return new_params, new_opt, metrics

    return train_step


def _dp_train_step(cfg, opt_cfg, rules, fused_loss):
    group, mesh = _group_of(rules), rules.mesh
    specs = {}

    def train_step(params, opt_state, batch):
        _, mask = api.loss_targets(cfg, batch)
        n_local = torch.sum(mask)
        share = n_local / group.sum(n_local)
        with process_group.reducing(group):
            (_, ce, aux), grads = loss_and_grads(params, cfg, batch,
                                                 fused_loss, ce_weight=share)
        grads = group.all_reduce_grads(grads)
        if "zero1" not in specs:
            specs["zero1"] = zero1_specs(rules, params)
        new_params, new_opt, om = zero1_update(
            grads, opt_state, opt_cfg, specs["zero1"], group, mesh,
            param_dtype=L.dtype_of(cfg))
        ce = group.sum(ce)
        metrics = {"loss": ce + AUX_LOSS_WEIGHT * aux, "ce": ce, "aux": aux,
                   **om}
        return new_params, new_opt, metrics

    return train_step


def make_eval_step(cfg: ModelConfig, rules=None):
    """eval_step(params, batch) -> the mean CE of the full logits, with
    no gradient recorded.  With `rules`: over the global batch, each rank
    taking its own rows."""
    group = None if rules is None else _group_of(rules)

    def eval_step(params, batch):
        labels, mask = api.loss_targets(cfg, batch)
        with torch.no_grad():
            logits, _ = api.forward(params, cfg, batch)
            ce = api.cross_entropy(logits, labels, mask)
            if group is None:
                return ce
            n = torch.sum(mask)
            total, count = group.sum(torch.stack([ce * n, n]))
            return total / torch.clamp(count, min=1.0)

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
