"""Step functions (port of `repro.launch.steps`).

    make_train_step(cfg, opt_cfg, rules=None) -> (params, opt_state, batch)
                                     -> (params, opt_state, metrics)
    make_eval_step(cfg, rules=None) -> (params, batch) -> mean CE
    make_prefill_step / make_decode_step: serving's

``rules=None`` is one device.  With `distributed.ShardingRules` over a
mesh of a process group (`launch.mesh.make_host_mesh(group=)`) the steps
are the reference's GSPMD step written out over the (data, model) mesh:
  * data: each rank takes the rows of its data coordinate; its loss is
    weighted by its share of the global mask count, so the gradients
    summed over the data axis (`DataParallel.all_reduce_grads`, float32)
    are the whole batch's; the MoE's load-balancing statistics are
    averaged over the data axis inside the forward
    (`process_group.reducing`); the optimizer is ZeRO-1 over the data
    axis (`optim.zero1_update`: the opt state is this rank's shard, the
    new params gathered over the data axis);
  * model: each rank holds `shard_of` every param under the rules' specs
    (the model's blocks run the Megatron collectives of their split
    leaves, `process_group.model_parallel`); the whole leaves that a
    rank uses on its own block only (`ShardingRules.model_partial`) have
    their gradients summed over the model axis too; the norm counts the
    split leaves' squares summed over the model axis and the whole ones
    once, so the clip is one process's.
FSDP and SP are refused, and so are rules in the serving steps.

Every family goes through them, its batch in `models.api`'s layout (the
vlm and encdec batches carry their stub embeddings beside the tokens).
The params stay a plain dict of tensors: a train step takes the
gradients with `torch.autograd.grad` over its leaves (`loss_and_grads`)
and hands them to the functional `optim.adamw_update`, which returns new
params, as the reference's pure step does.
"""
from __future__ import annotations

from types import SimpleNamespace

import torch

from repro_torch.configs.base import ModelConfig
from repro_torch.distributed import process_group
from repro_torch.distributed.sharding import whole_shape, without_axis
from repro_torch.models import api
from repro_torch.models import layers as L
from repro_torch.optim import AdamWConfig, adamw_update
from repro_torch.optim.adamw import AdamWState, global_norm, zero1_update
from repro_torch.tree import map_named, named_leaves, tree_leaves, tree_map

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


def _axis_groups(rules):
    """(data group, model group) of this rank on the rules' mesh (a mesh
    over a process group); refuses what the port does not execute."""
    mesh = rules.mesh
    if getattr(mesh, "process_group", None) is None:
        raise ValueError("a sharded step needs a mesh over a process group "
                         "(launch.mesh.make_host_mesh(group=...))")
    if rules.fsdp:
        raise NotImplementedError("fsdp: the port executes the data, model "
                                  "and expert axes; FSDP is rules only")
    if rules.sp:
        raise NotImplementedError("sp: the port executes the data, model "
                                  "and expert axes; SP is rules only")
    if len(rules.dp) != 1:
        raise NotImplementedError(f"data axes {rules.dp}: the port's "
                                  "meshes have one")
    return mesh.axis_groups[rules.dp[0]], mesh.axis_groups[rules.tp_axis]


def zero1_specs(rules, params: dict) -> dict:
    """The ZeRO-1 spec of every param's master, mu and nu (one tree: the
    three have the params' shapes; `params` whole-shaped)."""
    return rules.opt_pspecs(AdamWState((), params, params, params)).master


def param_layout(cfg: ModelConfig, rules, params: dict) -> dict:
    """What a rank's step needs to know of where its `params` (its
    `shard_of` each under the rules' specs) sit: ``split`` and
    ``partial`` (trees of bools: the leaf is split over the model axis;
    its gradient is a part to sum over it, `ShardingRules.model_partial`)
    and, for ZeRO-1 over the data axis alone, ``local_zero1`` (the ZeRO-1
    specs with the model axis taken out: the slices of this rank's
    leaves) and ``data_mesh`` (one line of the mesh along the data axis).
    The specs come from the config's whole shapes (`api.param_specs`, on
    ``meta``): a shard's shape alone cannot say whether its dimension was
    split."""
    mesh, tp = rules.mesh, rules.tp_axis
    specs = rules.param_pspecs(api.param_specs(cfg))
    whole = tree_map(lambda p, s: torch.empty(
        whole_shape(p.shape, s, mesh), dtype=p.dtype, device="meta"),
        params, specs)
    return {"split": tree_map(lambda s: rules.tp_size > 1
                              and without_axis(s, tp) != tuple(s), specs),
            "partial": rules.model_partial(whole),
            "local_zero1": tree_map(lambda s: without_axis(s, tp),
                                    zero1_specs(rules, whole)),
            "data_mesh": SimpleNamespace(shape={
                a: (n if a in rules.dp else 1)
                for a, n in mesh.shape.items()})}


def _sum_grads(grads, partial, data, model):
    """The gradients summed over the data axis (float32), and the leaves
    marked `partial` also over the model axis."""
    grads = data.all_reduce_grads(grads)
    parts = {n: g for (n, g), (_, p) in zip(named_leaves(grads),
                                           named_leaves(partial)) if p}
    if model.world == 1 or not parts:
        return grads
    parts = model.all_reduce_grads(parts)
    return map_named(lambda n, g: parts.get(n, g), grads)


def make_train_step(cfg: ModelConfig, opt_cfg: AdamWConfig,
                    rules=None, fused_loss: bool = True):
    """train_step(params, opt_state, batch) -> (params, opt_state,
    metrics {loss, ce, aux, grad_norm, lr, clip_scale}), the metrics as
    0-d float32 tensors on the device.  The new params are in the
    config's param dtype.  With `rules`: over the rules' mesh of a
    process group, `params` this rank's `shard_of` each (and so are the
    new params), `batch` the rows of its data coordinate and `opt_state`
    its ZeRO-1 shards (`optim.zero1_init` of the whole params); the
    metrics are the global batch's, the same on every rank."""
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
    data, model = _axis_groups(rules)
    layout = {}

    def train_step(params, opt_state, batch):
        if not layout:
            layout.update(param_layout(cfg, rules, params))
        _, mask = api.loss_targets(cfg, batch)
        n_local = torch.sum(mask)
        share = n_local / data.sum(n_local)
        with process_group.reducing(data), \
                process_group.model_parallel(model):
            (_, ce, aux), grads = loss_and_grads(params, cfg, batch,
                                                 fused_loss, ce_weight=share)
        grads = _sum_grads(grads, layout["partial"], data, model)
        gnorm = global_norm(grads, layout["split"], model)
        new_params, new_opt, om = zero1_update(
            grads, opt_state, opt_cfg, layout["local_zero1"], data,
            layout["data_mesh"], param_dtype=L.dtype_of(cfg),
            grad_norm=gnorm)
        ce = data.sum(ce)
        metrics = {"loss": ce + AUX_LOSS_WEIGHT * aux, "ce": ce, "aux": aux,
                   **om}
        return new_params, new_opt, metrics

    return train_step


def make_eval_step(cfg: ModelConfig, rules=None):
    """eval_step(params, batch) -> the mean CE of the full logits, with
    no gradient recorded.  With `rules`: over the global batch, each rank
    taking the rows of its data coordinate, with its shards of the params
    (the logits vocabulary-parallel where the vocabulary is split)."""
    data, model = (None, None) if rules is None else _axis_groups(rules)

    def eval_step(params, batch):
        labels, mask = api.loss_targets(cfg, batch)
        with torch.no_grad(), process_group.model_parallel(model):
            logits, _ = api.forward(params, cfg, batch)
            ce = api.cross_entropy(logits, labels, mask,
                                   L.vocab_first(params["embed"], cfg))
            if data is None:
                return ce
            n = torch.sum(mask)
            total, count = data.sum(torch.stack([ce * n, n]))
            return total / torch.clamp(count, min=1.0)

    return eval_step


def _serving_rules(rules):
    if rules is not None:
        raise NotImplementedError(
            "sharding rules in the serving steps: the port serves on one "
            "device (the caches' specs are rules only)")


def make_prefill_step(cfg: ModelConfig, max_len: int, rules=None):
    """prefill_step(params, batch) -> (next token (B, 1) int32, cache): the
    argmax of the last position's logits.  `rules` is refused."""
    _serving_rules(rules)

    def prefill_step(params, batch):
        logits, cache = api.prefill(params, cfg, batch, max_len)
        next_tok = torch.argmax(logits[:, -1:], dim=-1).to(torch.int32)
        return next_tok, cache

    return prefill_step


def make_decode_step(cfg: ModelConfig, rules=None):
    """decode_step(params, tokens (B, 1), cache) -> (next token, cache).
    `rules` is refused."""
    _serving_rules(rules)

    def decode_step(params, tokens, cache):
        logits, cache = api.decode_step(params, cfg, tokens, cache)
        next_tok = torch.argmax(logits, dim=-1).to(torch.int32)
        return next_tok, cache

    return decode_step
