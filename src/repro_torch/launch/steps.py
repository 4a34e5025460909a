"""Step functions (port of `repro.launch.steps`).

    make_train_step(cfg, opt_cfg, rules=None) -> (params, opt_state, batch)
                                     -> (params, opt_state, metrics)
    make_eval_step(cfg, rules=None) -> (params, batch) -> mean CE
    make_prefill_step(cfg, max_len, rules=None) -> (params, batch)
                                     -> (next token, cache)
    make_decode_step(cfg, rules=None) / serve_step -> (params, tokens,
                                     cache) -> (next token, cache)

``rules=None`` is one device.  With `distributed.ShardingRules` over a
mesh of a process group (`launch.mesh.make_host_mesh(group=)`, or the dry
run's rank view of a production mesh, `launch.mesh.make_rank_view`) the
steps are the reference's GSPMD step written out over the (data, model)
mesh:
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
    once, so the clip is one process's;
  * FSDP (``rules.fsdp``): the params the rules split over the data axis
    too are gathered whole where their layer starts (`process_group.
    fsdp`: `layers.index` inside the remat'd body; the leaves outside the
    layer stacks once, at the step's start), their gradients leave
    through the gather's reduce-scatter (not the data axis's all-reduce),
    their squares are summed over the data axis in the norm, and AdamW
    updates their shards in place of ZeRO-1's, the new params staying
    shards.
SP (``rules.sp``) is refused: no reference path sets it (ROADMAP §A,
"SP execution").

The serving steps under rules take the global batch (every rank the
same tokens) and return the global next tokens: a rank prefills and
decodes the rows of its data coordinate where the batch divides the data
axis (the next tokens gathered over it), else every row with the
attention caches' sequence split over the data axis
(`process_group.kv_sequence`: decode attention's softmax split over the
ranks), as `ShardingRules.cache_pspecs` lays the caches out; over the
model axis the caches hold this rank's heads, and the logits, split over
the vocabulary, are gathered whole before the argmax, so every rank
picks the same token.

Every family goes through them, its batch in `models.api`'s layout (the
vlm and encdec batches carry their stub embeddings beside the tokens).
The params stay a plain dict of tensors: a train step takes the
gradients with `torch.autograd.grad` over its leaves (`loss_and_grads`)
and hands them to the functional `optim.adamw_update`, which returns new
params, as the reference's pure step does.
"""
from __future__ import annotations

from types import SimpleNamespace
from typing import Optional

import torch

from repro_torch.configs.base import ModelConfig
from repro_torch.distributed import process_group
from repro_torch.distributed.sharding import (_axes_of, whole_shape,
                                              without_axis)
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
    fwd = whole_outside_layers(p)
    if fused_loss:
        feats, aux = api.forward_features(fwd, cfg, batch)
        ce = api.chunked_cross_entropy(fwd, cfg, feats, labels, mask)
    else:
        logits, aux = api.forward(fwd, cfg, batch)
        ce = api.cross_entropy(logits, labels, mask)
    ce = ce * ce_weight
    aux = torch.as_tensor(aux, dtype=torch.float32, device=ce.device)
    loss = ce + AUX_LOSS_WEIGHT * aux
    leaves = tree_leaves(p)
    by_id = dict(zip(map(id, leaves), torch.autograd.grad(loss, leaves)))
    return ((loss.detach(), ce.detach(), aux.detach()),
            tree_map(lambda t: by_id[id(t)], p))


# the params' top-level keys whose leaves are stacked over layers and
# taken a layer at a time by `layers.index` (where FSDP gathers them)
LAYER_STACKS = ("blocks", "mamba_blocks", "enc_blocks", "dec_blocks")


def whole_outside_layers(params: dict) -> dict:
    """`params` with the leaves outside the layer stacks gathered whole
    where FSDP splits them (`process_group.fsdp_whole`; the identity
    outside `process_group.fsdp`): the embedding, the final norms, a
    shared block, used whole across the step."""
    whole = process_group.fsdp_whole
    return {k: v if k in LAYER_STACKS else
            tree_map(whole, v) if isinstance(v, dict) else whole(v)
            for k, v in params.items()}


def _axis_groups(rules):
    """(data group, model group) of this rank on the rules' mesh (a mesh
    over a process group, or a rank's view of one); refuses what the port
    does not execute."""
    mesh = rules.mesh
    if getattr(mesh, "process_group", None) is None:
        raise ValueError("a sharded step needs a mesh over a process group "
                         "(launch.mesh.make_host_mesh(group=...))")
    if rules.sp:
        raise NotImplementedError(
            "sp: sequence parallelism is rules only; no reference path "
            "sets it (ROADMAP §A, SP execution)")
    key = rules.dp[0] if len(rules.dp) == 1 else tuple(rules.dp)
    if key not in mesh.axis_groups:
        raise NotImplementedError(f"data axes {rules.dp}: the mesh has no "
                                  "group over them")
    return mesh.axis_groups[key], mesh.axis_groups[rules.tp_axis]


def fsdp_split(layout: dict, params: dict) -> list:
    """[(leaf, dim)]: the leaves of `params` that FSDP splits over the data
    axis (`param_layout`'s ``fsdp``), with the dim."""
    return [(t, d) for (_, t), (_, d) in zip(named_leaves(params),
                                            named_leaves(layout["fsdp"]))
            if d is not None]


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
    split.  Those ``meta`` trees are bookkeeping, not the step's work: a
    mode tracing the step (the dry run's counters) does not see them."""
    from torch.utils._python_dispatch import _disable_current_modes

    with _disable_current_modes():
        return _param_layout(cfg, rules, params)


def _param_layout(cfg: ModelConfig, rules, params: dict) -> dict:
    mesh, tp = rules.mesh, rules.tp_axis
    specs = rules.param_pspecs(api.param_specs(cfg))
    whole = tree_map(lambda p, s: torch.empty(
        whole_shape(p.shape, s, mesh), dtype=p.dtype, device="meta"),
        params, specs)

    def fsdp_dim(spec):
        if not rules.fsdp or rules.dp_size == 1:
            return None
        return next((d for d, e in enumerate(spec)
                     if set(_axes_of(e)) & set(rules.dp)), None)

    def local(zspec, dim):
        out = without_axis(zspec, tp)
        if dim is not None:              # FSDP's shard: cut no further
            for a in rules.dp:
                out = without_axis(out, a)
        return out

    fsdp = tree_map(fsdp_dim, specs)
    return {"split": tree_map(lambda s: rules.tp_size > 1
                              and without_axis(s, tp) != tuple(s), specs),
            "partial": rules.model_partial(whole),
            "fsdp": fsdp,
            "data_split": tree_map(lambda d: d is not None, fsdp),
            "local_zero1": tree_map(local, zero1_specs(rules, whole), fsdp),
            "data_mesh": SimpleNamespace(shape={
                a: (n if a in rules.dp else 1)
                for a, n in mesh.shape.items()})}


def _sum_grads(grads, partial, data, model, data_split=None):
    """The gradients summed over the data axis (float32), and the leaves
    marked `partial` also over the model axis.  The leaves marked
    `data_split` (FSDP's shards) were summed over the data axis by their
    gather's reduce-scatter already: they are only cast to float32."""
    if data_split is None:
        grads = data.all_reduce_grads(grads)
    else:
        split = dict(named_leaves(data_split))
        rest = data.all_reduce_grads({n: g for n, g in named_leaves(grads)
                                      if not split[n]})
        grads = map_named(lambda n, g: rest.get(n, L.upcast(g)), grads)
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
        fsdp = rules.fsdp and data.world > 1
        with process_group.reducing(data), \
                process_group.model_parallel(model), \
                process_group.fsdp(data, fsdp_split(layout, params)):
            (_, ce, aux), grads = loss_and_grads(params, cfg, batch,
                                                 fused_loss, ce_weight=share)
        grads = _sum_grads(grads, layout["partial"], data, model,
                           layout["data_split"] if fsdp else None)
        gnorm = global_norm(grads, layout["split"], model,
                            layout["data_split"] if fsdp else None, data)
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
    layout = {}

    def eval_step(params, batch):
        labels, mask = api.loss_targets(cfg, batch)
        split = []
        if rules is not None and rules.fsdp:
            if not layout:
                layout.update(param_layout(cfg, rules, params))
            split = fsdp_split(layout, params)
        with torch.no_grad(), process_group.model_parallel(model), \
                process_group.fsdp(data, split):
            params = whole_outside_layers(params)
            logits, _ = api.forward(params, cfg, batch)
            ce = api.cross_entropy(logits, labels, mask,
                                   L.vocab_first(params["embed"], cfg))
            if data is None:
                return ce
            n = torch.sum(mask)
            total, count = data.sum(torch.stack([ce * n, n]))
            return total / torch.clamp(count, min=1.0)

    return eval_step


class _Serving:
    """What a serving step under `rules` does around the model: which rows
    of the global batch this rank takes, the groups it runs under, and the
    whole logits and global next tokens it returns."""

    def __init__(self, cfg: ModelConfig, rules):
        self.cfg, self.rules = cfg, rules
        self.data = self.model = None
        if rules is not None:
            self.data, self.model = _axis_groups(rules)
        self.layout = {}

    def rows(self, batch_size: int) -> Optional[slice]:
        """This rank's rows of a global batch: its data coordinate's where
        the batch divides the data axis; None (every row, the caches'
        sequence split over the data axis) where it does not."""
        data = self.data
        if data is None or data.world == 1 or batch_size % data.world:
            return None
        n = batch_size // data.world
        return slice(data.rank * n, (data.rank + 1) * n)

    def run(self, params, batch_size: int, fn):
        """fn(params with the leaves outside the layers whole) under the
        model axis, FSDP and the split cache sequence this batch needs."""
        data = self.data
        split, seq = [], None
        if self.rules is not None:
            if self.rules.fsdp:
                if not self.layout:
                    self.layout.update(param_layout(self.cfg, self.rules,
                                                    params))
                split = fsdp_split(self.layout, params)
            if data.world > 1 and self.rows(batch_size) is None:
                seq = data
        with torch.no_grad(), process_group.model_parallel(self.model), \
                process_group.fsdp(data, split), \
                process_group.kv_sequence(seq):
            return fn(whole_outside_layers(params))

    def whole_logits(self, params, logits):
        """`logits` whole over the vocabulary (gathered over the model axis
        where the unembedding is split)."""
        if self.model is None or L.vocab_first(params["embed"],
                                                self.cfg) is None:
            return logits
        with process_group.model_parallel(self.model):
            return process_group.gather_from_model(logits, -1)

    def global_rows(self, x, batch_size: int):
        """`x` (this rank's rows) over the global batch: gathered over the
        data axis where the rank took its rows."""
        if self.rows(batch_size) is None:
            return x
        return self.data.all_gather(x, 0)


def _cut_rows(batch: dict, rows: Optional[slice]) -> dict:
    return batch if rows is None else {k: v[rows] for k, v in batch.items()}


def make_prefill_step(cfg: ModelConfig, max_len: int, rules=None,
                      with_logits: bool = False,
                      cache_dtype=torch.bfloat16):
    """prefill_step(params, batch) -> (next token (B, 1) int32, cache): the
    argmax of the last position's logits.  With `rules`: `batch` the
    global batch, `params` this rank's shards, the cache this rank's
    (see the module's docstring), the next tokens the global batch's.
    `with_logits` adds the last position's float32 logits (B, 1, V),
    whole and global, as a third output.  The caches are `cache_dtype`
    (the reference's bf16 by default)."""
    serving = _Serving(cfg, rules)

    def prefill_step(params, batch):
        B = next(iter(batch.values())).shape[0]
        mine = _cut_rows(batch, serving.rows(B))

        def run(p):
            logits, cache = api.prefill(p, cfg, mine, max_len,
                                        cache_dtype=cache_dtype)
            return serving.whole_logits(p, logits[:, -1:]), cache

        last, cache = serving.run(params, B, run)
        next_tok = torch.argmax(last, dim=-1).to(torch.int32)
        next_tok = serving.global_rows(next_tok, B)
        if with_logits:
            return next_tok, cache, serving.global_rows(last, B)
        return next_tok, cache

    return prefill_step


def make_decode_step(cfg: ModelConfig, rules=None,
                     with_logits: bool = False):
    """decode_step(params, tokens (B, 1), cache) -> (next token, cache).
    With `rules`: `tokens` the global batch's, `cache` this rank's (as its
    prefill step made it), the next tokens the global batch's.
    `with_logits` adds the float32 logits (B, 1, V), whole and global."""
    serving = _Serving(cfg, rules)

    def decode_step(params, tokens, cache):
        B = tokens.shape[0]
        rows = serving.rows(B)
        mine = tokens if rows is None else tokens[rows]

        def run(p):
            logits, new = api.decode_step(p, cfg, mine, cache)
            return serving.whole_logits(p, logits), new

        logits, cache = serving.run(params, B, run)
        next_tok = torch.argmax(logits, dim=-1).to(torch.int32)
        next_tok = serving.global_rows(next_tok, B)
        if with_logits:
            return next_tok, cache, serving.global_rows(logits, B)
        return next_tok, cache

    return decode_step


def serve_step(cfg: ModelConfig, rules=None):
    """The reference's alias, which its dry run lowers for decode-kind
    shapes: one new token against a pre-populated cache."""
    return make_decode_step(cfg, rules)
