"""AdamW with float32 master weights, global-norm clipping and a cosine
schedule (port of `repro.optim.adamw`).

The reference's formulas to the letter, on plain dicts of tensors: the
state holds float32 master params and moments with the params' tree;
the gradients are clipped by their global norm; the decay is decoupled
and inside the update, ``p - lr * (mh / (sqrt(vh) + eps) + wd * p)``; the
new params are the master cast to `param_dtype`.  Not `torch.optim.AdamW`,
whose formula differs (it decays the params before the Adam step, by
``lr * wd``), and not a module holding state: `adamw_update` takes the
state and returns a new one, as the reference's does.  Scalars (the step,
the learning rate, the norm) stay tensors on the params' device, so a
step does not wait for the card.

ZeRO-1 (`zero1_init`, `zero1_update`): under data parallelism master,
mu and nu hold only this rank's shard (`distributed.ShardingRules.
opt_pspecs`), the update runs on the shard, and the new params are
gathered whole on every rank.  Under FSDP (`opt_pspecs` with
``fsdp=True``) a param split over the data axis has its state split as
it is: `zero1_update` is given specs that cut such a leaf no further, so
AdamW updates this rank's shard and the new param stays a shard, with no
gather; the leaves FSDP leaves whole are ZeRO-1's as before.
"""
from __future__ import annotations

import dataclasses
import math
from typing import NamedTuple

import torch

from repro_torch.tree import tree_leaves, tree_map


@dataclasses.dataclass(frozen=True)
class AdamWConfig:
    lr: float = 3e-4
    b1: float = 0.9
    b2: float = 0.95
    eps: float = 1e-8
    weight_decay: float = 0.1
    clip_norm: float = 1.0
    warmup_steps: int = 100
    total_steps: int = 10000
    min_lr_ratio: float = 0.1


class AdamWState(NamedTuple):
    step: torch.Tensor    # () int32
    master: dict          # float32 copy of params
    mu: dict              # float32 first moment
    nu: dict              # float32 second moment


def adamw_init(params: dict) -> AdamWState:
    f32 = torch.float32
    dev = tree_leaves(params)[0].device
    return AdamWState(
        step=torch.zeros((), dtype=torch.int32, device=dev),
        master=tree_map(lambda x: x.detach().to(f32, copy=True), params),
        mu=tree_map(lambda x: torch.zeros(x.shape, dtype=f32,
                                          device=x.device), params),
        nu=tree_map(lambda x: torch.zeros(x.shape, dtype=f32,
                                          device=x.device), params))


def global_norm(tree, split=None, group=None, data_split=None,
                data_group=None) -> torch.Tensor:
    """sqrt of the sum of every leaf's squares, in float32.  `split` (a
    tree of bools over `tree`) marks the leaves that hold this rank's
    block over the ranks of `group` (tensor parallelism): their squares
    are summed over the group, the other leaves (the same on every rank)
    count once, so the norm is the whole gradient's.  `data_split` marks
    likewise the leaves that hold a block over `data_group` (FSDP): their
    squares are summed over it too."""
    leaves = tree_leaves(tree)
    n = len(leaves)
    model = tree_leaves(split) if split is not None else [False] * n
    data = (tree_leaves(data_split) if data_split is not None
            else [False] * n)
    parts = {}
    for x, s, d in zip(leaves, model, data):
        key = (bool(s), bool(d))
        parts[key] = parts.get(key, 0) + torch.sum(torch.square(x.float()))
    total = parts.get((False, False), 0)
    for (s, d), part in sorted(parts.items()):
        if not (s or d):
            continue
        if d and data_group is not None:
            part = data_group.sum(part)
        if s and group is not None:
            part = group.sum(part)
        total = total + part
    return torch.sqrt(total)


def cosine_schedule(cfg: AdamWConfig, step) -> torch.Tensor:
    """Linear warm-up to `cfg.lr`, then a cosine down to
    `min_lr_ratio * lr` at `total_steps`; float32, at a step tensor."""
    step = step.to(torch.float32)
    warm = torch.clamp(step / max(cfg.warmup_steps, 1), max=1.0)
    prog = torch.clamp((step - cfg.warmup_steps)
                       / max(cfg.total_steps - cfg.warmup_steps, 1),
                       0.0, 1.0)
    cos = 0.5 * (1.0 + torch.cos(math.pi * prog))
    scale = cfg.min_lr_ratio + (1.0 - cfg.min_lr_ratio) * cos
    return cfg.lr * warm * scale


def adamw_update(grads: dict, state: AdamWState, cfg: AdamWConfig,
                 param_dtype=torch.bfloat16, grad_norm=None):
    """One optimizer step.  Returns (new params in `param_dtype`, new
    state, metrics {grad_norm, lr, clip_scale}).  `state` is left as it
    was.  `grad_norm`: the whole gradient's global norm, where `grads`
    and `state` hold only this rank's shards (ZeRO-1, `zero1_update`);
    by default the norm of `grads`."""
    step = state.step + 1
    lr = cosine_schedule(cfg, step)

    gnorm = global_norm(grads) if grad_norm is None else grad_norm
    scale = torch.clamp(cfg.clip_norm / (gnorm + 1e-12), max=1.0)
    b1, b2 = cfg.b1, cfg.b2
    t = step.to(torch.float32)
    bc1 = 1.0 - torch.pow(b1, t)
    bc2 = 1.0 - torch.pow(b2, t)

    def upd(g, p, m, v):
        """(master, mu, nu) of one leaf: a leaf at a time, so only one
        leaf's clipped gradient is held at once."""
        g = g.float() * scale
        m = b1 * m + (1 - b1) * g
        v = b2 * v + (1 - b2) * g * g
        mh = m / bc1
        vh = v / bc2
        return (p - lr * (mh / (torch.sqrt(vh) + cfg.eps)
                          + cfg.weight_decay * p), m, v)

    new = tree_map(upd, grads, state.master, state.mu, state.nu)
    master, mu, nu = (tree_map(lambda x, i=i: x[i], new) for i in range(3))
    new_params = tree_map(lambda x: x.to(param_dtype), master)
    new_state = AdamWState(step=step, master=master, mu=mu, nu=nu)
    metrics = {"grad_norm": gnorm, "lr": lr, "clip_scale": scale}
    return new_params, new_state, metrics


# ---------------------------------------------------------------------------
# ZeRO-1: the state as this rank's shards
# ---------------------------------------------------------------------------

def zero1_shards(tree: dict, specs: dict, mesh, rank: int) -> dict:
    """This rank's shard of every leaf of `tree` (`specs`: the ZeRO-1
    specs, `distributed.ShardingRules.opt_pspecs(...).master`); a leaf
    its spec does not split over any axis of more than one rank is
    itself, not a copy."""
    from repro_torch.distributed.sharding import (_axes_of_spec, mesh_coords,
                                                  shard_of)

    coords = mesh_coords(mesh, rank)

    def cut(x, s):
        if all(mesh.shape[a] == 1 for a in _axes_of_spec(s)):
            return x
        return shard_of(x, s, coords, mesh)

    return tree_map(cut, tree, specs)


def zero1_init(params: dict, specs: dict, mesh, rank: int) -> AdamWState:
    """ZeRO-1's state: `adamw_init` of this rank's shards of `params`, so
    master, mu and nu hold only the shard."""
    return adamw_init(zero1_shards(params, specs, mesh, rank))


def zero1_update(grads: dict, state: AdamWState, cfg: AdamWConfig, specs,
                 group, mesh, param_dtype=torch.bfloat16, grad_norm=None):
    """`adamw_update` with ZeRO-1 over the data-parallel `group` (`mesh`
    its ranks, `specs` the ZeRO-1 specs of `grads`' leaves): `grads` the
    gradient summed over the group's ranks (the same on each); its global
    norm (`grad_norm`, where `grads` is this rank's block over a model
    axis; else `global_norm(grads)`) clips, the update runs on this
    rank's shard of state and gradient, and the new params are gathered
    whole on every rank of the group (`group.gather`).  Every operation
    after the norm is elementwise, so the shards equal the matching slices
    of the unsharded update bit for bit."""
    gnorm = global_norm(grads) if grad_norm is None else grad_norm
    shards, new_state, metrics = adamw_update(
        zero1_shards(grads, specs, mesh, group.rank), state, cfg,
        param_dtype, grad_norm=gnorm)
    shapes = tree_map(lambda g: tuple(g.shape), grads)
    return (group.gather(shards, specs, mesh, shapes), new_state, metrics)


def zero1_gather_state(state: AdamWState, specs: dict, group, mesh,
                       shapes: dict) -> AdamWState:
    """The whole state from every rank's ZeRO-1 shards (a checkpoint's
    global content)."""
    return AdamWState(step=state.step,
                      **{f: group.gather(getattr(state, f), specs, mesh,
                                         shapes)
                         for f in ("master", "mu", "nu")})
