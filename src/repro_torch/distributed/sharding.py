"""Sharding rules: DP / TP / EP / SP / ZeRO-1 / FSDP over a named mesh
(port of `repro.distributed.sharding`).

One object owns every layout decision, so the train step, the optimizer,
the checkpoints and the serving caches agree:

  * **DP**: batch over ("pod", "data"), the data-parallel axes.
  * **TP**: Megatron column/row sharding of attention heads and FFN over
    "model"; vocab-sharded embedding/lm_head.
  * **EP**: MoE expert dim over "model".
  * **FSDP** (optional): every param additionally sharded over the DP
    axes on its largest free divisible dim of at least 1024.
  * **SP** (optional): sequence dim of residual activations over "model".
  * **ZeRO-1**: optimizer master/moments always sharded over the DP axes,
    even when fsdp=False for params.
  * Decode fallback: when batch < dp size (long_500k has batch 1), caches
    shard their *sequence* dim over "data" instead.

Dims that do not divide evenly by the axis size are replicated (e.g. MQA's
single KV head).

A spec is a tuple with one entry per dimension: None (replicated), an
axis name, or a tuple of axis names (the dimension split over their
product, the first axis outermost).  The entries are in the reference's
canonical form: `jax.sharding.PartitionSpec` turns a 1-tuple of axes into
the bare name and an empty tuple into None, and so does `_entry`, so a
spec here equals ``tuple(P)`` of the reference's.  The rules read only
``mesh.shape`` (a dict of axis sizes), so they run on a
`launch.mesh.ShardMesh` of any device, the shape-only ``meta`` production
meshes included, and on trees of ``meta`` tensors (`models.api`'s
`param_specs`, `cache_specs`): at full size, with no memory.

What places a tensor by its spec is `shard_of` (this rank's slice) and
`unshard` (the slices put back together); the reference's `named` /
`*_shardings` hand the same specs to `jax.device_put`.  The port executes
data, tensor and expert parallelism in its train and eval steps
(`launch.steps`): each rank holds `shard_of` its params, the models run
the Megatron collectives of the blocks whose leaves are split
(`distributed.process_group`'s f and g), and `model_partial` says which
whole leaves get a partial gradient; FSDP's leaves are gathered over the
data axis where their layer starts.  SP is rules only: the steps refuse
it.
"""
from __future__ import annotations

import dataclasses
import math
from typing import Optional, Sequence, Tuple

import torch

from repro_torch.configs.base import ModelConfig
from repro_torch.tree import map_named

Spec = Tuple  # one entry a dimension: None, an axis name, or a tuple of them

# FSDP splits a leaf's largest free dim of at least this many entries (the
# reference's 1024)
FSDP_MIN = 1024


def _entry(axes):
    """An entry in canonical form: () -> None, (a,) -> a."""
    if isinstance(axes, tuple):
        if not axes:
            return None
        if len(axes) == 1:
            return axes[0]
    return axes


def _axes_of(entry) -> Tuple[str, ...]:
    """The axis names of one spec entry, outermost first."""
    if entry is None:
        return ()
    return entry if isinstance(entry, tuple) else (entry,)


def _spec(entries) -> Spec:
    return tuple(_entry(e) for e in entries)


def _leaf_name(name: str) -> str:
    """The last key of a leaf's path, as `tree.map_named`
    names it (``opt/master/blocks/in_x`` -> ``in_x``): the reference's
    last dict key or NamedTuple field."""
    return name.rsplit("/", 1)[-1]


@dataclasses.dataclass
class ShardingRules:
    mesh: object                      # anything with a .shape dict
    cfg: ModelConfig
    dp_axes: Tuple[str, ...] = ("data",)
    tp_axis: str = "model"
    fsdp: bool = False
    sp: bool = False

    # -- helpers -------------------------------------------------------------
    def axis_size(self, name) -> int:
        if isinstance(name, tuple):
            return math.prod(self.axis_size(n) for n in name)
        return self.mesh.shape[name]

    @property
    def dp(self) -> Tuple[str, ...]:
        return tuple(a for a in self.dp_axes if a in self.mesh.shape)

    @property
    def dp_size(self) -> int:
        return self.axis_size(self.dp)

    @property
    def tp_size(self) -> int:
        return self.axis_size(self.tp_axis)

    def _shard_if(self, dim: int, axis) -> Optional[str]:
        return axis if dim % self.axis_size(axis) == 0 else None

    # -- activation constraints ----------------------------------------------
    def constrain(self, x, tag: str):
        """The identity.  The reference pins an activation's layout for
        GSPMD (`with_sharding_constraint`), which then inserts the
        collectives.  Here a rank's activations are its own rows already,
        and the collectives of tensor and expert parallelism are written
        out where the layouts change, in the blocks that own them
        (`models.layers`' attention, MLPs, embedding and unembedding,
        `models.mamba2.block_forward`, `models.moe.moe_block`, the
        vocabulary-parallel loss in `models.api`), each reading its
        leaves' shapes; so there is nothing to pin."""
        return x

    def activation_spec(self, x, tag: str) -> Optional[Spec]:
        dp = self.dp if x.shape[0] % max(self.dp_size, 1) == 0 else None
        tp = self.tp_axis
        if tag == "act_model":            # (B, S, D)
            seq = tp if (self.sp and x.shape[1] % self.tp_size == 0) else None
            return _spec((dp, seq, None))
        if tag in ("act_heads", "act_kv_heads"):   # (B, S, H, hd)
            return _spec((dp, None, self._shard_if(x.shape[2], tp), None))
        if tag in ("act_ff", "act_vocab"):         # (B, S, F) / (B, S, V)
            return _spec((dp, None, self._shard_if(x.shape[2], tp)))
        if tag == "moe_expert_batch":     # (E, C, D)
            return _spec((self._shard_if(x.shape[0], tp), None, None))
        if tag == "moe_expert_batch_g":   # (G, E, C, D): G over dp, E over tp
            gdp = self.dp if x.shape[0] % max(self.dp_size, 1) == 0 else None
            return _spec((gdp, self._shard_if(x.shape[1], tp), None, None))
        return None

    # -- parameter specs -----------------------------------------------------
    def param_pspecs(self, param_tree):
        """A spec for every leaf of a (stacked) parameter tree."""
        return map_named(self._param_spec, param_tree)

    def _param_spec(self, path: str, leaf) -> Spec:
        name = _leaf_name(path)
        shape = tuple(leaf.shape)
        tp = self.tp_axis
        spec = [None] * len(shape)

        def put(dim, axis):
            if 0 <= dim < len(shape) and spec[dim] is None and \
                    shape[dim] % self.axis_size(axis) == 0:
                spec[dim] = axis
                return True
            return False

        nd = len(shape)
        if name == "embedding":               # (V, D)
            put(nd - 2, tp)
        elif name == "lm_head":               # (D, V)
            put(nd - 1, tp)
        elif name in ("wq", "wk", "wv"):      # (L?, D, H, hd)
            put(nd - 2, tp)
        elif name == "wo":                    # (L?, H, hd, D)
            put(nd - 3, tp)
        elif name in ("bq", "bk", "bv"):      # (L?, H, hd)
            put(nd - 2, tp)
        elif name in ("w_gate", "w_up"):
            # MoE (L?, E, D, F): expert parallelism; dense (L?, D, F)
            put(nd - 3 if nd >= 4 else nd - 1, tp)
        elif name == "w_down":                # MoE (L?, E, F, D) / (L?, F, D)
            put(nd - 3 if nd >= 4 else nd - 2, tp)
        elif name == "w_in":                  # (L?, D, F)
            put(nd - 1, tp)
        elif name == "w_out":                 # (L?, F, D)
            put(nd - 2, tp)
        elif name == "b_in":                  # (L?, F)
            put(nd - 1, tp)
        elif name in ("in_z", "in_x", "in_bc"):  # mamba col-parallel (…, D, X)
            put(nd - 1, tp)
        elif name == "out_proj":              # mamba row-parallel (…, d_i, D)
            put(nd - 2, tp)
        elif name in ("conv_x_w", "conv_bc_w", "conv_x_b", "conv_bc_b"):
            put(nd - 1, tp)                   # depthwise conv (…, W, C)
        # in_dt (…, D, H): H rarely divides tp — replicated
        # norms / scalars / router / pos-embeds: replicated on tp

        if self.fsdp:
            # additionally shard the largest free divisible dim over dp
            for d in sorted(range(nd), key=lambda d: -shape[d]):
                if shape[d] >= FSDP_MIN and put(d, self.dp):
                    break
        return _spec(spec)

    def model_partial(self, param_tree):
        """A bool for every leaf of a (whole-shaped) parameter tree: True
        where a rank's gradient of it is only its part, to be summed over
        the model axis.  Those are the leaves the spec leaves whole inside
        a block that runs split over the model axis (between its f and
        its g), so a rank uses them on its own heads or channels only:
        attention's q_norm / k_norm and a whole wk / wv (with bk, bv); the
        Mamba2 block's in_dt, dt_bias, A_log, D, gate_norm and a whole
        in_bc and BC conv.  Not the leaves used on the activations every
        rank holds alike (the pre-norms, the router, the final norm, a
        whole embedding; whisper's b_out, added after g), whose gradient
        is the same on every rank already; nor any leaf of a Mamba2 block
        whose heads do not divide the model axis, which every rank runs
        whole (`models.mamba2._whole_if_cut`)."""
        tp = self.tp_axis
        cfg = self.cfg
        ssm_cut = (cfg.ssm_expand * cfg.d_model // cfg.ssm_headdim) \
            % self.tp_size != 0

        def split(path, leaf):
            return self.tp_size > 1 and tp in _axes_of_spec(
                self._param_spec(path, leaf))

        def walk(tree, prefix, region):
            if region is None and "router" not in tree:
                for key, outside in (("wq", ()), ("w_gate", ()),
                                     ("w_in", ("b_out",)),
                                     ("in_x", ("norm",))):
                    if key in tree and not isinstance(tree[key], dict):
                        if split(prefix + key, tree[key]) and not (
                                key == "in_x" and ssm_cut):
                            region = outside
                        break
            return {k: walk(v, f"{prefix}{k}/", region)
                    if isinstance(v, dict) else
                    (region is not None and k not in region
                     and not split(prefix + k, v))
                    for k, v in tree.items()}

        return walk(param_tree, "", None)

    # -- optimizer state (ZeRO-1) ---------------------------------------------
    def opt_pspecs(self, opt_state):
        """Same layout as params, plus dp-sharding of the largest free
        dim of every moment/master leaf (ZeRO-1).  `opt_state` is an
        `optim.AdamWState` (its leaves' shapes are read)."""
        from repro_torch.optim.adamw import AdamWState

        def zero1(path, leaf):
            spec = list(self._param_spec(path, leaf))
            shape = tuple(leaf.shape)
            # fsdp rules may already hold the dp axes: an axis appears at
            # most once in a spec
            used = {a for s in spec for a in _axes_of(s)}
            dp_free = not any(a in used for a in self.dp)
            if self.dp and dp_free:
                for d in sorted(range(len(shape)), key=lambda d: -shape[d]):
                    if spec[d] is None and shape[d] % self.dp_size == 0 \
                            and shape[d] >= self.dp_size:
                        spec[d] = self.dp
                        break
            return _spec(spec)

        return AdamWState(
            step=(),
            master=map_named(zero1, opt_state.master),
            mu=map_named(zero1, opt_state.mu),
            nu=map_named(zero1, opt_state.nu))

    # -- batches ------------------------------------------------------------
    def batch_pspecs(self, batch_specs: dict) -> dict:
        out = {}
        for k, v in batch_specs.items():
            nd = len(v.shape)
            if v.shape[0] % max(self.dp_size, 1) == 0:
                out[k] = _spec((self.dp,) + (None,) * (nd - 1))
            else:
                out[k] = (None,) * nd
        return out

    # -- serving caches -----------------------------------------------------
    def cache_pspecs(self, cache):
        """KV/SSM caches: batch over dp when divisible, else the sequence
        (capacity) dim over dp (long-context decode, batch=1); kv-head dims
        over tp when divisible."""
        def assign(path, leaf):
            name = _leaf_name(path)
            shape = tuple(leaf.shape)
            if name == "length":
                return ()
            spec = [None] * len(shape)
            kv = name in ("k", "v", "cross_k", "cross_v")
            # leaves: (L, B, S, H, hd) kv / (L, B, W, C) conv /
            #         (L, B, H, N, P) state
            if len(shape) >= 2 and shape[1] % max(self.dp_size, 1) == 0:
                spec[1] = self.dp
            elif kv and len(shape) >= 3 \
                    and shape[2] % max(self.dp_size, 1) == 0:
                spec[2] = self.dp            # sequence-sharded cache (dp)
            if kv and len(shape) >= 4:
                if shape[3] % self.tp_size == 0:
                    spec[3] = self.tp_axis
                elif spec[2] is None and shape[2] % self.tp_size == 0:
                    # kv-heads not TP-shardable (GQA/MQA with few heads):
                    # flash-decode style, the cache SEQUENCE over "model"
                    # (a small (B, H) all-reduce in the softmax, where a
                    # replicated cache would not fit)
                    spec[2] = self.tp_axis
            if name in ("conv", "state") and len(shape) >= 3:
                d = len(shape) - (2 if name == "state" else 1)
                if spec.count(self.tp_axis) == 0 and \
                        shape[d] % self.tp_size == 0:
                    spec[d] = self.tp_axis
            return _spec(spec)

        return map_named(assign, cache)


def needs_fsdp(cfg: ModelConfig, tp_size: int,
               hbm_bytes: int = 16 * 2 ** 30) -> bool:
    """Params + grads (bf16) + ZeRO'd optimizer must fit: fsdp when the
    TP-only bf16 param shard exceeds a quarter of `hbm_bytes`.  The
    default is the reference's, sized for its 16 GiB accelerator; an
    H100 has 80 GB: pass ``hbm_bytes`` for it."""
    shard = cfg.param_count() * 2 / max(tp_size, 1)
    return shard > hbm_bytes // 4


# ---------------------------------------------------------------------------
# Placing tensors by spec
# ---------------------------------------------------------------------------

def mesh_coords(mesh, rank: int) -> dict:
    """{axis: index} of flat `rank` on `mesh`, row-major over its axes
    (the last axis fastest), as a device's place in a `jax` mesh."""
    coords = {}
    for axis in reversed(list(mesh.shape)):
        rank, coords[axis] = divmod(rank, mesh.shape[axis])
    return {a: coords[a] for a in mesh.shape}


def all_coords(mesh) -> list:
    """Every rank's coordinates, in flat rank order."""
    n = math.prod(mesh.shape.values())
    return [mesh_coords(mesh, r) for r in range(n)]


def shard_slices(shape: Sequence[int], spec: Spec, coords: dict,
                 mesh) -> tuple:
    """The slice of each dimension that the rank at `coords` holds: a
    dimension over axes (a, b) splits into size(a) * size(b) equal blocks,
    block index coords[a] * size(b) + coords[b]."""
    spec = tuple(spec) + (None,) * (len(shape) - len(spec))
    out = []
    for n, entry in zip(shape, spec):
        axes = _axes_of(entry)
        parts, idx = 1, 0
        for a in axes:
            parts, idx = parts * mesh.shape[a], idx * mesh.shape[a] + coords[a]
        if n % parts:
            raise ValueError(f"dimension {n} does not split over {axes} "
                             f"({parts} parts)")
        block = n // parts
        out.append(slice(idx * block, (idx + 1) * block))
    return tuple(out)


def _axes_of_spec(spec) -> tuple:
    return tuple(a for e in spec for a in _axes_of(e))


def whole_shape(shape: Sequence[int], spec: Spec, mesh) -> tuple:
    """The whole tensor's shape from a shard's `shape` under `spec`."""
    spec = tuple(spec) + (None,) * (len(shape) - len(spec))
    return tuple(n * math.prod(mesh.shape[a] for a in _axes_of(e))
                 for n, e in zip(shape, spec))


def without_axis(spec: Spec, axis: str) -> Spec:
    """`spec` with `axis` taken out of every entry: the spec of the
    slices that the other axes cut of a shard already cut on `axis`."""
    return _spec(tuple(a for a in _axes_of(e) if a != axis) for e in spec)


def shard_of(tensor: torch.Tensor, spec: Spec, coords: dict,
             mesh) -> torch.Tensor:
    """This rank's slice of `tensor` (a copy, contiguous)."""
    return tensor[shard_slices(tensor.shape, spec, coords, mesh)].clone(
        memory_format=torch.contiguous_format)


def unshard(parts: Sequence[torch.Tensor], spec: Spec, mesh,
            shape: Optional[Sequence[int]] = None) -> torch.Tensor:
    """The whole tensor from every rank's slice (`parts` in flat rank
    order, as `shard_of` cut them); replicated slices are the same values
    written again."""
    coords = all_coords(mesh)
    if len(parts) != len(coords):
        raise ValueError(f"{len(parts)} parts for a mesh of {len(coords)}")
    if shape is None:
        shape = whole_shape(parts[0].shape, spec, mesh)
    out = parts[0].new_empty(tuple(shape))
    for c, p in zip(coords, parts):
        out[shard_slices(shape, spec, c, mesh)] = p
    return out


__all__ = ["FSDP_MIN", "ShardingRules", "Spec", "all_coords", "mesh_coords",
           "needs_fsdp", "shard_of", "shard_slices", "unshard",
           "whole_shape", "without_axis"]
