"""Carry the JAX package's data into the port.

The stencil path has no model weights: its parameters are the model fields
and the precomputed sparse structures.  Each function takes plain numpy
arrays (``np.asarray`` of the reference's `GriddedSources`,
`GriddedReceivers`, `TileSourceTable` or `TileReceiverTable` fields) and
returns the port's structure on `device`, so the reference's exact
precompute can be fed to the port's propagators.  The language models'
parameters come across the same way (`mamba2_params_from_numpy`,
`zamba2_params_from_numpy`, `transformer_params_from_numpy` for the dense,
MoE and llava models, `whisper_params_from_numpy`).  Nothing
here imports the reference.
"""
from __future__ import annotations

from typing import Optional, Sequence

import numpy as np
import torch

from repro_torch._device import resolve_device
from repro_torch.configs.base import ModelConfig
from repro_torch.core import sources as src_mod
from repro_torch.core.propagators.acoustic import AcousticParams
from repro_torch.core.propagators.elastic import ElasticParams, ElasticState
from repro_torch.core.propagators.tti import TTIParams, TTIState
from repro_torch.models import mamba2, transformer, whisper, zamba2


def _fields(cls, arrays, device):
    dev = resolve_device(device)
    return cls(*(torch.as_tensor(np.array(a), device=dev) for a in arrays))


def acoustic_model_from_numpy(m, damp, device="cuda") -> AcousticParams:
    """Squared slowness and damping fields as float tensors on `device`."""
    return _fields(AcousticParams, (m, damp), device)


def tti_model_from_numpy(m, damp, epsilon, delta, theta, phi,
                         device="cuda") -> TTIParams:
    """The TTI model fields (a reference `TTIParams` unpacks into these
    arguments in order) as tensors on `device`."""
    return _fields(TTIParams, (m, damp, epsilon, delta, theta, phi), device)


def tti_state_from_numpy(p, p_prev, r, r_prev, device="cuda") -> TTIState:
    """A TTI wavefield state (the reference `TTIState`'s order)."""
    return _fields(TTIState, (p, p_prev, r, r_prev), device)


def elastic_model_from_numpy(lam, mu, b, damp,
                             device="cuda") -> ElasticParams:
    """The elastic model fields (a reference `ElasticParams`' order)."""
    return _fields(ElasticParams, (lam, mu, b, damp), device)


def elastic_state_from_numpy(vx, vy, vz, txx, tyy, tzz, txy, txz, tyz,
                             device="cuda") -> ElasticState:
    """An elastic wavefield state (the reference `ElasticState`'s order)."""
    return _fields(ElasticState, (vx, vy, vz, txx, tyy, tzz, txy, txz, tyz),
                   device)


def gridded_sources_from_numpy(sm, sid, points, src_dcmp,
                               device="cuda") -> src_mod.GriddedSources:
    """A `GriddedSources` from the reference's (sm, sid, points, src_dcmp)."""
    dev = resolve_device(device)
    return src_mod.GriddedSources(
        sm=np.asarray(sm, np.uint8), sid=np.asarray(sid, np.int32),
        points=torch.as_tensor(np.array(points, np.int32), device=dev),
        src_dcmp=torch.as_tensor(np.array(src_dcmp), device=dev))


def gridded_receivers_from_numpy(indices, weights,
                                 device="cuda") -> src_mod.GriddedReceivers:
    """A `GriddedReceivers` from the reference's (indices, weights)."""
    dev = resolve_device(device)
    return src_mod.GriddedReceivers(
        indices=torch.as_tensor(np.array(indices, np.int32), device=dev),
        weights=torch.as_tensor(np.array(weights), device=dev))


def tile_tables_from_numpy(src: Optional[Sequence] = None,
                           rec: Optional[Sequence] = None, device="cuda"):
    """The port's (TileSourceTable | None, TileReceiverTable | None) from
    the reference's tables, each given as its four fields in order:
    src = (nnz, coords, sid, scale), rec = (nnz, coords, rid, weight) —
    a reference table NamedTuple itself is such a sequence."""
    dev = resolve_device(device)

    def conv(fields, cls, dtypes):
        if fields is None:
            return None
        return cls(*(torch.as_tensor(np.array(a, dt), device=dev)
                     for a, dt in zip(fields, dtypes)))

    i32, f32 = np.int32, np.float32
    return (conv(src, src_mod.TileSourceTable, (i32, i32, i32, f32)),
            conv(rec, src_mod.TileReceiverTable, (i32, i32, i32, f32)))


def _param_tensor(a, dev) -> torch.Tensor:
    """A numpy parameter as a tensor of the same dtype; a bfloat16 array
    (ml_dtypes' type, which torch does not read) by its bits."""
    a = np.asarray(a)
    if a.dtype.name == "bfloat16":
        return torch.from_numpy(a.view(np.uint16).astype(np.int16)).view(
            torch.bfloat16).to(dev)
    return torch.as_tensor(np.array(a), device=dev)


def _model_params(tree, shapes: dict, cfg: ModelConfig, dev) -> dict:
    """The nested dict `tree` of numpy arrays as tensors on `dev`, each
    with its own dtype; every path's shape checked against `shapes` (keys
    ``a/b/c``)."""
    got = {}

    def conv(node, prefix):
        if isinstance(node, dict):
            return {k: conv(v, f"{prefix}{k}/") for k, v in node.items()}
        t = _param_tensor(node, dev)
        got[prefix[:-1]] = tuple(t.shape)
        return t

    out = conv(tree, "")
    if got != shapes:
        raise ValueError(f"parameters do not fit {cfg.name}: got {got}, "
                         f"expected {shapes}")
    return out


def mamba2_params_from_numpy(tree, cfg: ModelConfig, device="cuda") -> dict:
    """The port's Mamba2 parameters from the reference's, given as numpy
    (``jax.tree.map(np.asarray, params)``): ``embed/embedding``,
    ``blocks/*`` stacked over layers and ``final_norm``, each with its own
    dtype.  Every shape is checked against `cfg` (a random init of the port
    has the same tree)."""
    return _model_params(tree, mamba2.param_shapes(cfg), cfg,
                         resolve_device(device))


def zamba2_params_from_numpy(tree, cfg: ModelConfig, device="cuda") -> dict:
    """The port's zamba2 parameters from the reference's (numpy leaves):
    ``embed``, ``mamba_blocks`` (leaves (n_super, k_every, ...), the
    Mamba2 block's split projections as in `mamba2_params_from_numpy`),
    ``shared`` (``attn_norm``, ``attn``, ``mlp_norm``, ``mlp``) and
    ``final_norm``, shapes checked against `cfg`."""
    return _model_params(tree, zamba2.param_shapes(cfg), cfg,
                         resolve_device(device))


def transformer_params_from_numpy(tree, cfg: ModelConfig,
                                  device="cuda") -> dict:
    """The port's transformer parameters from the reference's (numpy
    leaves), for the dense, moe and vlm families (llava's parameters are
    its backbone's): ``embed``, ``blocks`` (``attn_norm``, ``mlp_norm``,
    ``attn``, and ``mlp`` or, for the moe family, ``moe`` (``router``,
    ``w_gate``, ``w_up``, ``w_down``), stacked over layers) and
    ``final_norm``, shapes checked against `cfg`."""
    return _model_params(tree, transformer.param_shapes(cfg), cfg,
                         resolve_device(device))


def whisper_params_from_numpy(tree, cfg: ModelConfig, device="cuda") -> dict:
    """The port's whisper parameters from the reference's (numpy leaves):
    ``embed``, the position tables ``enc_pos`` and ``dec_pos``,
    ``enc_blocks`` and ``dec_blocks`` (LayerNorms ``w``/``b``, attention,
    the GELU MLP; stacked over layers) and the two final norms.  The
    tables' lengths are the tree's (`api.init`'s shape sets them); every
    other shape is checked against `cfg`."""
    shapes = whisper.param_shapes(cfg, len(tree["enc_pos"]),
                                  len(tree["dec_pos"]))
    return _model_params(tree, shapes, cfg, resolve_device(device))
