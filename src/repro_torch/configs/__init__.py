"""Config registry (port of `repro.configs`): the reference's ten language
model architectures.  `get(name)` / `get_reduced(name)` / `ARCHS` are the
public API; the paper's stencil cases are in `configs.paper_stencil`."""
from __future__ import annotations

from repro_torch.configs import (
    dbrx_132b, granite_34b, llava_next_mistral_7b, mamba2_130m, qwen2_7b,
    qwen3_1p7b, qwen3_moe_30b_a3b, stablelm_12b, whisper_medium,
    zamba2_2p7b)
from repro_torch.configs.base import (  # noqa: F401
    DECODE_32K, LONG_500K, MULTI_POD, PREFILL_32K, SHAPES, SINGLE_POD,
    TRAIN_4K, MeshConfig, ModelConfig, ShapeConfig, shapes_for)

_MODULES = {
    "llava-next-mistral-7b": llava_next_mistral_7b,
    "granite-34b": granite_34b,
    "qwen3-1.7b": qwen3_1p7b,
    "qwen2-7b": qwen2_7b,
    "stablelm-12b": stablelm_12b,
    "mamba2-130m": mamba2_130m,
    "qwen3-moe-30b-a3b": qwen3_moe_30b_a3b,
    "dbrx-132b": dbrx_132b,
    "zamba2-2.7b": zamba2_2p7b,
    "whisper-medium": whisper_medium,
}

ARCHS = tuple(_MODULES)

# the reference's architectures (repro.configs.ARCHS) not ported yet: none
UNPORTED = ()


def _module(name: str):
    if name not in _MODULES:
        raise KeyError(f"unknown arch {name!r}; known: {sorted(_MODULES)}")
    return _MODULES[name]


def get(name: str) -> ModelConfig:
    return _module(name).CONFIG


def get_reduced(name: str) -> ModelConfig:
    return _module(name).REDUCED
