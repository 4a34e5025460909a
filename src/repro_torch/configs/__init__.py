"""Config registry (port of `repro.configs`): the architectures the port
runs.  `get(name)` / `get_reduced(name)` / `ARCHS` are the public API; an
architecture of the reference that is not ported yet raises `KeyError`
naming ROADMAP A11."""
from __future__ import annotations

from repro_torch.configs import (
    granite_34b, mamba2_130m, qwen2_7b, qwen3_1p7b, stablelm_12b,
    zamba2_2p7b)
from repro_torch.configs.base import ModelConfig, ShapeConfig  # noqa: F401

_MODULES = {
    "granite-34b": granite_34b,
    "qwen3-1.7b": qwen3_1p7b,
    "qwen2-7b": qwen2_7b,
    "stablelm-12b": stablelm_12b,
    "mamba2-130m": mamba2_130m,
    "zamba2-2.7b": zamba2_2p7b,
}

# the reference's other architectures (repro.configs.ARCHS), not ported yet
UNPORTED = ("llava-next-mistral-7b", "qwen3-moe-30b-a3b", "dbrx-132b",
            "whisper-medium")

ARCHS = tuple(_MODULES)


def _module(name: str):
    if name in UNPORTED:
        raise KeyError(f"arch {name!r} is not ported to repro_torch yet "
                       "(ROADMAP A11); ported: " + ", ".join(ARCHS))
    if name not in _MODULES:
        raise KeyError(f"unknown arch {name!r}; known: {sorted(_MODULES)}")
    return _MODULES[name]


def get(name: str) -> ModelConfig:
    return _module(name).CONFIG


def get_reduced(name: str) -> ModelConfig:
    return _module(name).REDUCED
