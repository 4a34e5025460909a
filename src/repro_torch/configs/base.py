"""Model and shape configuration (port of `repro.configs.base`).

A copy of the fields the ported families need, so the port imports
nothing of the JAX package: `ModelConfig` with the SSM (Mamba2 / SSD)
fields and `param_count` for the ssm family, and `ShapeConfig`.  Configs
are frozen and hashable, as in the reference.
"""
from __future__ import annotations

import dataclasses


@dataclasses.dataclass(frozen=True)
class ModelConfig:
    name: str
    family: str                    # dense | moe | ssm | hybrid | encdec | vlm
    num_layers: int
    d_model: int
    num_heads: int
    num_kv_heads: int
    d_ff: int
    vocab_size: int
    norm_eps: float = 1e-5
    tie_embeddings: bool = False

    # --- SSM (Mamba2 / SSD) ---
    ssm_state: int = 0
    ssm_expand: int = 2
    ssm_headdim: int = 64
    ssm_chunk: int = 128
    ssm_conv_width: int = 4
    ssm_ngroups: int = 1

    # --- numerics ---
    param_dtype: str = "bfloat16"
    activation_dtype: str = "bfloat16"

    def param_count(self) -> int:
        """Approximate parameter count N (for MODEL_FLOPS = 6*N*D); the
        ssm family only (ROADMAP A11 ports the others)."""
        if self.family != "ssm":
            raise NotImplementedError(
                f"param_count of family {self.family!r} is not ported yet "
                "(ROADMAP A11)")
        emb = self.vocab_size * self.d_model * (
            1 if self.tie_embeddings else 2)
        return self.num_layers * _mamba2_params(self) + emb


def _mamba2_params(cfg: ModelConfig) -> int:
    D = cfg.d_model
    d_inner = cfg.ssm_expand * D
    nheads = d_inner // cfg.ssm_headdim
    N = cfg.ssm_state
    in_proj = D * (2 * d_inner + 2 * cfg.ssm_ngroups * N + nheads)
    conv = cfg.ssm_conv_width * (d_inner + 2 * cfg.ssm_ngroups * N)
    out_proj = d_inner * D
    return in_proj + conv + out_proj + 3 * nheads + 2 * D


@dataclasses.dataclass(frozen=True)
class ShapeConfig:
    """One benchmark cell's input geometry."""

    name: str
    seq_len: int
    global_batch: int
    kind: str                      # train | prefill | decode

    @property
    def is_decode(self) -> bool:
        return self.kind == "decode"
