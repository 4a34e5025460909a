"""Model and shape configuration (port of `repro.configs.base`).

A copy of the fields the ported families need, so the port imports
nothing of the JAX package: `ModelConfig` with the attention, SSM (Mamba2
/ SSD) and hybrid fields, and `param_count` for the ssm, hybrid and dense
families; and `ShapeConfig`.  Every field has the reference's name and
default.  The MoE, enc-dec and vlm fields, and `active_param_count`, come
with those families (ROADMAP A11).  Configs are frozen and hashable, as in
the reference.
"""
from __future__ import annotations

import dataclasses
from typing import Optional


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
    head_dim: Optional[int] = None
    qk_norm: bool = False
    qkv_bias: bool = False
    rope_theta: float = 10000.0
    norm_eps: float = 1e-5
    tie_embeddings: bool = False
    mlp_type: str = "swiglu"       # swiglu | gelu (classic 2-matrix + bias)

    # --- SSM (Mamba2 / SSD) ---
    ssm_state: int = 0
    ssm_expand: int = 2
    ssm_headdim: int = 64
    ssm_chunk: int = 128
    ssm_conv_width: int = 4
    ssm_ngroups: int = 1

    # --- hybrid (zamba2-style): shared attention block every k SSM layers
    shared_attn_every: int = 0

    # --- numerics ---
    param_dtype: str = "bfloat16"
    activation_dtype: str = "bfloat16"

    def hd(self) -> int:
        return self.head_dim or self.d_model // self.num_heads

    def gqa_groups(self) -> int:
        assert self.num_heads % max(self.num_kv_heads, 1) == 0
        return self.num_heads // max(self.num_kv_heads, 1)

    def param_count(self) -> int:
        """Approximate parameter count N (for MODEL_FLOPS = 6*N*D), the
        reference's, for the ssm, hybrid and dense families (ROADMAP A11
        ports the others).  The hybrid's shared block counts once: its
        weights serve every application."""
        if self.family not in ("ssm", "hybrid", "dense"):
            raise NotImplementedError(
                f"param_count of family {self.family!r} is not ported yet "
                "(ROADMAP A11)")
        D = self.d_model
        H, Hkv = self.num_heads, self.num_kv_heads
        emb = self.vocab_size * D * (1 if self.tie_embeddings else 2)
        if self.family == "ssm":
            return self.num_layers * _mamba2_params(self) + emb
        hd = self.hd()
        attn = D * (H + 2 * Hkv) * hd + H * hd * D
        if self.family == "hybrid":
            shared = attn + 3 * D * self.d_ff + 2 * D
            return self.num_layers * _mamba2_params(self) + shared + emb
        ffn = (2 if self.mlp_type == "gelu" else 3) * D * self.d_ff
        return self.num_layers * (attn + ffn + 2 * D) + emb


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
