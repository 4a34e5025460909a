"""Model, shape and mesh configuration (port of `repro.configs.base`).

A copy, so the port imports nothing of the JAX package: `ModelConfig`
with every family's fields (attention, MoE, SSM (Mamba2 / SSD), hybrid,
enc-dec, vlm), `param_count` and `active_param_count`; `ShapeConfig` and
the benchmark shapes; `MeshConfig` and the reference's two meshes.  Every
field has the reference's name and default.  `remat` is a training field
and comes with training (ROADMAP A11); the reference's TPU figures
(`PEAK_FLOPS_BF16`, `HBM_BW`, `ICI_BW`) are not copied.  Configs are
frozen and hashable, as in the reference.
"""
from __future__ import annotations

import dataclasses
import math
from typing import Optional, Tuple


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

    # --- MoE ---
    num_experts: int = 0
    experts_per_tok: int = 0
    moe_d_ff: int = 0
    capacity_factor: float = 1.25

    # --- SSM (Mamba2 / SSD) ---
    ssm_state: int = 0
    ssm_expand: int = 2
    ssm_headdim: int = 64
    ssm_chunk: int = 128
    ssm_conv_width: int = 4
    ssm_ngroups: int = 1

    # --- hybrid (zamba2-style): shared attention block every k SSM layers
    shared_attn_every: int = 0

    # --- enc-dec (whisper) ---
    num_decoder_layers: int = 0
    max_source_positions: int = 0

    # --- vlm (llava) ---
    num_image_tokens: int = 0      # patch embeddings provided by stub

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
        reference's.  The hybrid's shared block counts once: its weights
        serve every application.  An enc-dec decoder layer adds a
        cross-attention block and a third norm."""
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
        if self.family == "moe":
            ffn = (3 * D * self.moe_d_ff + D) * self.num_experts
        else:
            ffn = (2 if self.mlp_type == "gelu" else 3) * D * self.d_ff
        per = attn + ffn + 2 * D
        if self.family == "encdec":
            per_dec = 2 * attn + ffn + 3 * D
            return (self.num_layers * per
                    + self.num_decoder_layers * per_dec + emb)
        return (self.num_layers + self.num_decoder_layers) * per + emb

    def active_param_count(self) -> int:
        """Active parameters per token (MoE: only the routed experts; the
        router is not counted, as in the reference)."""
        if self.family != "moe":
            return self.param_count()
        D = self.d_model
        H, Hkv, hd = self.num_heads, self.num_kv_heads, self.hd()
        attn = D * (H + 2 * Hkv) * hd + H * hd * D
        ffn = 3 * D * self.moe_d_ff * self.experts_per_tok
        emb = self.vocab_size * D * (1 if self.tie_embeddings else 2)
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


TRAIN_4K = ShapeConfig("train_4k", 4096, 256, "train")
PREFILL_32K = ShapeConfig("prefill_32k", 32768, 32, "prefill")
DECODE_32K = ShapeConfig("decode_32k", 32768, 128, "decode")
LONG_500K = ShapeConfig("long_500k", 524288, 1, "decode")

SHAPES = {s.name: s for s in (TRAIN_4K, PREFILL_32K, DECODE_32K, LONG_500K)}

# long_500k needs sub-quadratic attention: only ssm/hybrid run it
LONG_CONTEXT_FAMILIES = ("ssm", "hybrid")


def shapes_for(cfg: ModelConfig):
    out = [TRAIN_4K, PREFILL_32K, DECODE_32K]
    if cfg.family in LONG_CONTEXT_FAMILIES:
        out.append(LONG_500K)
    return out


@dataclasses.dataclass(frozen=True)
class MeshConfig:
    shape: Tuple[int, ...]
    axes: Tuple[str, ...]

    @property
    def num_devices(self) -> int:
        return math.prod(self.shape)


SINGLE_POD = MeshConfig((16, 16), ("data", "model"))
MULTI_POD = MeshConfig((2, 16, 16), ("pod", "data", "model"))
