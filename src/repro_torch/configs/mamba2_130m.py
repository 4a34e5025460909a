"""mamba2-130m — [ssm] SSD (state-space duality), attention-free.
[arXiv:2405.21060; unverified]  Port of `repro.configs.mamba2_130m`,
values copied."""
from repro_torch.configs.base import ModelConfig

CONFIG = ModelConfig(
    name="mamba2-130m",
    family="ssm",
    num_layers=24,
    d_model=768,
    num_heads=0,                # attention-free
    num_kv_heads=0,
    d_ff=0,
    vocab_size=50280,
    ssm_state=128,
    ssm_expand=2,
    ssm_headdim=64,             # d_inner=1536 -> 24 SSD heads
    ssm_chunk=64,
    ssm_conv_width=4,
    ssm_ngroups=1,
    tie_embeddings=True,
)

REDUCED = ModelConfig(
    name="mamba2-130m-reduced",
    family="ssm",
    num_layers=2,
    d_model=64,
    num_heads=0,
    num_kv_heads=0,
    d_ff=0,
    vocab_size=256,
    ssm_state=16,
    ssm_expand=2,
    ssm_headdim=16,
    ssm_chunk=8,
    ssm_conv_width=4,
    ssm_ngroups=1,
    tie_embeddings=True,
)
