"""zamba2-2.7b — [hybrid] Mamba2 backbone + shared attention block every 6
layers (weights reused per application).  [arXiv:2411.15242; hf]
Port of `repro.configs.zamba2_2p7b`, values copied."""
from repro_torch.configs.base import ModelConfig

CONFIG = ModelConfig(
    name="zamba2-2.7b",
    family="hybrid",
    num_layers=54,
    d_model=2560,
    num_heads=32,
    num_kv_heads=32,            # MHA in the shared block
    d_ff=10240,
    vocab_size=32000,
    head_dim=80,
    ssm_state=64,
    ssm_expand=2,
    ssm_headdim=64,             # d_inner=5120 -> 80 SSD heads
    ssm_chunk=128,
    ssm_conv_width=4,
    ssm_ngroups=1,
    shared_attn_every=6,        # 9 shared-attention applications
)

REDUCED = ModelConfig(
    name="zamba2-2.7b-reduced",
    family="hybrid",
    num_layers=4,
    d_model=64,
    num_heads=4,
    num_kv_heads=4,
    d_ff=128,
    vocab_size=256,
    head_dim=16,
    ssm_state=16,
    ssm_expand=2,
    ssm_headdim=16,
    ssm_chunk=8,
    ssm_conv_width=4,
    ssm_ngroups=1,
    shared_attn_every=2,
)
