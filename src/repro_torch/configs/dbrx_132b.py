"""dbrx-132b — [moe] 16 experts, top-4, fine-grained.
[hf:databricks/dbrx-base; unverified]
Port of `repro.configs.dbrx_132b`, values copied."""
from repro_torch.configs.base import ModelConfig

CONFIG = ModelConfig(
    name="dbrx-132b",
    family="moe",
    num_layers=40,
    d_model=6144,
    num_heads=48,
    num_kv_heads=8,
    d_ff=0,
    vocab_size=100352,
    head_dim=128,
    rope_theta=500_000.0,
    num_experts=16,
    experts_per_tok=4,
    moe_d_ff=10752,
)

REDUCED = ModelConfig(
    name="dbrx-132b-reduced",
    family="moe",
    num_layers=2,
    d_model=64,
    num_heads=4,
    num_kv_heads=2,
    d_ff=0,
    vocab_size=256,
    head_dim=16,
    num_experts=4,
    experts_per_tok=2,
    moe_d_ff=32,
)
