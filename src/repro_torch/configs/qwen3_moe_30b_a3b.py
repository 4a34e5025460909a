"""qwen3-moe-30b-a3b — [moe] 128 experts, top-8, fine-grained (d_ff=768
per expert).  [hf:Qwen/Qwen3-30B-A3B; hf]
Port of `repro.configs.qwen3_moe_30b_a3b`, values copied."""
from repro_torch.configs.base import ModelConfig

CONFIG = ModelConfig(
    name="qwen3-moe-30b-a3b",
    family="moe",
    num_layers=48,
    d_model=2048,
    num_heads=32,
    num_kv_heads=4,
    d_ff=0,                     # no shared/dense FFN
    vocab_size=151936,
    head_dim=128,
    qk_norm=True,
    rope_theta=1_000_000.0,
    num_experts=128,
    experts_per_tok=8,
    moe_d_ff=768,
)

REDUCED = ModelConfig(
    name="qwen3-moe-30b-a3b-reduced",
    family="moe",
    num_layers=2,
    d_model=64,
    num_heads=4,
    num_kv_heads=2,
    d_ff=0,
    vocab_size=256,
    head_dim=16,
    qk_norm=True,
    num_experts=8,
    experts_per_tok=2,
    moe_d_ff=32,
)
