"""qwen3-1.7b — [dense] qk-norm, GQA, tied embeddings.
[hf:Qwen/Qwen3-8B; hf]
Port of `repro.configs.qwen3_1p7b`, values copied."""
from repro_torch.configs.base import ModelConfig

CONFIG = ModelConfig(
    name="qwen3-1.7b",
    family="dense",
    num_layers=28,
    d_model=2048,
    num_heads=16,
    num_kv_heads=8,
    d_ff=6144,
    vocab_size=151936,
    head_dim=128,
    qk_norm=True,
    rope_theta=1_000_000.0,
    tie_embeddings=True,
)

REDUCED = ModelConfig(
    name="qwen3-1.7b-reduced",
    family="dense",
    num_layers=2,
    d_model=64,
    num_heads=4,
    num_kv_heads=2,
    d_ff=128,
    vocab_size=256,
    head_dim=16,
    qk_norm=True,
    tie_embeddings=True,
)
