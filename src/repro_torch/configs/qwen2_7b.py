"""qwen2-7b — [dense] GQA with QKV bias.  [arXiv:2407.10671; hf]
Port of `repro.configs.qwen2_7b`, values copied."""
from repro_torch.configs.base import ModelConfig

CONFIG = ModelConfig(
    name="qwen2-7b",
    family="dense",
    num_layers=28,
    d_model=3584,
    num_heads=28,
    num_kv_heads=4,
    d_ff=18944,
    vocab_size=152064,
    head_dim=128,
    qkv_bias=True,
    rope_theta=1_000_000.0,
)

REDUCED = ModelConfig(
    name="qwen2-7b-reduced",
    family="dense",
    num_layers=2,
    d_model=64,
    num_heads=4,
    num_kv_heads=2,
    d_ff=128,
    vocab_size=256,
    head_dim=16,
    qkv_bias=True,
)
