"""stablelm-12b — [dense] GQA.  [hf:stabilityai/stablelm-2-1_6b; hf]
Port of `repro.configs.stablelm_12b`, values copied."""
from repro_torch.configs.base import ModelConfig

CONFIG = ModelConfig(
    name="stablelm-12b",
    family="dense",
    num_layers=40,
    d_model=5120,
    num_heads=32,
    num_kv_heads=8,
    d_ff=13824,
    vocab_size=100352,
    head_dim=160,
)

REDUCED = ModelConfig(
    name="stablelm-12b-reduced",
    family="dense",
    num_layers=2,
    d_model=64,
    num_heads=4,
    num_kv_heads=2,
    d_ff=128,
    vocab_size=256,
    head_dim=20,
)
