"""granite-34b — [dense] llama-arch code model, MQA (kv=1).
[arXiv:2405.04324; hf]
Port of `repro.configs.granite_34b`, values copied."""
from repro_torch.configs.base import ModelConfig

CONFIG = ModelConfig(
    name="granite-34b",
    family="dense",
    num_layers=88,
    d_model=6144,
    num_heads=48,
    num_kv_heads=1,             # MQA
    d_ff=24576,
    vocab_size=49152,
    head_dim=128,
    mlp_type="gelu",            # GPT-BigCode lineage: 2-matrix MLP
)

REDUCED = ModelConfig(
    name="granite-34b-reduced",
    family="dense",
    num_layers=3,
    d_model=64,
    num_heads=4,
    num_kv_heads=1,
    d_ff=128,
    vocab_size=256,
    head_dim=16,
    mlp_type="gelu",
)
