"""llava-next-mistral-7b — [vlm] anyres tiling, Mistral-7B backbone.
[hf:llava-hf/llava-v1.6-mistral-7b-hf; unverified]
Port of `repro.configs.llava_next_mistral_7b`, values copied."""
from repro_torch.configs.base import ModelConfig

CONFIG = ModelConfig(
    name="llava-next-mistral-7b",
    family="vlm",
    num_layers=32,
    d_model=4096,
    num_heads=32,
    num_kv_heads=8,
    d_ff=14336,
    vocab_size=32000,
    head_dim=128,
    rope_theta=1_000_000.0,
    num_image_tokens=2880,      # anyres: 5 tiles x 576 patches (stubbed)
)

REDUCED = ModelConfig(
    name="llava-next-mistral-7b-reduced",
    family="vlm",
    num_layers=2,
    d_model=64,
    num_heads=4,
    num_kv_heads=2,
    d_ff=128,
    vocab_size=256,
    head_dim=16,
    num_image_tokens=8,
)
