"""whisper-medium — [audio] encoder-decoder, conv frontend STUBBED
(the batch provides frame embeddings).  24 encoder + 24 decoder layers.
[arXiv:2212.04356; unverified]
Port of `repro.configs.whisper_medium`, values copied."""
from repro_torch.configs.base import ModelConfig

CONFIG = ModelConfig(
    name="whisper-medium",
    family="encdec",
    num_layers=24,              # encoder layers
    num_decoder_layers=24,
    d_model=1024,
    num_heads=16,
    num_kv_heads=16,            # MHA
    d_ff=4096,
    vocab_size=51865,
    head_dim=64,
    tie_embeddings=True,        # whisper ties decoder embed / proj
    mlp_type="gelu",
    max_source_positions=1500,  # nominal; dry-run sizes tables per shape
)

REDUCED = ModelConfig(
    name="whisper-medium-reduced",
    family="encdec",
    num_layers=2,
    num_decoder_layers=2,
    d_model=64,
    num_heads=4,
    num_kv_heads=4,
    d_ff=128,
    vocab_size=256,
    head_dim=16,
    tie_embeddings=True,
    max_source_positions=64,
)
