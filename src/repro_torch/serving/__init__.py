"""repro_torch.serving — batched greedy generation (port of
`repro.serving`)."""
from repro_torch.serving.engine import GenerationEngine, Request  # noqa: F401
