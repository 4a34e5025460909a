"""Checkpoints (port of `repro.checkpoint`)."""
from repro_torch.checkpoint.manager import (  # noqa: F401
    CheckpointManager, load_metadata, load_pytree, save_pytree)
