"""The optimizer (port of `repro.optim`)."""
from repro_torch.optim.adamw import (  # noqa: F401
    AdamWConfig, AdamWState, adamw_init, adamw_update, global_norm,
    cosine_schedule, zero1_init, zero1_update)
