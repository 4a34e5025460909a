"""Device resolution shared by every entry point of the port."""
from __future__ import annotations

import numpy as np
import torch


def resolve_device(device="cuda") -> torch.device:
    """The torch device an entry point runs on.

    ``"cuda"`` (the default everywhere) requires a card and raises
    `RuntimeError` without one: there is no CPU fallback.  The CPU runs
    only when the caller asks for it (``device="cpu"``), as the tests do.
    ``"meta"`` holds shapes and dtypes only, no data: the specs of
    `models.api` (`param_specs`, `cache_specs`) are built there.
    """
    dev = torch.device(device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            f"device {str(device)!r} requested but torch.cuda.is_available() "
            "is False; pass device='cpu' to run on the CPU")
    if dev.type not in ("cuda", "cpu", "meta"):
        raise ValueError(f"unsupported device {str(device)!r}")
    return dev


def as_tensor(x, device: torch.device, dtype=None) -> torch.Tensor:
    """`x` (numpy array or tensor) as a tensor on `device`.  A read-only
    numpy array is copied first (torch tensors are always writable)."""
    if isinstance(x, np.ndarray) and not x.flags.writeable:
        x = x.copy()
    return torch.as_tensor(x, dtype=dtype, device=device)
