"""repro_torch — the PyTorch/CUDA port of `repro` for NVIDIA Hopper.

Module names follow `src/repro/`, so each file names its reference.  The
package imports `torch` and `numpy` only, never `jax` or `repro`.  Entry
points take ``device=`` and default to ``"cuda"``; without a card they
raise unless the caller asks for ``device="cpu"``.  On a CUDA tensor a
kernel wrapper launches its hand-written kernel or raises; on a CPU tensor
it runs the kernel's plain PyTorch version.
"""
from repro_torch._device import resolve_device  # noqa: F401
