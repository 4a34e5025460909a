"""repro_torch.core — grid-aligned precomputation of sparse off-the-grid
operators, FD operators and the Listing-1 propagators (port of
`repro.core`)."""
from repro_torch.core.grid import Grid  # noqa: F401
from repro_torch.core import (boundary, sources, stencil,  # noqa: F401
                              temporal_blocking)
from repro_torch.core.propagators import acoustic  # noqa: F401
