"""Quickstart on the PyTorch/CUDA port: the paper's scheme in ~40 lines.

Off-the-grid sources -> grid-aligned precompute (SM/SID/src_dcmp) ->
temporally-blocked propagation through the hand-written CUDA kernel (its
plain PyTorch version with --device cpu), checked against the naive
Listing-1 reference.

    PYTHONPATH=src python examples/torch_quickstart.py [--device cpu]
"""
import argparse

import numpy as np
import torch

from repro_torch.core import boundary, sources as S
from repro_torch.core.grid import Grid
from repro_torch.core.temporal_blocking import TBPlan
from repro_torch.kernels import ops, ref

ap = argparse.ArgumentParser()
ap.add_argument("--device", default="cuda", help="cuda (default) or cpu")
dev = ap.parse_args().device

# -- 1. problem setup: two-layer velocity model, one off-the-grid source ----
grid = Grid(shape=(48, 48, 32), spacing=(10.0, 10.0, 10.0))
vp = np.full(grid.shape, 1500.0)
vp[:, :, 16:] = 2500.0
m = torch.as_tensor((1.0 / vp ** 2).astype(np.float32))   # squared slowness
damp = boundary.damping_field(grid.shape, nbl=6, spacing=grid.spacing,
                              device=dev)
dt = grid.cfl_dt(2500.0, order=4)
nt = 24

# source at a coordinate that is NOT a grid point (the paper's subject)
src = S.SparseOperator(np.array([[237.3, 214.9, 61.7]]))
wavelet = S.ricker_wavelet(nt, dt, f0=12.0)

# -- 2. the paper's precompute: align the source to the grid ----------------
g = S.precompute(src, grid, wavelet, device=dev)     # SM, SID, src_dcmp
print(f"source decomposed onto {g.npts} grid points "
      f"(trilinear, paper Fig. 5)")

# receivers (off-the-grid measurement interpolation)
rec = S.SparseOperator(np.array([[100.0, 214.9, 61.7],
                                 [350.0, 214.9, 61.7]]))
gr = S.precompute_receivers(rec, grid, device=dev)

# -- 3. temporally-blocked propagation (the CUDA kernel on a card) ----------
u0 = torch.zeros(grid.shape, dtype=torch.float32)
plan = TBPlan(tile=(16, 16), T=4, radius=2)          # 4 steps per launch
(u_prev, u), recs = ops.acoustic_tb_propagate(
    nt, u0, u0, m, damp, g, gr, plan, order=4, dt=dt, spacing=grid.spacing,
    device=dev)

# -- 4. validate against the naive Listing-1 reference ----------------------
(_, u_ref), recs_ref = ref.acoustic_reference(
    nt, u0, u0, m, damp, dt, grid.spacing, 4, g=g, receivers=gr, device=dev)
err = float((u - u_ref).abs().max())
print(f"TB(T=4) vs reference on {u.device}: max|err| = {err:.2e} "
      f"(field scale {float(u_ref.abs().max()):.2e})")
print(f"receiver traces shape: {tuple(recs.shape)}; "
      f"match: {torch.allclose(recs, recs_ref, atol=1e-5)}")
assert err < 1e-4
print("OK — temporal blocking with off-the-grid sources is exact.")
