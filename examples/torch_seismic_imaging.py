"""End-to-end seismic forward modelling on the PyTorch/CUDA port (the
paper's application).

Models a shot: a Ricker source injected into a 3-layer subsurface model,
wavefield propagated with (a) the naive Listing-1 reference and (b) the
temporally-blocked scheme through the hand-written CUDA kernel (its plain
PyTorch version with --device cpu); records a receiver line (shot
gather), checks they agree, and reports the plan model's device-memory
traffic for both schedules.

    PYTHONPATH=src python examples/torch_seismic_imaging.py [--n 64] \\
        [--ms 48] [--device cpu]
"""
import argparse
import time

import numpy as np
import torch

from repro_torch.core import boundary, sources as S
from repro_torch.core.grid import Grid
from repro_torch.core.propagators import acoustic
from repro_torch.core.temporal_blocking import (PHYSICS_COSTS,
                                                autotune_plan)
from repro_torch.kernels import ops


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--n", type=int, default=64)
    ap.add_argument("--ms", type=float, default=48.0)
    ap.add_argument("--order", type=int, default=4)
    ap.add_argument("--device", default="cuda", help="cuda (default) or cpu")
    args = ap.parse_args()

    n, order, dev = args.n, args.order, torch.device(args.device)
    shape = (n, n, n // 2)
    grid = Grid(shape=shape, spacing=(10.0, 10.0, 10.0))

    def sync():
        if dev.type == "cuda":
            torch.cuda.synchronize(dev)

    # 3-layer subsurface model
    vp = np.full(shape, 1500.0)
    vp[:, :, shape[2] // 3:] = 2200.0
    vp[:, :, 2 * shape[2] // 3:] = 3000.0
    m = torch.as_tensor((1.0 / vp ** 2).astype(np.float32))
    damp = boundary.damping_field(shape, nbl=8, spacing=grid.spacing,
                                  free_surface_axis=2, device=dev)
    dt = grid.cfl_dt(3000.0, order)
    nt = max(int(args.ms / 1000.0 / dt), 8)
    print(f"grid {shape}, dt={dt*1e3:.2f}ms, nt={nt}")

    # shot geometry: source near the surface, receiver line across the top
    ext = np.asarray(grid.extent)
    src = S.SparseOperator(np.array([[ext[0] / 2, ext[1] / 2, 24.0]]))
    wav = S.ricker_wavelet(nt, dt, f0=15.0)
    g = S.precompute(src, grid, wav, device=dev)
    nrec = 16
    rec_x = np.linspace(40.0, ext[0] - 40.0, nrec)
    rec = S.SparseOperator(
        np.stack([rec_x, np.full(nrec, ext[1] / 2), np.full(nrec, 16.0)],
                 axis=1))
    gr = S.precompute_receivers(rec, grid, device=dev)

    # --- reference: the naive Listing-1 loop -------------------------------
    state = acoustic.init_state(shape, device=dev)
    params = acoustic.AcousticParams(m=m.to(dev), damp=damp)
    sync()
    t0 = time.perf_counter()
    ref_final, ref_recs = acoustic.propagate(nt, state, params, g, dt, grid,
                                             order, receivers=gr)
    sync()
    t_ref = time.perf_counter() - t0

    # --- temporally blocked (the paper's scheme, the CUDA kernel) ----------
    plan, _ = autotune_plan(nz=shape[2], radius=order // 2,
                            tiles=(16, 32), depths=(2, 4))
    ac_fields = PHYSICS_COSTS["acoustic"].fields
    print(f"autotuned plan: tile={plan.tile} T={plan.T} "
          f"(window {plan.vmem_bytes(shape[2], ac_fields)/2**20:.1f} MiB)")
    u0 = torch.zeros(shape, dtype=torch.float32)
    sync()
    t0 = time.perf_counter()
    (tb0, tb1), tb_recs = ops.acoustic_tb_propagate(
        nt, u0, u0, m, damp, g, gr, plan, order, dt, grid.spacing,
        device=dev)
    sync()
    t_tb = time.perf_counter() - t0

    err = float((tb1 - ref_final.u).abs().max())
    scale = float(ref_final.u.abs().max())
    print(f"wavefield agreement: max|err|={err:.3e} (scale {scale:.3e})")
    assert err <= 5e-4 * scale + 1e-6

    # shot gather summary
    gather = tb_recs.cpu().numpy()
    print(f"shot gather: {gather.shape} (nt x nrec), "
          f"peak amp {np.abs(gather).max():.3e}")
    first_break = np.argmax(np.abs(gather) > 0.01 * np.abs(gather).max(),
                            axis=0)
    print("first-break sample per receiver:", first_break.tolist())

    # the plan model's traffic (a model of the schedule, not a measurement)
    naive_bpp = acoustic.hbm_bytes_per_step((1, 1, 1))
    tb_bpp = plan.hbm_bytes_per_point_step(shape[2])
    print(f"modelled device-memory bytes/point/step: naive={naive_bpp:.1f} "
          f"TB={tb_bpp:.2f} ({naive_bpp / tb_bpp:.2f}x reduction, "
          f"overlap factor {plan.overlap_factor():.3f})")
    print(f"wall times on {dev} (first calls, builds included on a card): "
          f"reference {t_ref:.2f} s, TB {t_tb:.2f} s")
    print("OK")


if __name__ == "__main__":
    main()
