"""Multi-shot survey launcher over the single-device TB stack (port of
`repro.launch.stencil_survey`).

Builds a synthetic survey (shot geometries drawn with varying source /
receiver counts so several buckets exercise the shape bounding) over a
random-velocity model, runs it through `survey.SurveyEngine`, and reports
throughput plus the plan-cache / per-bucket-build statistics.  With
``--check`` every batched trace is compared against a sequential
`kernels.ops.*_tb_propagate` call for the same shot.

  # 6-shot acoustic survey on the CPU (the kernels' plain versions),
  # 2-shot batches, with parity:
  python -m repro_torch.launch.stencil_survey --device cpu --physics \\
      acoustic --shots 6 --bucket-cap 2 --check

  # on the card (the CUDA kernels):
  python -m repro_torch.launch.stencil_survey --shots 4 --check

Exit codes: 0 ok / parity pass, 1 parity fail.
"""
import argparse
import json
import os
import sys

# each receiver channel of a batched trace against the sequential one:
# max|diff| <= CHECK_RTOL * max|sequential| (the batched launch computes
# the same fields; the receiver sums may add in another order on a card)
CHECK_RTOL = 1e-5


def build_survey(grid, dt, nt, num_shots, rng):
    """Shots with heterogeneous (nsrc, nrec) so bucketing has work to do
    (the reference's draws, in order)."""
    import numpy as np

    from repro_torch.core import sources as S
    from repro_torch.survey import Shot

    ext = np.asarray(grid.extent)
    shots = []
    for i in range(num_shots):
        nsrc = 1 + (i % 3)
        nrec = 3 + 2 * (i % 2)
        shots.append(Shot(
            src_coords=5.0 + rng.rand(nsrc, 3) * (ext - 10.0),
            wavelet=S.ricker_wavelet(nt, dt, f0=12.0, num=nsrc),
            rec_coords=5.0 + rng.rand(nrec, 3) * (ext - 10.0),
            shot_id=i))
    return shots


def build_model(physics_name, shape, grid, rng, device="cuda"):
    """params dict for `tb_physics.PHYSICS[physics_name]` on `device`, from
    the reference's draws.  Elastic moduli are in SI units (the reference
    scales them by 1e-6, under which a velocity's stress term lies below
    its float32 rounding)."""
    import numpy as np
    import torch

    from repro_torch._device import resolve_device
    from repro_torch.core import boundary

    dev = resolve_device(device)

    def f32(a):
        return torch.as_tensor(np.asarray(a, np.float32), device=dev)

    vp = 1500.0 + 1000.0 * rng.rand(*shape)
    damp = boundary.damping_field(shape, nbl=3, spacing=grid.spacing,
                                  device=dev)
    if physics_name == "acoustic":
        return {"m": f32(1.0 / vp ** 2), "damp": damp}
    if physics_name == "tti":
        return {"m": f32(1.0 / vp ** 2), "damp": damp,
                "epsilon": f32(0.2 * rng.rand(*shape)),
                "delta": f32(0.1 * rng.rand(*shape)),
                "theta": f32(0.3 * rng.randn(*shape)),
                "phi": f32(0.3 * rng.randn(*shape))}
    if physics_name == "elastic":
        rho = 2000.0 + 100.0 * rng.rand(*shape)
        vs = vp / 1.9
        return {"lam": f32(rho * (vp ** 2 - 2 * vs ** 2)),
                "mu": f32(rho * vs ** 2),
                "b": f32(1.0 / rho), "damp": damp}
    raise ValueError(f"unknown physics {physics_name!r}")


def sequential_shot(physics_name, shot, grid, params, plan, order, dt, nt,
                    interp=None, device="cuda"):
    """One `*_tb_propagate` call for `shot`: (final state tuple, traces
    (nt, nrec) or (nt, nrec, 2) for elastic) on `device` — the batching
    oracle.  `interp` is the `core.interp.InterpSpec` the engine under test
    uses (None = default multilinear)."""
    import torch

    from repro_torch.core import interp as interp_mod
    from repro_torch.core import sources as S
    from repro_torch.core.propagators import elastic as el
    from repro_torch.core.propagators import tti as tt
    from repro_torch.kernels import ops as ops_mod
    from repro_torch.kernels import tb_physics as phys

    interp = interp_mod.LINEAR if interp is None else interp
    shape = tuple(grid.shape)
    g = S.precompute(S.SparseOperator(shot.src_coords), grid, shot.wavelet,
                     interp=interp, device=device)
    gr = S.precompute_receivers(S.SparseOperator(shot.rec_coords), grid,
                                interp=interp, device=device)
    zero = tuple(torch.zeros(shape, dtype=torch.float32, device=g.points
                             .device)
                 for _ in phys.PHYSICS[physics_name].state_fields)
    if physics_name == "acoustic":
        final, rec = ops_mod.acoustic_tb_propagate(
            nt, *zero, params["m"], params["damp"], g, gr, plan, order, dt,
            grid.spacing, device=device)
    elif physics_name == "tti":
        final, rec = ops_mod.tti_tb_propagate(
            nt, tt.TTIState(*zero), tt.TTIParams(**params), g, gr, plan,
            order, dt, grid.spacing, device=device)
    else:
        final, rec = ops_mod.elastic_tb_propagate(
            nt, el.ElasticState(*zero), el.ElasticParams(**params), g, gr,
            plan, order, dt, grid.spacing, device=device)
    return tuple(final), rec


def sequential_traces(physics_name, shots, grid, params, plan, order, dt, nt,
                      interp=None, device="cuda"):
    """K independent `*_tb_propagate` calls — the batching oracle; traces
    as host numpy arrays."""
    return [sequential_shot(physics_name, s, grid, params, plan, order, dt,
                            nt, interp=interp, device=device)[1].cpu()
            .numpy() for s in shots]


def channel_errors(got, want):
    """max|got - want| / max|want| per receiver channel (0 where both are
    all zero, inf where only `want` is)."""
    import numpy as np

    got = np.asarray(got, np.float64)
    want = np.asarray(want, np.float64)
    if want.ndim == 2:
        got, want = got[..., None], want[..., None]
    errs = []
    for c in range(want.shape[-1]):
        diff = float(np.abs(got[..., c] - want[..., c]).max()) \
            if want.size else 0.0
        scale = float(np.abs(want[..., c]).max()) if want.size else 0.0
        errs.append(diff / scale if scale > 0
                    else (0.0 if diff == 0 else float("inf")))
    return errs


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--physics", default="acoustic",
                    choices=("acoustic", "tti", "elastic"))
    ap.add_argument("--shots", type=int, default=4,
                    help="number of synthetic shots in the survey")
    ap.add_argument("--bucket-cap", type=int, default=2, dest="bucket_cap",
                    help="shots per batch (partial batches pad with silent "
                         "null shots)")
    ap.add_argument("--device", default="cuda",
                    help="where the survey runs: cuda (the CUDA kernels) "
                         "or cpu (their plain versions)")
    ap.add_argument("--interp", default="linear",
                    choices=("linear", "sinc"),
                    help="source/receiver interpolation kernel: trilinear "
                         "or Kaiser-windowed sinc (Hicks 2002)")
    ap.add_argument("--interp-order", type=int, default=None,
                    dest="interp_order",
                    help="sinc support radius r (table caps scale as "
                         "(2r)**3 * n; default 1 linear / 4 sinc)")
    ap.add_argument("--n", type=int, default=24)
    ap.add_argument("--nt", type=int, default=8)
    ap.add_argument("--order", type=int, default=4)
    ap.add_argument("--check", action="store_true",
                    help="compare every batched trace against a sequential "
                         "*_tb_propagate call")
    ap.add_argument("--telemetry", nargs="?", const="", default=None,
                    metavar="PATH",
                    help="enable telemetry spans (sweep/compile/dispatch/"
                         "readback) and export the Chrome trace to PATH "
                         "(default results/telemetry_survey_torch.json)")
    args = ap.parse_args()

    import numpy as np

    from repro_torch import telemetry as tele
    from repro_torch.core import interp as interp_mod
    from repro_torch.core.grid import Grid
    from repro_torch.survey import PlanCache, SurveyEngine

    telemetry_path = None
    if args.telemetry is not None:
        tele.enable()
        telemetry_path = args.telemetry or os.path.join(
            "results", "telemetry_survey_torch.json")

    n, nt, order = args.n, args.nt, args.order
    shape = (n, n, n // 2)
    grid = Grid(shape=shape, spacing=(10.0,) * 3)
    dt = grid.cfl_dt(3000.0, order)
    rng = np.random.RandomState(0)
    params = build_model(args.physics, shape, grid, rng, device=args.device)
    shots = build_survey(grid, dt, nt, args.shots, rng)

    spec = interp_mod.spec_for(args.interp, args.interp_order)
    cache = PlanCache()
    engine = SurveyEngine(args.physics, grid, params, nt, dt, order=order,
                          plan_cache=cache, bucket_cap=args.bucket_cap,
                          interp=spec, device=args.device)
    result = engine.run(shots)
    print("survey stats:", json.dumps(result.stats))
    print(f"survey {args.physics} x{args.shots} shots on {engine.device} "
          f"({result.stats['buckets']} buckets, "
          f"{result.stats['batches']} batches, "
          f"executor={engine.executor}): "
          f"{result.stats['shots_per_s']:.3f} shots/s, "
          f"{result.stats['mpoints_per_s']:.3f} Mpt/s "
          f"(warm {result.stats['warm_seconds']:.3f}s / "
          f"cold {result.stats['cold_seconds']:.3f}s), "
          f"{cache.sweeps} autotune sweep(s)")

    if telemetry_path:
        print("telemetry trace:", tele.collector().export(telemetry_path))

    if args.check:
        seq = sequential_traces(args.physics, shots, grid, params,
                                engine.plan, order, dt, nt, interp=spec,
                                device=args.device)
        ok = True
        for i, (batched, ref) in enumerate(zip(result.traces, seq)):
            errs = channel_errors(batched, ref)
            good = batched.shape == ref.shape and max(errs) <= CHECK_RTOL
            print(f"shot {i}: max|diff|/max|ref| per channel "
                  + ", ".join(f"{e:.3e}" for e in errs)
                  + f" (limit {CHECK_RTOL:g})")
            ok = ok and good
        print("CHECK", "PASS" if ok else "FAIL")
        return 0 if ok else 1
    return 0


if __name__ == "__main__":
    sys.exit(main())
