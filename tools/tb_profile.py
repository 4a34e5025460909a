"""Split one TB kernel launch's device time by CUDA kernel, on the card:

    python3 tools/tb_profile.py [--physics acoustic,tti,elastic] [--T 4]

At the paper's 512^3 shapes (tile 32, order 4, no sources) it runs each
physics' launch (`stencil_tb.tb_time_tile`, with the params' copies made
once beforehand, as a propagation makes them) a few times under
`torch.profiler` and prints, per CUDA kernel name (the z-major copies
`to_zmajor` and the time-tile kernel), its device time per launch and
share, beside the launch's wall time by CUDA events.  Needs a card.
"""
import argparse
import sys
from pathlib import Path

import torch

sys.path.insert(0, str(Path(__file__).resolve().parents[1] / "src"))

from repro_torch.core.temporal_blocking import TBPlan  # noqa: E402
from repro_torch.kernels import ops, stencil_tb as ker  # noqa: E402
from repro_torch.kernels import tb_physics as phys  # noqa: E402

SHAPE = (512, 512, 512)
VAL = {"m": 2.5e-7, "damp": 0.0, "epsilon": 0.1, "delta": 0.05,
       "theta": 0.2, "phi": 0.3, "lam": 8e9, "mu": 6e9, "b": 4.8e-4}


def launch_args(name, T, dev):
    p = phys.PHYSICS[name]
    plan = TBPlan((32, 32), T, p.step_radius(4))
    gen = torch.Generator(device=dev).manual_seed(0)
    state = tuple(torch.randn(SHAPE, generator=gen, device=dev) * 0.01
                  for _ in p.state_fields)
    params = {f: torch.full(SHAPE, VAL[f], device=dev)
              for f in p.param_fields}
    spec, st, rt, ppads = ops.prepare_tiles(plan, p, state[0], params, None,
                                            None, 4, 1e-3, (10.0,) * 3)
    pads, sc, sv, rc, rw = ops.tile_operands(
        spec, tuple(f[None] for f in state), None, st, rt, 0)
    return p, spec, (pads, ppads, sc, sv, rc, rw)


def main(argv):
    ap = argparse.ArgumentParser()
    ap.add_argument("--physics", default="acoustic,tti,elastic")
    ap.add_argument("--T", type=int, default=4)
    ap.add_argument("--reps", type=int, default=3)
    args = ap.parse_args(argv)
    dev = torch.device("cuda")
    for name in args.physics.split(","):
        p, spec, kargs = launch_args(name, args.T, dev)
        copies = ker.param_copies(spec, p, kargs[1])
        launch = lambda: ker.tb_time_tile(  # noqa: E731
            spec, p, *kargs, param_copies=copies)
        launch()
        torch.cuda.synchronize()
        s, e = (torch.cuda.Event(enable_timing=True) for _ in range(2))
        s.record()
        for _ in range(args.reps):
            launch()
        e.record()
        torch.cuda.synchronize()
        ms = s.elapsed_time(e) / args.reps
        acts = [torch.profiler.ProfilerActivity.CPU,
                torch.profiler.ProfilerActivity.CUDA]
        with torch.profiler.profile(activities=acts) as prof:
            for _ in range(args.reps):
                launch()
            torch.cuda.synchronize()
        rows = []
        for ev in prof.key_averages():
            t = getattr(ev, "device_time_total", None)
            if t is None:
                t = getattr(ev, "cuda_time_total", 0)
            if t > 0 and ev.device_type == torch.autograd.DeviceType.CUDA:
                rows.append((t / 1e3 / args.reps, ev.count // args.reps,
                             ev.key))
        total = sum(r[0] for r in rows)
        print(f"{name} T={args.T} tile (32, 32) at {SHAPE}: {ms:.3f} ms a "
              f"launch (CUDA events); plan {ker.launch_plan(spec, p)}",
              flush=True)
        for t, n, key in sorted(rows, reverse=True):
            print(f"  {t:9.3f} ms  {100 * t / max(total, 1e-9):5.1f}%  "
                  f"x{n}  {key[:90]}", flush=True)
        del kargs, copies
        torch.cuda.empty_cache()


if __name__ == "__main__":
    main(sys.argv[1:])
