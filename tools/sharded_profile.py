"""Where the sharded path's time goes on the card: the paper's 512^3
acoustic case (`chip_smoke.full_case`) for `--tiles` depth-4 time tiles,
once on one device (`ops.acoustic_tb_propagate`) and once on a 2x2
`ShardMesh` of shards on the card (`distributed.halo`), each under
`torch.profiler` after a warm-up run.

    python3 tools/sharded_profile.py [--tiles 12]

Prints, per run: the wall time (host clock around the run and a
synchronise), the device time summed over every kernel, copy and fill the
profiler saw on the card, the device's idle share of the wall time, and
the device events with the most time.  Needs a card.
"""
import argparse
import sys
import time
from pathlib import Path

import torch

ROOT = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT))
sys.path.insert(0, str(ROOT / "src"))

import chip_smoke as cs  # noqa: E402
from repro_torch.distributed import halo as H  # noqa: E402


def profiled(fn, top=12):
    """(wall ms, device ms, rows) of fn() under torch.profiler; rows are
    (name, device ms, calls) with the most device time first."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    fn()                                   # warm-up: builds, allocator
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        wall = (time.perf_counter() - t0) * 1e3
    # the device's own events (kernels, copies, fills): an operator's
    # entry would count its kernels' time a second time
    events = [e for e in prof.key_averages()
              if e.device_type == DeviceType.CUDA
              and e.self_device_time_total > 0]
    device = sum(e.self_device_time_total for e in events) / 1e3
    rows = sorted(((e.key, e.self_device_time_total / 1e3, e.count)
                   for e in events), key=lambda r: -r[1])[:top]
    return wall, device, rows


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--tiles", type=int, default=12,
                    help="depth-4 time tiles to run (nt = 4 * tiles)")
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        print("sharded_profile: needs an NVIDIA card", file=sys.stderr)
        return 2
    smi = cs.phase_environment()
    dev = torch.device("cuda", 0)
    fc = cs.full_case("acoustic", dev)
    fc.nt = cs.T_TB * args.tiles
    plan = cs.plan_for(fc.physics, cs.T_TB)
    dplan = cs.dist_plan(fc.physics, cs.SHAPE, fc.dt, fc.spacing, dev)
    runs = {
        "single device": lambda: fc.run(plan),
        f"{cs.MESH} mesh": lambda: H.sharded_tb_propagate(
            dplan, fc.nt, fc.state, fc.params._asdict(), fc.g, fc.gr),
    }
    for what, fn in runs.items():
        wall, device, rows = profiled(fn)
        tiles = args.tiles
        print(f"[profile] {what}, {cs.SHAPE} nt={fc.nt}: wall {wall:.1f} ms "
              f"({wall / tiles:.3f} a tile), device busy {device:.1f} ms "
              f"({device / tiles:.3f} a tile), idle share "
              f"{max(wall - device, 0.0) / wall:.3f} [{smi}]", flush=True)
        for name, ms, calls in rows:
            print(f"[profile]   {ms / tiles:9.3f} ms a tile  {calls:6d} "
                  f"calls  {name[:90]}", flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
