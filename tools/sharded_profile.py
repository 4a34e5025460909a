"""Where the sharded path's time goes on the card: the paper's 512^3
acoustic case (`chip_smoke.full_case`) for `--tiles` depth-4 time tiles,
once on one device (`ops.acoustic_tb_propagate`) and once on a 2x2
`ShardMesh` of shards on the card (`distributed.halo`), each under
`torch.profiler` after a warm-up run.

    python3 tools/sharded_profile.py [--tiles 12]
    python3 tools/sharded_profile.py --as-smoke [--launch-scratch]

Prints, per run: the wall time (host clock around the run and a
synchronise), the device time summed over every kernel, copy and fill the
profiler saw on the card, the device's idle share of the wall time, the
caching allocator's segments made and freed (cudaMalloc / cudaFree) and
its retries during the profiled run, and the device events with the most
time.  `--as-smoke` instead replays `chip_smoke.py`'s order for the
whole case (nt 399): the single-device propagation, again timed, then
with its final state kept and the cache emptied the sharded run timed
cold (as `sharded-acoustic` times it) and once more warm, each with the
allocator's counts; `--launch-scratch` makes the single-device
propagation allocate its scratch a launch (the kernel's own) instead of
once.  Needs a card.
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
    keys = ("segment.all.allocated", "segment.all.freed", "num_alloc_retries")
    before = torch.cuda.memory_stats()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        wall = (time.perf_counter() - t0) * 1e3
    after = torch.cuda.memory_stats()
    alloc = [after.get(k, 0) - before.get(k, 0) for k in keys]
    # the device's own events (kernels, copies, fills): an operator's
    # entry would count its kernels' time a second time
    events = [e for e in prof.key_averages()
              if e.device_type == DeviceType.CUDA
              and e.self_device_time_total > 0]
    device = sum(e.self_device_time_total for e in events) / 1e3
    rows = sorted(((e.key, e.self_device_time_total / 1e3, e.count)
                   for e in events), key=lambda r: -r[1])[:top]
    return wall, device, rows, alloc


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--tiles", type=int, default=12,
                    help="depth-4 time tiles to run (nt = 4 * tiles)")
    ap.add_argument("--as-smoke", action="store_true")
    ap.add_argument("--launch-scratch", action="store_true")
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        print("sharded_profile: needs an NVIDIA card", file=sys.stderr)
        return 2
    smi = cs.phase_environment()
    dev = torch.device("cuda", 0)
    if args.as_smoke:
        return as_smoke(smi, dev, args.launch_scratch)
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
        wall, device, rows, alloc = profiled(fn)
        tiles = args.tiles
        print(f"[profile] {what}, {cs.SHAPE} nt={fc.nt}: wall {wall:.1f} ms "
              f"({wall / tiles:.3f} a tile), device busy {device:.1f} ms "
              f"({device / tiles:.3f} a tile), idle share "
              f"{max(wall - device, 0.0) / wall:.3f}; allocator segments "
              f"made {alloc[0]}, freed {alloc[1]}, retries {alloc[2]} "
              f"[{smi}]", flush=True)
        for name, ms, calls in rows:
            print(f"[profile]   {ms / tiles:9.3f} ms a tile  {calls:6d} "
                  f"calls  {name[:90]}", flush=True)
    return 0


def as_smoke(smi, dev, launch_scratch):
    """`chip_smoke.py`'s single-device then sharded order on the whole
    acoustic case, each timed by CUDA events with the allocator's counts."""
    if launch_scratch:
        from repro_torch.kernels import stencil_tb
        stencil_tb.make_scratch = lambda *a, **k: None

    keys = ("segment.all.allocated", "segment.all.freed",
            "num_alloc_retries")

    def timed(fn):
        before = torch.cuda.memory_stats()
        ms, out = cs.cuda_ms(fn)
        after = torch.cuda.memory_stats()
        return ms, out, [after.get(k, 0) - before.get(k, 0) for k in keys]

    fc = cs.full_case("acoustic", dev)
    plan = cs.plan_for(fc.physics, cs.T_TB)
    dplan = cs.dist_plan(fc.physics, cs.SHAPE, fc.dt, fc.spacing, dev)
    _, (final, _), _ = timed(lambda: fc.run(plan))
    ms, _, alloc = timed(lambda: fc.run(plan))
    print(f"[as-smoke] single device nt={fc.nt}: {ms:.1f} ms; allocator "
          f"segments made {alloc[0]}, freed {alloc[1]}, retries {alloc[2]}"
          f" [{smi}]", flush=True)
    torch.cuda.empty_cache()
    for what in ("cold", "warm"):
        ms, out, alloc = timed(lambda: H.sharded_tb_propagate(
            dplan, fc.nt, fc.state, fc.params._asdict(), fc.g, fc.gr))
        del out
        print(f"[as-smoke] {cs.MESH} mesh nt={fc.nt}, {what}: {ms:.1f} ms;"
              f" allocator segments made {alloc[0]}, freed {alloc[1]}, "
              f"retries {alloc[2]} [{smi}]", flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
