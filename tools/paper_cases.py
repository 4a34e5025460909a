"""The paper's cases beyond order 4 on the card, without the rest of
`chip_smoke.py`: each case's plan, schedule, launches, TB and SB run
times, kernel time a launch against its bound, peak memory, and its
agreement with the Listing-1 reference (`chip_smoke.phase_paper_case`).

    python3 tools/paper_cases.py [--only tti-12,elastic-8]
    python3 tools/paper_cases.py --kernels [--only tti-8] [--T 2,4]
        [--b5 64x64:2,128x128:16] [--b5-only]

`--only` names cases as physics-order; default: the six cases
`chip_smoke.py` runs as its paper-* phases.  A case that fails prints its
error and the others still run; the exit code is 1 if any failed.

`--kernels` times the TB kernel alone instead, at 512^3 with the paper
case's params, source and receivers and a random state (0.01 randn; the
elastic velocities 1e-6 of that), for each depth T of `--T` (default 2
and 4; acoustic 2, 3 and 4): the first schedule at tile 32, the
z-streamed one at tile 32 where `launch_plan` could take it, and the
cluster-shared trapezoid (B5, TTI and elastic) at tiles from 32 x 32 to
256 x 128 with 1 to 16 blocks a cluster (`B5_VARIANTS`), or the
cluster-shared z-wavefront (B6, acoustic) at tiles 32, 64 and 128 x 64
with every cluster of 1 to 16 blocks and 1 or 2 planes a step whose
parts fit (`B6_TILES`); for
acoustic also the spatially-blocked launch (T = 1, tile 32) once, the
yardstick a step.  Each line gives the schedule, its cluster, largest
chunk or parts and shared bytes, the clusters the card holds at once
(`stencil_tb.cluster_occupancy`) and the waves they make, the launch's
redundancy (`stencil_tb.redundancy`: points computed a pass over the
tile's), the bytes its schedule moves by design
(`stencil_tb.design_bytes`), the
median / least / most ms of its timed launches and the median a step
(CUDA events; the params' copies made once, as a propagation makes
them), its bound, and whether
its output fields equal the first schedule's at that T bit for bit.  A
variant that does not fit the card prints why and the sweep goes on.
`--b5` names the B5 variants instead (tile:blocks a cluster) and
`--b5-only` leaves out the first and z-streamed schedules: an A/B of two
checkouts' B5 runs each from its own root at the same variants.
"""
import argparse
import statistics
import sys
import time
import traceback
from pathlib import Path

sys.path.insert(0, str(Path(__file__).resolve().parents[1]))

import torch  # noqa: E402

import chip_smoke as cs  # noqa: E402  (puts src/ on the path)
from repro_torch.core.temporal_blocking import TBPlan  # noqa: E402
from repro_torch.kernels import stencil_tb as ker  # noqa: E402

KERNEL_CASES = cs.PAPER_EXTRA
# seconds of timed launches a variant aims at (at least 2, at most 10)
TIMED_S = 3.0


# the B5 variants timed: (tile, blocks a cluster; None: `cluster_size`)
B5_VARIANTS = (((32, 32), None), ((64, 64), 2), ((64, 64), 4),
               ((128, 64), 4), ((128, 64), 8), ((128, 128), 8),
               ((128, 128), 16), ((256, 128), 16))
# the B6 tiles timed, each with every cluster of `ker._WAVE_CLUSTERS` and
# planes a step whose parts fit a block
B6_TILES = ((32, 32), (64, 64), (128, 64))


def variants(physics, order, T, b5=None, b5_only=False):
    """(label, tile, plan or "first") of each variant timed at depth T:
    the first schedule at tile 32, the z-streamed one there where
    `launch_plan` could take it (a sub-tile fits and overhangs at most
    `_MAX_OVERHANG` times), and B5 at each of B5_VARIANTS."""
    r = physics.step_radius(order)
    out = [] if b5_only else [("first", (32, 32), "first")]
    spec32 = cs.ops.make_spec(cs.SHAPE, TBPlan((32, 32), T, r), order, 1.0,
                              (1.0,) * 3, 1, 1, physics=physics)
    try:
        if b5_only:
            raise ValueError("B5 only")
        bx, by, smem = ker.stream_plan(spec32, physics)
        h = spec32.halo
        if (bx + 2 * h) * (by + 2 * h) <= ker._MAX_OVERHANG * bx * by:
            out.append(("z-streamed", (32, 32), (bx, by, smem)))
    except ValueError:
        pass
    if physics.name == "acoustic":
        for tile in B6_TILES:
            spec = cs.ops.make_spec(cs.SHAPE, TBPlan(tile, T, r), order,
                                    1.0, (1.0,) * 3, 1, 1, physics=physics)
            for cluster in ker._WAVE_CLUSTERS:
                for planes in range(1, ker._WAVE_MAX_K + 1):
                    try:
                        plan = ker.wave_plan(spec, physics, cluster, planes)
                    except ValueError:      # its parts do not fit a block
                        continue
                    out.append((f"B6 C={plan.cluster} K={planes}", tile,
                                plan))
        return out
    for tile, cluster in (b5 or B5_VARIANTS):
        spec = cs.ops.make_spec(cs.SHAPE, TBPlan(tile, T, r), order, 1.0,
                                (1.0,) * 3, 1, 1, physics=physics)
        plan = ker.cluster_plan(spec, physics, cluster)
        out.append((f"B5 C={plan.cluster}", tile, plan))
    return out


def time_launches(launch):
    """(median, least, most) ms of single launches after a warm-up: as
    many as fill TIMED_S, at least 2 and at most 10."""
    t0 = time.perf_counter()
    launch()
    torch.cuda.synchronize()
    n = max(2, min(10, int(TIMED_S / max(time.perf_counter() - t0, 1e-3))))
    times = []
    for _ in range(n):
        s, e = (torch.cuda.Event(enable_timing=True) for _ in range(2))
        s.record()
        launch()
        e.record()
        torch.cuda.synchronize()
        times.append(s.elapsed_time(e))
    return statistics.median(times), min(times), max(times)


def kernel_case(name, order, depths, smi, dev, b5=None, b5_only=False):
    """Every variant of one case at each depth, one line each."""
    fc = cs.full_case(name, dev, order=order)
    physics = fc.physics
    gen = torch.Generator(device=dev).manual_seed(0)
    state = tuple(torch.randn(cs.SHAPE, generator=gen, device=dev) * 0.01
                  * (1e-6 if name == "elastic" and i < 3 else 1.0)
                  for i in range(len(physics.state_fields)))
    fc.state = None
    t0 = (fc.nt // 4 // 2) * 4
    runs = [(T, label, tile, plan) for T in depths
            for label, tile, plan in variants(physics, order, T, b5,
                                              b5_only)]
    if name == "acoustic" and not b5_only:
        # the spatially-blocked launch, as the SB run takes it
        runs.insert(0, (1, "SB", (32, 32), "launch"))
    firsts = None
    for T, label, tile, plan in runs:
        if label == "first":
            firsts = None
        tag = f"{fc.case.name} T={T} tile {tile} {label}"
        forced = None if plan == "first" else plan
        tplan = TBPlan(tile, T, physics.step_radius(order))
        if plan == "launch":
            forced = ker.launch_plan(cs.ops.make_spec(
                cs.SHAPE, tplan, order, 1.0, (1.0,) * 3, 1, 1,
                physics=physics), physics)
        try:
            spec, args = cs.kernel_inputs(
                physics, tplan, state, fc.params._asdict(), fc.g, fc.gr,
                fc.dt, t0, fc.spacing, order=order)
            with cs.on_schedule(forced):
                copies = ker.param_copies(spec, physics, args[1])
                scratch = ker.make_scratch([spec], physics, 1, dev)

                def launch():
                    return cs.uncounted(lambda: ker.tb_time_tile(
                        spec, physics, *args, param_copies=copies,
                        scratch=scratch))

                ms, lo, hi = time_launches(launch)
                fields = launch()[0]
                torch.cuda.synchronize()
                red = ker.redundancy(spec, physics, forced)
                design = ker.design_bytes(spec, physics)
            if plan == "first":
                firsts = [f.cpu() for f in fields]
                same = "(the reference of this T)"
            elif label == "SB":
                same = "not compared (depth 1)"
            else:
                same = ("not compared (first did not run)"
                        if firsts is None else
                        str(all(torch.equal(f.cpu(), g)
                                for f, g in zip(fields, firsts))))
            bound, by = cs.bound_of(ker.kernel_cost(spec, physics))
            what = ""
            if isinstance(plan, (ker.ClusterPlan, ker.WavePlan)):
                active = cs.occupancy(spec, physics, plan)
                ntiles = spec.ntiles[0] * spec.ntiles[1]
                shape = (f"parts {plan.parts}, cuts {plan.xcuts} x "
                         f"{plan.ycuts}, {plan.planes} plane(s) a step"
                         if isinstance(plan, ker.WavePlan) else
                         f"largest chunk {plan.chunk}")
                what = (f", cluster {plan.cluster}, {shape}, "
                        f"{plan.smem} B shared; "
                        f"{ntiles} clusters, {active} at once "
                        f"({ntiles / max(active, 1):.2f} waves)")
            cs.say("kernels", f"{tag}{what}: redundancy {red:.3f}, "
                   f"design {design / 1e9:.1f} GB; {ms:.3f} ms a launch "
                   f"(least {lo:.3f}, most {hi:.3f}; {ms / T:.3f} ms a "
                   f"step; "
                   f"{design / ms / 1e6:.0f} GB/s of design) vs bound "
                   f"{bound:.3f} ms by {by}; fields bit-equal to the "
                   f"first schedule's: {same} [{smi}]")
            del spec, args, copies, scratch, fields
        except (ValueError, RuntimeError, torch.cuda.OutOfMemoryError) as e:
            cs.say("kernels", f"{tag}: not run: {type(e).__name__}: "
                   f"{str(e).splitlines()[0][:200]}")
        torch.cuda.empty_cache()
    del fc, state
    torch.cuda.empty_cache()


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--only", default=None,
                    help="comma list of physics-order, e.g. tti-12")
    ap.add_argument("--kernels", action="store_true",
                    help="time the kernel's schedules instead of the runs")
    ap.add_argument("--T", default=None,
                    help="depths for --kernels (default 2,4; acoustic "
                    "2,3,4)")
    ap.add_argument("--b5", default=None,
                    help="B5 variants for --kernels, e.g. 64x64:2,128x128:16")
    ap.add_argument("--b5-only", action="store_true",
                    help="--kernels times only the B5 variants")
    args = ap.parse_args()
    cases = KERNEL_CASES if args.kernels else cs.PAPER_EXTRA
    if args.only:
        cases = [(p, int(o)) for p, o in
                 (c.split("-") for c in args.only.split(","))]
    smi = cs.phase_environment()
    dev = torch.device("cuda", 0)
    cs.timed("build", cs.phase_build)
    records, failed = [], []
    t0 = time.perf_counter()
    for name, order in cases:
        try:
            if args.kernels:
                b5 = None if args.b5 is None else [
                    (tuple(int(v) for v in t.split("x")), int(c))
                    for t, c in (x.split(":") for x in args.b5.split(","))]
                depths = args.T or ("2,3,4" if name == "acoustic" else "2,4")
                cs.timed(f"kernels-{name}-O{order}", kernel_case, name,
                         order, [int(t) for t in depths.split(",")], smi,
                         dev, b5, args.b5_only)
            else:
                records.append(cs.timed(f"paper-{name}-O{order}",
                                        cs.phase_paper_case, name, order,
                                        smi, dev))
        except Exception:                  # report it, run the next case
            traceback.print_exc()
            failed.append(f"{name}-{order}")
            torch.cuda.empty_cache()
    if records:
        cs.say_paper_table(records, smi)
    cs.say("time", f"total {time.perf_counter() - t0:.1f} s")
    if failed:
        print("failed: " + ", ".join(failed), flush=True)
        return 1
    return 0


if __name__ == "__main__":
    sys.exit(main())
