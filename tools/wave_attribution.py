"""Time variants of the acoustic kernel's cluster-shared z-wavefront (B6)
on the card, to split a launch's time by what it does:

    python3 tools/wave_attribution.py [--cases 8:2:32x32:2:2,12:2:32x32:4:2]
                                      [--only a,b]

Builds variants of this tree's `src/repro_torch/kernels/csrc/
stencil_tb.cu`, each a text substitution (below), into
`build/wave_attribution/` (one nvcc each, all started together), and times
each one's B6 launch at 512^3, for each case (order, T, tile, blocks a
cluster, planes a step), with the paper case's params, source and
receivers and a random state (`tools/paper_cases.py --kernels`' inputs;
the params' copies made once), the median, least and most of its timed
launches by CUDA events, with `tools/kernel_ab.py`'s fingerprints of the
outputs.  The variants take a piece out and compute other functions, so
their differences from `base` are where the time goes, not speed-ups.
`profile` builds the kernel with its phase counters (WAVE_PROFILE in
csrc/stencil_tb.cu) and prints the cycles thread 0 of a block spends in
each phase of a step, a mean over the launches' blocks and steps.
Needs a card.
"""
import argparse
import ctypes
import sys
from pathlib import Path

import torch

ROOT = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT / "tools"))
sys.path.insert(0, str(ROOT))

import chip_smoke as smoke  # noqa: E402  (puts src/ on the path)
import kernel_ab  # noqa: E402
import paper_cases  # noqa: E402
import tti_attribution  # noqa: E402
from repro_torch.core.temporal_blocking import TBPlan  # noqa: E402
from repro_torch.kernels import _build  # noqa: E402
from repro_torch.kernels import stencil_tb as ker  # noqa: E402

PUSH = "int e = -1, s1 = 0, n = 0, lb = 0, lr = 0, rr = 0, w = 1;"
VARIANTS = {
    "base": [],
    # the pointwise reads of m, damp and (level 1) u_prev replaced by
    # constants
    "no param reads": [("gm[k] = __ldg(mk + go);", "gm[k] = 2.5e-7f;"),
                       ("gd[k] = __ldg(dk + go);", "gd[k] = 0.f;"),
                       ("gu[k] = j == 1 ? __ldg(uk + go) : 0.f;",
                        "gu[k] = 0.f;")],
    # the seams not sent (the rings keep stale seams)
    "no push": [(PUSH, PUSH.replace("e = -1", "e = 1 << 29"))],
    # no seams and block barriers in place of the cluster's (no block
    # writes into another's shared memory, so none needs to wait for one)
    "no push or cluster barrier": [
        (PUSH, PUSH.replace("e = -1", "e = 1 << 29")),
        ("        if (t > 0) cluster_wait();\n        cluster_arrive();",
         "        __syncthreads();"),
        ("    cluster_barrier();\n    WPROF_INIT",
         "    __syncthreads();\n    WPROF_INIT"),
        ("    cluster_wait();\n}", "    __syncthreads();\n}")],
    # level 0's planes not loaded after the first R + 1
    "no u loads": [("load_u(K * (t + 1) + R + kz, w0 * 32);", "(void)0;")],
    # no point computed (the item loops skipped)
    "no items": [("for (; it < items; it += nt) {",
                  "for (it += items; it < items; it += nt) {")],
    # the sources' injection and the receiver partials skipped
    "no sparse": [("if (flags[par] & 1) {", "if (0) {"),
                  ("j <= T && (flags[par] & 2)", "j <= 0")],
    # u_{T-1} and u_T never written out
    "no flush": [("const int zT = imin(zf + K - 1, nz - 1);",
                  "const int zT = -1;")],
}
# the cycles thread 0 of every block spends in each phase of a step (the
# kernel's WAVE_PROFILE counters; the others' time is the same code)
VARIANTS["profile"] = [("#define WAVE_PHASES 8\n",
                        "#define WAVE_PHASES 8\n#define WAVE_PROFILE\n")]
PHASES = ("lagged cluster wait, level 0's planes arrive",
          "block barrier: the step's loads", "thread 0's items",
          "the next planes' loads and table (the warps with fewer items)",
          "block barrier: every warp's items", "sources (and a barrier)",
          "seams into the neighbours", "receivers and write-back")
# the step's frame alone: its barriers and level 0's loads
VARIANTS["barriers only"] = [
    sub for name in ("no push", "no items", "no sparse", "no flush")
    for sub in VARIANTS[name]]


def main(argv):
    ap = argparse.ArgumentParser()
    ap.add_argument("--cases", default="8:2:32x32:2:2",
                    help="order:T:tile:cluster:planes, comma-separated "
                    "(0: `wave_size`'s)")
    ap.add_argument("--only", default=",".join(VARIANTS))
    args = ap.parse_args(argv)
    libs = tti_attribution.build_all(
        _build.BUILD_DIR.parent / "wave_attribution", args.only.split(","),
        "stencil_tb", VARIANTS)
    smi = smoke.phase_environment()
    dev = torch.device("cuda")
    for case in args.cases.split(","):
        order, T, tile, cluster, planes = case.split(":")
        run_case(libs, int(order), int(T),
                 tuple(int(v) for v in tile.split("x")),
                 int(cluster) or None, int(planes) or None, smi, dev)
        torch.cuda.empty_cache()


def run_case(libs, order, T, tile, cluster, planes, smi, dev):
    """Every variant's B6 launch at one shape, one line each."""
    fc = smoke.full_case("acoustic", dev, order=order)
    p = fc.physics
    gen = torch.Generator(device=dev).manual_seed(0)
    state = tuple(torch.randn(smoke.SHAPE, generator=gen, device=dev) * 0.01
                  for _ in p.state_fields)
    fc.state = None
    spec, kargs = smoke.kernel_inputs(
        p, TBPlan(tile, T, p.step_radius(order)), state,
        fc.params._asdict(), fc.g, fc.gr, fc.dt, (fc.nt // 4 // 2) * 4,
        fc.spacing, order=order)
    plan = ker.wave_plan(spec, p, cluster, planes)
    with smoke.on_schedule(plan):
        print(f"acoustic order {order} T={T} tile {tile} at {smoke.SHAPE}: "
              f"{smoke.schedule_of(spec, p)} [{smi}]", flush=True)
        copies = ker.param_copies(spec, p, kargs[1])
        scratch = ker.make_scratch([spec], p, 1, dev)
        for name, (lib, log) in libs.items():
            _build._loaded["stencil_tb"] = _build.Built(lib, Path(), 0.0,
                                                        log)

            def launch():
                return smoke.uncounted(lambda: ker.tb_time_tile(
                    spec, p, *kargs, param_copies=copies, scratch=scratch))

            profile = hasattr(lib, "repro_tb_wave_profile")
            if profile:
                launch()
                torch.cuda.synchronize()
                counts = (ctypes.c_ulonglong * (len(PHASES) + 1))()
                lib.repro_tb_wave_profile(counts, 1)
            ms, lo, hi = paper_cases.time_launches(launch)
            out, rec = launch()
            if profile:
                torch.cuda.synchronize()
                lib.repro_tb_wave_profile(counts, 1)
                steps = max(counts[len(PHASES)], 1)
                print(f"  cycles a step of thread 0, mean over blocks and "
                      f"steps ({steps} block-steps): " + "; ".join(
                          f"{what} {counts[i] / steps:.0f}"
                          for i, what in enumerate(PHASES)), flush=True)
            use = sorted({f"{r} registers, {sp} B spill stores"
                          for e, (r, _, sp) in smoke.ptxas_usage(log).items()
                          if "WaveArgs" in e
                          and f"ILi{spec.radius}ELb0E" in e})
            print(f"  {name:24s}: {ms:8.3f} ms (least {lo:.3f}, most "
                  f"{hi:.3f}; {ms / T:.3f} ms a step); {use}; "
                  f"fingerprints: fields {kernel_ab.fingerprint(out)}, "
                  f"partials {kernel_ab.fingerprint((rec + 0.0,))}",
                  flush=True)
            del out, rec


if __name__ == "__main__":
    main(sys.argv[1:])
