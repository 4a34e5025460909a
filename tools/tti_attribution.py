"""Time variants of the z-streamed TTI kernel on the card, to split its
launch's time by what it does and to pick its batching:

    python3 tools/tti_attribution.py [--T 4] [--order 4] [--only a,b]
                                     [--state-scale 1,0,1e-36] [--live]

Builds variants of this tree's `src/repro_torch/kernels/csrc/
stencil_tb_tti.cu`, each a text substitution (below), into
`build/tti_attribution/` (one nvcc each, all started together), and times
each one's launch at the paper's 512^3 TTI shapes (tile 32;
`tools/kernel_ab.py`'s inputs: the paper case's source and receivers, the
params' copies made once), the median, least and most of 3 means of 5
launches after a warm-up, by CUDA events, with `kernel_ab`'s fingerprints
of the outputs.  The variants that take a piece out compute other
functions, so their differences from `base` are where the time goes, not
speed-ups; those that change the batching (threads a block, points a
thread at a time) compute the same function, which their fingerprints
show.  `--state-scale` times each variant again with the random state
times each factor (0: a quiet field; 1e-36: values whose updates fall
below float32's normal range), to show what the values cost.  `--live`
times each variant instead on the paper's TTI case as `chip_smoke.py`
does (order 4): the whole TB propagation (`main-tti`), then the kernel
alone on a mid-run tile with the propagation's final wavefield
(`kernels-tti`).  Needs a card.
"""
import argparse
import ctypes
import subprocess
import sys
from pathlib import Path

import torch

ROOT = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT / "tools"))
sys.path.insert(0, str(ROOT))

import chip_smoke as smoke  # noqa: E402  (puts src/ on the path)
import kernel_ab  # noqa: E402
from repro_torch.kernels import _build  # noqa: E402
from repro_torch.kernels import stencil_tb as ker  # noqa: E402

# name -> [(text, replacement)] in stencil_tb_tti.cu
POINTS = "#define TTI_POINTS 2"
THREADS = "#define TTI_THREADS 512"
VARIANTS = {
    "base": [],
    # the fast intrinsic in place of the accurate sincosf
    "fast sincos": [("sincosf(theta", "__sincosf(theta"),
                    ("sincosf(phi", "__sincosf(phi")],
    # the six params' pointwise reads replaced by constants
    "no param reads": [("__ldg(theta + pi)", "0.2f"),
                       ("__ldg(phi + pi)", "0.3f"),
                       ("__ldg(eps + pi)", "0.1f"),
                       ("__ldg(dlt + pi)", "0.05f"),
                       ("__ldg(m + pi)", "2.5e-7f"),
                       ("__ldg(damp + pi)", "0.f")],
    # phase B's four state reads replaced by constants
    "no state reads": [(f"o.{f} = {v}.at(x, y, z);", f"o.{f} = 0.f;")
                       for f, v in (("p", "p"), ("pp", "p_prev"),
                                    ("r", "r"), ("rp", "r_prev"))],
    # one phase's passes skipped
    "phase A only": [("ring_pass<R, 2, 1>(", "if (0) ring_pass<R, 2, 1>(")],
    "phase B only": [("ring_pass<R, 2, 0>(", "if (0) ring_pass<R, 2, 0>(")],
    # the state's z-major copies, the write-back and the sparse terms
    "no passes": [("ring_pass<R, 2, 1>(", "if (0) ring_pass<R, 2, 1>("),
                  ("ring_pass<R, 2, 0>(", "if (0) ring_pass<R, 2, 0>(")],
    # the `/` operator in place of `qdiv` (its slow path for zeros and
    # numerators below float32's normal range)
    "plain division": [("return n / d;\n}", "return n / d;\n}\n"
                        "#define qdiv(n, d) ((n) / (d))")],
    # the batching: points a thread reads and computes at a time, threads
    # a block
    "1 point": [(POINTS, "#define TTI_POINTS 1")],
    "2 points 384 threads": [(POINTS, "#define TTI_POINTS 2"),
                              (THREADS, "#define TTI_THREADS 384")],
    "3 points 384 threads": [(POINTS, "#define TTI_POINTS 3"),
                              (THREADS, "#define TTI_THREADS 384")],
    "2 points 256 threads": [(POINTS, "#define TTI_POINTS 2"),
                              (THREADS, "#define TTI_THREADS 256")],
    "4 points 256 threads": [(POINTS, "#define TTI_POINTS 4"),
                              (THREADS, "#define TTI_THREADS 256")],
}


def build_all(out: Path, names, source="stencil_tb_tti", variants=VARIANTS):
    """{variant: (library, nvcc's output)} of `csrc/<source>.cu` with each
    named variant's substitutions, one nvcc each, all started together."""
    src = (_build.CSRC / f"{source}.cu").read_text()
    procs = {}
    for i, name in enumerate(names):
        subs = variants[name]
        text = src
        for a, b in subs:
            if a not in text:
                raise ValueError(f"{name}: {a!r} is not in the source")
            text = text.replace(a, b)
        d = out / f"v{i}"
        d.mkdir(parents=True, exist_ok=True)
        for h in _build.CSRC.glob("*.cuh"):
            (d / h.name).write_text(h.read_text())
        (d / f"{source}.cu").write_text(text)
        lib = d / f"lib{source}.so"
        procs[name] = (subprocess.Popen(
            [_build.nvcc(), *_build.NVCC_FLAGS, "-o", str(lib),
             str(d / f"{source}.cu")], stdout=subprocess.PIPE,
            stderr=subprocess.STDOUT, text=True), lib)
    libs = {}
    for name, (proc, lib) in procs.items():
        log, _ = proc.communicate()
        libs[name] = (ctypes.CDLL(str(lib)) if proc.returncode == 0
                      else None, log)
    failed = [n for n, (lib, _) in libs.items() if lib is None]
    if failed:
        raise RuntimeError(f"nvcc failed for {failed}:\n"
                           + libs[failed[0]][1])
    return libs


def main(argv):
    ap = argparse.ArgumentParser()
    ap.add_argument("--T", type=int, default=4)
    ap.add_argument("--order", type=int, default=4)
    ap.add_argument("--only", default=",".join(VARIANTS))
    ap.add_argument("--state-scale", default="1")
    ap.add_argument("--live", action="store_true")
    args = ap.parse_args(argv)
    libs = build_all(_build.BUILD_DIR.parent / "tti_attribution",
                     args.only.split(","))
    dev = torch.device("cuda")
    if args.live:
        return live(libs, args.T, dev)
    spec, p, kargs = kernel_ab.launch_args("tti", args.order, args.T, smoke,
                                           dev)
    plan = ker.launch_plan(spec, p)
    print(f"tti order {args.order} T={args.T} at {kernel_ab.SHAPE}: plan "
          f"{plan}", flush=True)
    copies = ker.param_copies(spec, p, kargs[1])
    tag = f"_kernelILi{spec.radius}ELb0EEv9TileArgsTIfE5Coefs10StreamArgs"
    pads = kargs[0]
    for scale in map(float, args.state_scale.split(",")):
        kargs = (tuple(f * scale for f in pads), *kargs[1:])
        for name, (lib, log) in libs.items():
            _build._loaded["stencil_tb_tti"] = _build.Built(lib, Path(), 0.0,
                                                            log)
            launch = lambda: ker.tb_time_tile(  # noqa: E731
                spec, p, *kargs, param_copies=copies)
            t = kernel_ab.timed(launch)
            out, rec = launch()
            use = [f"{r} registers, {sp} B spill stores"
                   for e, (r, _, sp) in smoke.ptxas_usage(log).items()
                   if e.endswith(tag)]
            print(f"  {name:22s} state x {scale:g}: {t[0]:8.3f} ms (least "
                  f"{t[1]:.3f}, most {t[2]:.3f}); {use}; fingerprints: "
                  f"fields {kernel_ab.fingerprint(out)}, partials "
                  f"{kernel_ab.fingerprint((rec + 0.0,))}", flush=True)
            del out, rec


def live(libs, T, dev):
    """Each variant on the paper's TTI case: the TB propagation's time
    (after a warm-up run) and the kernel's on a mid-run tile with the
    final wavefield, as `chip_smoke.py` times them."""
    fc = smoke.full_case("tti", dev)
    plan = smoke.plan_for(fc.physics, T)
    t0 = (fc.nt // T // 2) * T
    for name, (lib, log) in libs.items():
        _build._loaded["stencil_tb_tti"] = _build.Built(lib, Path(), 0.0, log)
        final, _ = fc.run(plan)
        run_ms, _ = smoke.cuda_ms(lambda: fc.run(plan))
        _, _, pieces, (lo, hi) = smoke.time_tile_pieces(fc, plan, final, t0)
        print(f"  {name:22s} live: TB run {run_ms:.1f} ms; kernel "
              f"{pieces[1]:.3f} ms (least {lo:.3f}, most {hi:.3f}); final "
              f"fields {kernel_ab.fingerprint(final)}", flush=True)
        del final
        torch.cuda.empty_cache()


if __name__ == "__main__":
    main(sys.argv[1:])
