"""Time two versions of the SSD scan kernel's source on the card, in one
call and in turns (a, b, b, a, a, b), at a B2 shape of `chip_smoke.py`:
`--shape serve` (the default: mamba2-130m's serve call, B 8, S 1024, H
24, G 1, N 128, P 64, Q 64) or `--shape zamba2` (zamba2-2.7b's, B 8, S
1024, H 80, G 1, N 64, P 64, Q 128); bf16 x, B and C, float32 y, no h0:

    python3 tools/ssd_ab.py <a.cu> [<b.cu>] [--shape serve|zamba2]

<b.cu> defaults to this tree's `src/repro_torch/kernels/csrc/ssd_scan.cu`.
Each source is built with the port's nvcc flags into its own library under
`build/ssd_ab/`.  A source with two schedules (it exports
`repro_ssd_blocks_per_sm`) runs the tensor cores where it takes the shape
(it exports `repro_ssd_intra_jobs`: at `ssd_scan.TC_SHAPES`; an older one:
at (128, 64, 64) only) and the float32 cores elsewhere; an older source
(one schedule, no schedule argument) gets that signature.  The inputs are
`chip_smoke.ssd_case`'s draw (seed 7).  Prints, per version, its schedule,
whether y and h_final equal `ssd_scan_plain`'s bit for bit, their largest
difference and whether they keep `chip_smoke.check_ssd`'s bounds, then the
mean of 10 launches after a warm-up, by CUDA events, for each turn, with
the card's name and power limit.  Needs a card.  The parent commit's
source against this tree's:

    git archive HEAD^ src/repro_torch/kernels/csrc | tar -x -C build/parent
    python3 tools/ssd_ab.py build/parent/src/repro_torch/kernels/csrc/ssd_scan.cu --shape zamba2
"""
import argparse
import ctypes
import statistics
import subprocess
import sys
from pathlib import Path

import torch

sys.path.insert(0, str(Path(__file__).resolve().parent.parent))

import chip_smoke  # noqa: E402  (puts src/ on the path)
from repro_torch.kernels import _build  # noqa: E402
from repro_torch.kernels import ssd_scan as ssd  # noqa: E402


SHAPES = {"serve": chip_smoke.SERVE_SHAPE,
          "zamba2": chip_smoke.ZAMBA2_SSD_SHAPE}


def build(src: Path, tag: str, spec):
    """(library, the schedule index it runs at `spec`'s shape, or None for
    a one-schedule source)."""
    out = _build.BUILD_DIR.parent / "ssd_ab" / f"libssd_{tag}.so"
    out.parent.mkdir(parents=True, exist_ok=True)
    subprocess.run([_build.nvcc(), *_build.NVCC_FLAGS, "-o", str(out),
                    str(src)], check=True, capture_output=True)
    lib = ctypes.CDLL(str(out))
    if hasattr(lib, "repro_ssd_blocks_per_sm"):
        shapes = (ssd.TC_SHAPES if hasattr(lib, "repro_ssd_intra_jobs")
                  else ((128, 64, 64),))
        tc = (spec.state, spec.headdim, spec.chunk) in shapes
        if hasattr(lib, "repro_ssd_intra_jobs"):
            lib = ssd.declare(lib)
        else:
            p, i = ctypes.c_void_p, ctypes.c_int
            lib.repro_ssd_scan.argtypes = [i] + [p] * 8 + [i] * 10 + [p]
            lib.repro_ssd_scan.restype = i
        return lib, ssd.SCHEDULES.index("tensor cores" if tc
                                        else "float32 cores")
    p, i = ctypes.c_void_p, ctypes.c_int
    lib.repro_ssd_scan.argtypes = [i] + [p] * 8 + [i] * 9 + [p]
    lib.repro_ssd_scan.restype = i
    return lib, None


def main(argv):
    ap = argparse.ArgumentParser()
    ap.add_argument("a")
    ap.add_argument("b", nargs="?", default=str(_build.CSRC / "ssd_scan.cu"))
    ap.add_argument("--shape", choices=sorted(SHAPES), default="serve")
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        raise SystemExit("tools/ssd_ab.py needs a card")
    srcs = [Path(args.a), Path(args.b)]
    dev = torch.device("cuda", 0)
    shape = SHAPES[args.shape]
    B, S, H, G, N, P, Q = shape
    spec, (x, dt, Bm, Cm, A), _ = chip_smoke.ssd_case(
        shape, 7, torch.bfloat16, False, dev)
    libs = {tag: build(src, tag, spec) for tag, src in zip("ab", srcs)}
    y = torch.empty((B, S, H, P), device=dev)
    h = torch.empty((B, H, N, P), device=dev)
    stream = torch.cuda.current_stream(dev).cuda_stream

    def run(tag):
        lib, sched = libs[tag]
        more = () if sched is None else (sched,)
        rc = lib.repro_ssd_scan(
            0, x.data_ptr(), dt.data_ptr(), Bm.data_ptr(), Cm.data_ptr(),
            A.data_ptr(), None, y.data_ptr(), h.data_ptr(), 1, 0, B, S, H,
            G, N, P, Q, *more, stream)
        if rc:
            raise RuntimeError(f"{tag}: launch failed ({rc})")

    py, ph = ssd.ssd_scan_plain(spec, x, dt, Bm, Cm, A)
    for tag, src in zip("ab", srcs):
        run(tag)
        torch.cuda.synchronize()
        same = torch.equal(y, py) and torch.equal(h, ph)
        err = max(float((y - py).abs().max()), float((h - ph).abs().max()))
        try:
            rel = max(chip_smoke.check_ssd("y", y, py)[1],
                      chip_smoke.check_ssd("h_final", h, ph)[1])
            bounds = f"within the bounds (max|diff|/max|plain| {rel:.2e})"
        except AssertionError as e:
            bounds = f"OUTSIDE the bounds: {e}"
        sched = libs[tag][1]
        name = ("the one schedule" if sched is None
                else ssd.SCHEDULES[sched])
        print(f"{tag} ({src}, {name}, {args.shape} shape {shape}): equal to ssd_scan_plain bit for bit:"
              f" {same} (max|diff| {err:.3e}); {bounds}", flush=True)
    ms = {"a": [], "b": []}
    for tag in "abbaab":
        run(tag)
        torch.cuda.synchronize()
        s, e = (torch.cuda.Event(enable_timing=True) for _ in range(2))
        s.record()
        for _ in range(10):
            run(tag)
        e.record()
        torch.cuda.synchronize()
        ms[tag].append(s.elapsed_time(e) / 10)
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True,
        text=True).stdout.strip()
    for tag in "ab":
        print(f"{tag}: ms per launch " + ", ".join(f"{m:.4f}" for m in ms[tag])
              + f"; median {statistics.median(ms[tag]):.4f} [{smi}]")


if __name__ == "__main__":
    main(sys.argv[1:])
