"""Time variants of kernel B2's tensor-core schedule on the card, to split
its launch's time by what it does:

    python3 tools/ssd_attribution.py [--only a,b] [--shape serve|zamba2]

Builds variants of this tree's `src/repro_torch/kernels/csrc/ssd_scan.cu`,
each a text substitution (below), into `build/ssd_attribution/` (one nvcc
each, all started together), and times each one's launch at a B2 shape of
`chip_smoke.py`: `--shape serve` (the default: mamba2-130m's serve call,
B 8, S 1024, H 24, G 1, N 128, P 64, Q 64) or `--shape zamba2`
(zamba2-2.7b's, B 8, S 1024, H 80, G 1, N 64, P 64, Q 128); bf16 x, B and
C, float32 y, no h0; `chip_smoke.ssd_case`'s draw), in turns with `base`
(base, variant, variant, base), each turn the mean of 10 launches after a
warm-up, by CUDA events.  Prints the medians, each variant's max|diff| /
max|plain| against `ssd_scan_plain`, and the card's name and power limit.
The variants that take a piece out compute other functions, so their
differences from `base` are where the time goes, not speed-ups; those
marked "same function" keep the result.  Needs a card.
"""
import argparse
import ctypes
import statistics
import subprocess
import sys
from pathlib import Path

import torch

ROOT = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT))

import chip_smoke  # noqa: E402  (puts src/ on the path)
from repro_torch.kernels import _build  # noqa: E402
from repro_torch.kernels import ssd_scan as ssd  # noqa: E402

CLOBBER = ': "r"(saddr(p)) : "memory");'
VARIANTS = {
    "base": [],
    # same function: 12,000 more bytes of shared memory, one block an SM
    "one block an SM": [("BASE_BYTES + (OWN_Y ? Y_BYTES : 0);",
                         "BASE_BYTES + (OWN_Y ? Y_BYTES : 0) + 12000;")],
    # same function: the intra-chunk y in room of its own whatever that
    # costs (at zamba2-2.7b's shape 151,552 B, one block an SM)
    "y own room": [("static constexpr bool OWN_Y = BASE_BYTES + Y_BYTES "
                    "<= TWO_A_SM;", "static constexpr bool OWN_Y = true;")],
    # same function: the state update's k in one part (all of sd o x split
    # in registers at once)
    "update k whole": [("constexpr int KH = R > 4 ? 2 : 1,",
                        "constexpr int KH = 1,")],
    # same function: ldmatrix without the compiler's memory barrier
    "ldmatrix unordered": [(CLOBBER, ': "r"(saddr(p)));')] * 2,
    # the intra-chunk term (C B^T, M, M x) left out
    "no intra": [("const bool has_part = job.r >= 0;",
                  "const bool has_part = false;")],
    # M's decay: no expf (M = C B^T o dt_j)
    "no decay exp": [("* expf(Lc[i] - Lc[j]) ", ""),
                     ("* expf(Lc[i] - Lc[j + 1])", "")],
    # the inter-chunk term's products left out (C h = 0)
    "no inter": [("mma3(inter[r], af, b0, b1);", "")],
    # the state update's products left out
    "no update": [("mma3(acc[ii], af, xb[kq][0], xb[kq][1]);", "")],
    # one bf16 piece a split operand instead of three
    "one piece": [("    mma(d, lo, b0, b1);\n    mma(d, mid, b0, b1);\n", ""),
                  ("    mma(d, a, b0.lo, b1.lo);\n"
                   "    mma(d, a, b0.mid, b1.mid);\n", "")],
    # the next chunk's decay (one lane's cumulative sum) left out
    "no decay warp": [("if (warp == DECAY_WARP && c + 1 < nc) {",
                       "if (false) {")],
}


def build_all(names):
    """{name: library} of the variants, built in parallel."""
    src = (_build.CSRC / "ssd_scan.cu").read_text()
    out = _build.BUILD_DIR.parent / "ssd_attribution"
    out.mkdir(parents=True, exist_ok=True)
    procs = {}
    for i, name in enumerate(names):
        text = src
        for old, new in VARIANTS[name]:
            if old not in text:
                raise ValueError(f"{name}: {old!r} not in ssd_scan.cu")
            text = text.replace(old, new, 1)
        cu = out / f"v{i}.cu"
        cu.write_text(text)
        lib = out / f"libv{i}.so"
        procs[name] = (subprocess.Popen(
            [_build.nvcc(), *_build.NVCC_FLAGS, "-o", str(lib), str(cu)],
            stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True), lib)
    libs = {}
    for name, (proc, lib) in procs.items():
        log, _ = proc.communicate()
        if proc.returncode:
            raise RuntimeError(f"{name}: nvcc failed\n{log}")
        libs[name] = ssd.declare(ctypes.CDLL(str(lib)))
    return libs


def main(argv):
    ap = argparse.ArgumentParser()
    ap.add_argument("--only", default="")
    ap.add_argument("--shape", choices=("serve", "zamba2"), default="serve")
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        raise SystemExit("tools/ssd_attribution.py needs a card")
    names = ["base"] + [n for n in VARIANTS if n != "base" and (
        not args.only or n in args.only.split(","))]
    libs = build_all(names)
    dev = torch.device("cuda", 0)
    shape = {"serve": chip_smoke.SERVE_SHAPE,
             "zamba2": chip_smoke.ZAMBA2_SSD_SHAPE}[args.shape]
    B, S, H, G, N, P, Q = shape
    spec, (x, dt, Bm, Cm, A), _ = chip_smoke.ssd_case(
        shape, 7, torch.bfloat16, False, dev)
    y = torch.empty((B, S, H, P), device=dev)
    h = torch.empty((B, H, N, P), device=dev)
    stream = torch.cuda.current_stream(dev).cuda_stream
    tc = ssd.SCHEDULES.index("tensor cores")

    def run(name):
        rc = libs[name].repro_ssd_scan(
            0, x.data_ptr(), dt.data_ptr(), Bm.data_ptr(), Cm.data_ptr(),
            A.data_ptr(), None, y.data_ptr(), h.data_ptr(), 1, 0, B, S, H,
            G, N, P, Q, tc, stream)
        if rc:
            raise RuntimeError(f"{name}: launch failed ({rc})")

    def ms(name):
        run(name)
        torch.cuda.synchronize()
        s, e = (torch.cuda.Event(enable_timing=True) for _ in range(2))
        s.record()
        for _ in range(10):
            run(name)
        e.record()
        torch.cuda.synchronize()
        return s.elapsed_time(e) / 10

    py, _ = ssd.ssd_scan_plain(spec, x, dt, Bm, Cm, A)
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True,
        text=True).stdout.strip()
    for name in names[1:]:
        run(name)
        torch.cuda.synchronize()
        rel = float((y - py).abs().max() / py.abs().max())
        turns = {"base": [], name: []}
        for who in ("base", name, name, "base"):
            turns[who].append(ms(who))
        b, v = (statistics.median(turns[k]) for k in ("base", name))
        print(f"{name} ({args.shape} shape {shape}): {v:.4f} ms against base {b:.4f} ms ({v - b:+.4f}); "
              f"y max|diff|/max|plain| {rel:.2e} [{smi}]", flush=True)


if __name__ == "__main__":
    main(sys.argv[1:])
