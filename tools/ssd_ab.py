"""Time two versions of the SSD scan kernel's source on the card, in one
call and in turns (a, b, b, a, a, b), at the serve phase's shapes of
`chip_smoke.py` (B 8, S 1024, H 24, G 1, N 128, P 64, Q 64; bf16 x, B and
C, float32 y, no h0):

    python3 tools/ssd_ab.py <a.cu> [<b.cu>]

<b.cu> defaults to this tree's `src/repro_torch/kernels/csrc/ssd_scan.cu`.
Each source is built with the port's nvcc flags into its own library under
`build/ssd_ab/`, its C signatures set by `ssd_scan.declare`; the inputs
are `chip_smoke.ssd_case`'s draw (seed 7).  Prints, per version, whether
y and h_final equal `ssd_scan_plain`'s bit for bit (and the largest
difference), then the mean of 10 launches after a warm-up, by CUDA
events, for each turn.  Needs a card.
"""
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


def build(src: Path, tag: str) -> ctypes.CDLL:
    out = _build.BUILD_DIR.parent / "ssd_ab" / f"libssd_{tag}.so"
    out.parent.mkdir(parents=True, exist_ok=True)
    subprocess.run([_build.nvcc(), *_build.NVCC_FLAGS, "-o", str(out),
                    str(src)], check=True, capture_output=True)
    return ssd.declare(ctypes.CDLL(str(out)))


def main(argv):
    if not torch.cuda.is_available():
        raise SystemExit("tools/ssd_ab.py needs a card")
    srcs = [Path(argv[0]), Path(argv[1]) if len(argv) > 1 else
            _build.CSRC / "ssd_scan.cu"]
    libs = {tag: build(src, tag) for tag, src in zip("ab", srcs)}
    dev = torch.device("cuda", 0)
    B, S, H, G, N, P, Q = chip_smoke.SERVE_SHAPE
    spec, (x, dt, Bm, Cm, A), _ = chip_smoke.ssd_case(
        chip_smoke.SERVE_SHAPE, 7, torch.bfloat16, False, dev)
    y = torch.empty((B, S, H, P), device=dev)
    h = torch.empty((B, H, N, P), device=dev)
    stream = torch.cuda.current_stream(dev).cuda_stream

    def run(tag):
        rc = libs[tag].repro_ssd_scan(
            0, x.data_ptr(), dt.data_ptr(), Bm.data_ptr(), Cm.data_ptr(),
            A.data_ptr(), None, y.data_ptr(), h.data_ptr(), 1, 0, B, S, H,
            G, N, P, Q, stream)
        if rc:
            raise RuntimeError(f"{tag}: launch failed ({rc})")

    py, ph = ssd.ssd_scan_plain(spec, x, dt, Bm, Cm, A)
    for tag, src in zip("ab", srcs):
        run(tag)
        torch.cuda.synchronize()
        same = torch.equal(y, py) and torch.equal(h, ph)
        err = max(float((y - py).abs().max()), float((h - ph).abs().max()))
        print(f"{tag} ({src}): equal to ssd_scan_plain bit for bit: {same} "
              f"(max|diff| {err:.3e})", flush=True)
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
    name = torch.cuda.get_device_name(0)
    for tag in "ab":
        print(f"{tag}: ms per launch " + ", ".join(f"{m:.4f}" for m in ms[tag])
              + f"; median {statistics.median(ms[tag]):.4f} [{name}]")


if __name__ == "__main__":
    main(sys.argv[1:])
