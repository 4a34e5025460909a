"""The sharded acoustic phases of `chip_smoke.py` on the card, alone:
main-acoustic (the 512^3 acoustic paper case through the entry point,
against its Listing-1 reference), sharded-acoustic (the same case as a 2x2
mesh of shards in one process, kernel B1c with four shard rows a launch)
and sharded-acoustic-ranks (the same mesh one shard a process: four ranks
sharing the card over gloo, B1c with one shard row a launch in each, the
halos exchanged through the host); then sharded-small-ranks, which
`chip_smoke.py` leaves out for its time limit (elastic at 256^3 and the
128^3 acoustic mesh with the overlapped first step and a remainder tile,
each in four ranks against its single-device TB run, and
`SurveyEngine.run_sharded`'s two 128^3 shots in four ranks against `run`).

    python3 tools/sharded_ranks.py

Builds the acoustic and elastic kernels' libraries.
"""
import json
import sys
from pathlib import Path

sys.path.insert(0, str(Path(__file__).resolve().parents[1]))

import torch  # noqa: E402

import chip_smoke as cs  # noqa: E402  (puts src/ on the path)
from repro_torch.kernels import _build  # noqa: E402


def main():
    if not torch.cuda.is_available():
        print("sharded_ranks: needs an NVIDIA card", file=sys.stderr)
        return 2
    smi = cs.phase_environment()
    dev = torch.device("cuda", 0)
    for name, b in _build.build_all(["stencil_tb",
                                     "stencil_tb_elastic"]).items():
        cs.say("build", f"{name}: nvcc {b.seconds:.1f} s")
    fc = cs.full_case("acoustic", dev)
    state, _, tb_ms, kept, _ = cs.timed("main-acoustic", cs.phase_main_path,
                                        fc, smi)
    four = cs.timed("sharded-acoustic", cs.phase_sharded_acoustic, fc, smi,
                    (state, *kept), tb_ms)
    one = cs.timed("sharded-acoustic-ranks", cs.phase_sharded_acoustic_ranks,
                   fc, smi, (state, *kept), four)
    del fc, state, kept
    torch.cuda.empty_cache()
    cs.timed("sharded-small-ranks", cs.phase_sharded_small_ranks, smi, dev)
    print(json.dumps({"kernels": [four, one], "seconds": cs.SECONDS}),
          flush=True)
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
