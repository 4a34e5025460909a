"""The training phases of `chip_smoke.py` on the card, alone:
train-mamba2 (kernel B2 under a gradient at mamba2-130m's and
zamba2-2.7b's head shapes, the float32 model step with B2 against the
plain scan, and the trainer's CLI for mamba2-130m at full width, 8 x 4096
tokens a step, with a simulated preemption and a resume, then one step
under `torch.profiler`), train-mamba2-dp2 (the CLI in two
data-parallel ranks on the one card, resumed in one process, and its
float32 check, then train-mamba2-fsdp2 and train-zamba2-fsdp2 in the
same ranks) and train-mamba2-tp2 (the CLI in two model-parallel ranks,
resumed in one process, then tp2-qwen3moe and serve-mamba2-tp2 in the
same ranks), then kernels-ssd-serve-tp2 and kernels-ssd-fsdp-zamba2 (B2
at a serving rank's call and at an FSDP rank's) and dryrun-vs-card (the
dry run's predictions of those ranks' steps and of serve-mamba2's
prefill against the card's counts).

    python3 tools/lm_train.py

Builds only the SSD scan's library.  The CLI's step counts are
`chip_smoke.TRAIN_STEPS` / `TRAIN_STOP`.
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
        print("lm_train: needs an NVIDIA card", file=sys.stderr)
        return 2
    smi = cs.phase_environment()
    dev = torch.device("cuda", 0)
    built = _build.build_all(["ssd_scan"])["ssd_scan"]
    cs.say("build", f"ssd_scan: nvcc {built.seconds:.1f} s")
    entry = {}
    out = cs.timed("train-mamba2", cs.phase_train, dev, smi, entry)
    dp2 = cs.timed("train-mamba2-dp2", cs.phase_train_dp, dev, smi, entry,
                   out["losses"])
    tp2 = cs.timed("train-mamba2-tp2", cs.phase_train_tp, dev, smi, entry,
                   out["losses"])
    serve = cs.timed("kernels-ssd-serve-tp2", cs.phase_kernels_ssd_serve_tp2,
                     dev, smi)
    fsdp = cs.timed("kernels-ssd-fsdp-zamba2",
                    cs.phase_kernels_ssd_fsdp_zamba2, dev, smi)
    cs.timed("dryrun-vs-card", cs.phase_dryrun_vs_card, dev, smi)
    print(json.dumps({"train-mamba2": out, "train-mamba2-dp2": dp2,
                      "train-mamba2-tp2": tp2, "serve-tp2": serve,
                      "fsdp-zamba2": fsdp, "b2": entry}), flush=True)
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
