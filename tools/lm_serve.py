"""The language-model phases of `chip_smoke.py` on the card, without the
stencil phases: kernel B2 against its plain version
(`kernel-vs-plain-ssd`, `kernels-ssd-zamba2`), then the serve phases
(mamba2-130m, zamba2-2.7b, qwen3-1.7b, qwen3-moe-30b-a3b, whisper-medium,
llava-next-mistral-7b at their published widths and depth, each with its
float32 checks).

    python3 tools/lm_serve.py [--only serve-qwen3moe,serve-whisper]
    python3 tools/lm_serve.py --profile [--only serve-zamba2] [--steps 4]

`--only` names serve phases; B2's phases always run first (they make the
kernels-line entries whose launches the serve phases count).  Builds only
the SSD scan's library.  Ends with the kernels line for B2.

`--profile` instead puts each model's bf16 prefill of one batch (8
prompts drawn as the serve phase draws them, with the stub embeddings of
whisper and llava) and `--steps` decode steps
under `torch.profiler` after a warm-up of the same calls: per call its
wall time (host clock around it and a synchronise), the device time
summed over the card's own events, the device's idle share of the wall
time, B2's and the matrix products' device time, and the events with the
most device time.
"""
import argparse
import json
import sys
import time
from pathlib import Path

sys.path.insert(0, str(Path(__file__).resolve().parents[1]))
sys.path.insert(0, str(Path(__file__).resolve().parent))

import torch  # noqa: E402

import chip_smoke as cs  # noqa: E402  (puts src/ on the path)
from repro_torch.kernels import _build  # noqa: E402


def _sums(rows, *marks):
    """Device ms of the events whose name holds any of `marks`."""
    return sum(ms for name, ms, _ in rows
               if any(m in name.lower() for m in marks))


def profile_serving(phases, steps, smi, dev):
    import numpy as np
    from sharded_profile import profiled

    from repro_torch import configs
    from repro_torch.launch.steps import make_decode_step, make_prefill_step
    from repro_torch.models import api

    for phase in phases:
        cfg = configs.get(cs.SERVE_ARCHS[phase])
        params = api.init(cs.SERVE_SEED, cfg, device=dev)
        if cfg.family in cs.STUB_KEY:
            batch = cs.stub_batches(cfg, dev)[0][0]
        else:
            rng = np.random.RandomState(cs.SERVE_SEED)
            prompts = [rng.randint(0, cfg.vocab_size, size=rng.randint(
                cs.SERVE_PROMPT[0], cs.SERVE_PROMPT[1] + 1)).astype(np.int32)
                for _ in range(cs.SERVE_BATCH)]
            plen = max(len(p) for p in prompts)
            toks = np.zeros((cs.SERVE_BATCH, plen), np.int32)
            for i, p in enumerate(prompts):
                toks[i, plen - len(p):] = p       # left pad, as the engine
            batch = {"tokens": torch.as_tensor(toks, device=dev)}
        shape = tuple(batch["tokens"].shape)
        max_len = cs.serve_max_len(cfg)
        prefill = make_prefill_step(cfg, max_len)
        decode = make_decode_step(cfg)
        state = {}

        def run_prefill():
            state["tok"], state["cache"] = prefill(params, batch)

        def run_decode():
            tok, cache = state["tok"], state["cache"]
            for _ in range(steps):
                tok, cache = decode(params, tok, cache)

        for what, fn in (("prefill", run_prefill),
                         (f"{steps} decode steps", run_decode)):
            wall, device, rows, _ = profiled(fn, top=200)
            b2 = _sums(rows, "ssd_scan")
            mm = _sums(rows, "gemm", "xmma", "cutlass", "gemv", "nvjet")
            cs.say(phase, f"{what} (batch {shape}): wall "
                   f"{wall:.2f} ms, device {device:.2f} ms, idle "
                   f"{max(0.0, 1 - device / wall):.1%}; B2 {b2:.2f} ms, "
                   f"matrix products {mm:.2f} ms, other {device - b2 - mm:.2f}"
                   f" ms [{smi}]")
            for name, ms, calls in rows[:10]:
                cs.say(phase, f"  {ms:9.3f} ms {calls:6d}x {name[:90]}")
        del params, state
        torch.cuda.empty_cache()


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--only", default=None,
                    help="comma list of serve phases, e.g. serve-zamba2")
    ap.add_argument("--profile", action="store_true")
    ap.add_argument("--steps", type=int, default=4)
    args = ap.parse_args()
    phases = (args.only.split(",") if args.only else list(cs.SERVE_ARCHS))
    smi = cs.phase_environment()
    if args.profile:
        _build.build_all(["ssd_scan"])
        profile_serving(phases, args.steps, smi, torch.device("cuda", 0))
        return 0
    dev = torch.device("cuda", 0)
    t0 = time.perf_counter()
    cs.timed("build", _build.build_all, ["ssd_scan"])
    b2 = cs.timed("kernel-vs-plain-ssd", cs.phase_kernel_vs_plain_ssd, dev,
                  smi)
    b2z = cs.timed("kernels-ssd-zamba2", cs.phase_kernels_ssd_zamba2, dev,
                   smi)
    entry = {"serve-mamba2": b2, "serve-zamba2": b2z}
    for phase in phases:
        cs.timed(phase, cs.phase_serve, phase, dev, smi, entry.get(phase))
    cs.say("time", f"total {time.perf_counter() - t0:.1f} s")
    print(json.dumps({"kernels": [b2, b2z]}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
