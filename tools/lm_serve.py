"""The language-model phases of `chip_smoke.py` on the card, without the
stencil phases: kernel B2 against its plain version
(`kernel-vs-plain-ssd`, `kernels-ssd-zamba2`), then the serve phases
(mamba2-130m, zamba2-2.7b, qwen3-1.7b, qwen3-moe-30b-a3b, whisper-medium,
llava-next-mistral-7b at their published widths and depth, each with its
float32 checks).

    python3 tools/lm_serve.py [--only serve-qwen3moe,serve-whisper]
    python3 tools/lm_serve.py --profile [--only serve-zamba2] [--steps 4]
    python3 tools/lm_serve.py --logits-gap [--only serve-zamba2]
    python3 tools/lm_serve.py --tp zamba2-2.7b [--depths 6,18,36]

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

`--logits-gap` instead takes each scanning model's bf16 prefill of that
batch and holds its logits, computed with each of these scans, against
the logits with `ssd_scan_plain`: B2 as the model runs it, B2 again (the
run's own repeatability), B2 forced onto its float32-core schedule (bit
for bit the plain scan), and the plain scan with each element of y moved
by one float32 ulp up or down (`chip_smoke.ulp_scan`): a control, a scan
as far from the plain one as float32 rounding alone.  Prints max|diff| /
max|plain logits| over every position, at the last position (the logits
serving samples from), over the first and the last 64 positions, and
whether the last position's greedy tokens agree.

`--tp ARCH` instead serves ARCH at its published widths in two
model-parallel ranks sharing the card over gloo, as `chip_smoke.py`'s
serve-mamba2-tp2 serves mamba2-130m (`chip_smoke.serve_tp_rank`: the
engine with rules on the (1, 2) mesh, 8 prompts of 256-1024 tokens, 32
new tokens, B2 counted in each rank, the decode steps' model-axis
collectives counted and timed; a float32 batch's prefill and 4 decode
steps' next tokens held equal to one process's, their logits' gap to
one process's printed beside a control's, one process whose scan's y
moves one float32 ulp; the bf16 tokens' agreement).  `--depths` then
repeats the float32 comparison, in the same ranks, with ARCH cut to each
of those numbers of layers (same widths), and prints each depth's gaps
beside its control's: how the gap grows with depth.  The float32 gaps
are printed and not held: at zamba2-2.7b's depth float32 rounding alone
(the control's) reaches 1e-4 of max|logits|, so a bound there cannot
tell a fault from rounding (ROADMAP C10).

What the tool holds is a float64 run of the same comparison (params,
activations, caches; every scan the plain one, as B2 takes no float64;
the ranks' float64 shards made one rank at a time) at each of
F64_DEPTHS layers up to ARCH's own: its next tokens equal one
process's, and its logits within `chip_smoke.SERVE_TP_F64_ROUNDING`
(1e-9) of max|logits| of one process's, float64 rounding alone, which is
inside `chip_smoke.SERVE_TP_TOL` (1e-4) as well.  A larger float64 gap
is a fault of the ranks, and the tool exits non-zero.  Each depth's line
prints its float64 gaps beside the float32 ones and their control's.
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


def first_batch(cfg, dev):
    """The serve phase's first batch of 8: its prompts drawn as the phase
    draws them and left-padded as the engine pads them, or the stub
    families' first batch."""
    import numpy as np

    if cfg.family in cs.STUB_KEY:
        return cs.stub_batches(cfg, dev)[0][0]
    rng = np.random.RandomState(cs.SERVE_SEED)
    prompts = [rng.randint(0, cfg.vocab_size, size=rng.randint(
        cs.SERVE_PROMPT[0], cs.SERVE_PROMPT[1] + 1)).astype(np.int32)
        for _ in range(cs.SERVE_BATCH)]
    plen = max(len(p) for p in prompts)
    toks = np.zeros((cs.SERVE_BATCH, plen), np.int32)
    for i, p in enumerate(prompts):
        toks[i, plen - len(p):] = p       # left pad, as the engine
    return {"tokens": torch.as_tensor(toks, device=dev)}


def logits_gaps(phases, smi, dev):
    from repro_torch import configs
    from repro_torch.models import api

    for phase in phases:
        cfg = configs.get(cs.SERVE_ARCHS[phase])
        if not cs.scan_layers(cfg):
            continue
        params = api.init(cs.SERVE_SEED, cfg, device=dev)
        batch = first_batch(cfg, dev)
        max_len = cs.serve_max_len(cfg)

        def prefill():
            out = api.prefill(params, cfg, batch, max_len)[0].float()
            torch.cuda.synchronize()
            return out

        plain = cs.with_plain_scan(prefill)
        scale = float(plain.abs().max())
        runs = {f"B2 ({cs.scan_schedule(cfg)})": prefill(),
                "B2 again": prefill()}
        with cs.forced_schedule("float32 cores"):
            runs["B2 on the float32 cores"] = prefill()
        runs["plain, y moved 1 ulp"] = cs.with_scan(cs.ulp_scan(), prefill)
        cs.say(phase, f"bf16 prefill logits {tuple(plain.shape)}, max|plain "
               f"logits| {scale:.3f}; max|diff| / max|plain logits| against "
               f"the plain scan's [{smi}]")
        for name, got in runs.items():
            d = (got - plain).abs()
            by_pos = d.amax(dim=(0, 2)) / scale
            same = bool((got[:, -1].argmax(-1)
                         == plain[:, -1].argmax(-1)).all())
            cs.say(phase, f"  {name}: all positions {float(by_pos.max()):.3e}"
                   f", last {float(by_pos[-1]):.3e}, first 64 "
                   f"{float(by_pos[:64].max()):.3e}, last 64 "
                   f"{float(by_pos[-64:].max()):.3e}; last position's greedy "
                   f"tokens equal: {same}")
        del params, runs, plain
        torch.cuda.empty_cache()


def profile_serving(phases, steps, smi, dev):
    from sharded_profile import profiled

    from repro_torch import configs
    from repro_torch.launch.steps import make_decode_step, make_prefill_step
    from repro_torch.models import api

    for phase in phases:
        cfg = configs.get(cs.SERVE_ARCHS[phase])
        params = api.init(cs.SERVE_SEED, cfg, device=dev)
        batch = first_batch(cfg, dev)
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


# the depths of the float64 pass, in layers (zamba2-2.7b's 54 the last)
F64_DEPTHS = (6, 18, 36, 54)


def say_f64(phase, cfg, sv, f64_depths, smi):
    """The float64 pass's lines, each depth's gaps beside the float32
    ones at that depth and their control's where the float32 comparison
    ran there; holds the next tokens equal and every float64 gap to
    float64 rounding alone (SERVE_TP_F64_ROUNDING, inside
    SERVE_TP_TOL)."""
    f32 = dict(sv["depths"])
    f32[cfg.num_layers] = sv
    worst = 0.0
    for d in f64_depths:
        r = sv["f64"][d]
        worst = max(worst, max(r["f64_gaps"]))
        beside = ""
        if d in f32:
            beside = ("; float32 " + ", ".join(
                f"{g:.2e}" for g in f32[d]["f32_gaps"]) + ", its control "
                + ", ".join(f"{g:.2e}" for g in f32[d]["f32_control_gaps"]))
        cs.say(phase, f"float64 ({r['f64_dtype']} logits) at {d} of "
               f"{cfg.num_layers} layers: logits max|diff| / max|one "
               "process| " + ", ".join(f"{g:.2e}" for g in r["f64_gaps"])
               + f"{beside}; next tokens equal {r['f64_tokens_equal']}; "
               f"rank 0's peak {r['f64_peak_gib']:.2f} GiB [{smi}]")
        if not (r["f64_tokens_equal"]
                and max(r["f64_gaps"]) <= cs.SERVE_TP_F64_ROUNDING):
            raise AssertionError(
                f"{phase}: float64 check failed at {d} layers: gaps "
                f"{r['f64_gaps']} (limit {cs.SERVE_TP_F64_ROUNDING:g}, "
                "float64 rounding alone: a fault of the ranks, ROADMAP "
                f"C10), next tokens equal {r['f64_tokens_equal']}")
    cs.say(phase, f"float64 gaps at most {worst:.2e} (limit "
           f"{cs.SERVE_TP_F64_ROUNDING:g}, float64 rounding alone; "
           f"SERVE_TP_TOL {cs.SERVE_TP_TOL:g}): the float32 gap is "
           "accumulated rounding (ROADMAP C10)")


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--only", default=None,
                    help="comma list of serve phases, e.g. serve-zamba2")
    ap.add_argument("--profile", action="store_true")
    ap.add_argument("--steps", type=int, default=4)
    ap.add_argument("--logits-gap", action="store_true")
    ap.add_argument("--tp", default=None, metavar="ARCH",
                    help="serve ARCH in two model-parallel ranks")
    ap.add_argument("--depths", default="", metavar="L,L",
                    help="with --tp: the float32 comparison also at these "
                    "depths")
    args = ap.parse_args()
    phases = (args.only.split(",") if args.only else list(cs.SERVE_ARCHS))
    smi = cs.phase_environment()
    if args.logits_gap:
        _build.build_all(["ssd_scan"])
        logits_gaps(phases, smi, torch.device("cuda", 0))
        return 0
    if args.tp:
        from repro_torch import configs
        from repro_torch.distributed import process_group

        cs.timed("build", _build.build_all, ["ssd_scan"])
        phase = f"serve-tp2 {args.tp}"
        cfg = configs.get(args.tp)
        depths = [int(d) for d in args.depths.split(",") if d]
        f64_depths = [d for d in F64_DEPTHS if d <= cfg.num_layers]
        t0 = time.perf_counter()
        serve = process_group.spawn_ranks(
            cs.serve_tp_only, cs.TP_WORLD, (args.tp, depths, f64_depths),
            timeout=1800.0, env={"MASTER_ADDR": "localhost",
                                 "MASTER_PORT": str(cs.free_port())})
        cs.say("time", f"{phase} {time.perf_counter() - t0:.1f} s for the "
               "ranks")
        for d in depths:
            r = serve[0]["depths"][d]
            cs.say(phase, f"float32 at {d} of {cfg.num_layers} layers: "
                   "logits max|diff| / max|one process| " + ", ".join(
                       f"{g:.2e}" for g in r["f32_gaps"])
                   + "; the control's " + ", ".join(
                       f"{g:.2e}" for g in r["f32_control_gaps"])
                   + f"; next tokens equal {r['f32_tokens_equal']}")
        cs.say_serve_tp(phase, cfg, serve, smi)
        say_f64(phase, cfg, serve[0], f64_depths, smi)
        return 0
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
