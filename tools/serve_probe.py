"""Two probes of the serving path's decode on the card.

    python3 tools/serve_probe.py

1. Host synchronisations: one decode step of each REDUCED model under
   `torch.cuda.set_sync_debug_mode("warn")`, counted by the source line
   that issued them (a synchronising operation stops the host from
   running ahead of the card; the mode is a prototype and may miss some).
2. qwen3-moe-30b-a3b's MoE FFN at its decode shape (8 tokens, bf16,
   random parameters): device and host milliseconds of `moe.route`,
   `moe.dispatch`, `moe.experts`, one of its `torch.bmm`, `moe.combine`
   and the whole `moe.moe_block` (CUDA events over 20 calls after a
   warm-up; host time by the wall clock around the same calls and a
   synchronise), and the bmm's achieved bytes per second.

Prints the card's name and power limit.  Needs a card.
"""
import collections
import subprocess
import sys
import time
import warnings
from pathlib import Path

sys.path.insert(0, str(Path(__file__).resolve().parents[1] / "src"))

import torch  # noqa: E402

from repro_torch import configs  # noqa: E402
from repro_torch.models import api, moe  # noqa: E402

SYNC_ARCHS = ("qwen3-1.7b", "qwen3-moe-30b-a3b", "whisper-medium",
              "mamba2-130m", "zamba2-2.7b")
REPS = 20


def count_syncs(dev):
    for arch in SYNC_ARCHS:
        cfg = configs.get_reduced(arch)
        params = api.init(0, cfg, device=dev)
        batch = {"tokens": torch.randint(0, cfg.vocab_size, (8, 12),
                                         device=dev)}
        if cfg.family == "encdec":
            batch["frame_embeds"] = torch.randn((8, 64, cfg.d_model),
                                                device=dev)
        _, cache = api.prefill(params, cfg, batch, 16)
        tok = batch["tokens"][:, -1:]
        _, cache = api.decode_step(params, cfg, tok, cache)
        torch.cuda.synchronize()
        torch.cuda.set_sync_debug_mode("warn")
        try:
            with warnings.catch_warnings(record=True) as caught:
                warnings.simplefilter("always")
                api.decode_step(params, cfg, tok, cache)
        finally:
            torch.cuda.set_sync_debug_mode(0)
        where = collections.Counter(
            f"{w.filename.split('src/')[-1]}:{w.lineno}" for w in caught)
        print(f"[sync] {arch} ({cfg.num_layers} layers): {len(caught)} "
              f"synchronising operations in one decode step: {dict(where)}",
              flush=True)


def device_and_host_ms(fn):
    fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    t0 = time.perf_counter()
    start.record()
    for _ in range(REPS):
        fn()
    end.record()
    torch.cuda.synchronize()
    wall = (time.perf_counter() - t0) / REPS * 1e3
    return start.elapsed_time(end) / REPS, wall


def moe_decode_pieces(dev, smi):
    cfg = configs.get("qwen3-moe-30b-a3b")
    p = moe.init_moe(torch.Generator(device=dev).manual_seed(0), cfg)
    x = torch.randn((8, 1, cfg.d_model), device=dev).to(torch.bfloat16)
    x2d = x.reshape(8, -1)
    idx, w, _ = moe.route(p, cfg, x2d)
    C = moe.capacity(8, cfg)
    d = moe.dispatch(cfg, x2d, idx, w, C)
    out = moe.experts(p, d.buf)
    pieces = (
        ("route", lambda: moe.route(p, cfg, x2d)),
        ("dispatch", lambda: moe.dispatch(cfg, x2d, idx, w, C)),
        ("experts", lambda: moe.experts(p, d.buf)),
        ("one bmm", lambda: torch.bmm(d.buf, p["w_gate"])),
        ("combine", lambda: moe.combine(d, out, 8, cfg.experts_per_tok,
                                        x.dtype)),
        ("moe_block", lambda: moe.moe_block(p, cfg, x)))
    for name, fn in pieces:
        dev_ms, host_ms = device_and_host_ms(fn)
        extra = ""
        if name == "one bmm":
            nbytes = p["w_gate"].numel() * p["w_gate"].element_size()
            extra = (f"; reads {nbytes / 1e9:.3f} GB of weights: "
                     f"{nbytes / dev_ms / 1e9:.2f} TB/s")
        print(f"[moe-decode] {name} at (8 tokens, C {C}): device "
              f"{dev_ms:.3f} ms, host {host_ms:.3f} ms a call (mean of "
              f"{REPS}){extra} [{smi}]", flush=True)


def main():
    if not torch.cuda.is_available():
        print("serve_probe: needs a CUDA card", file=sys.stderr)
        return 2
    torch.backends.cuda.matmul.allow_tf32 = False
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True, timeout=60).stdout.strip().splitlines()[0]
    print(smi, flush=True)
    dev = torch.device("cuda", 0)
    count_syncs(dev)
    moe_decode_pieces(dev, smi)
    return 0


if __name__ == "__main__":
    sys.exit(main())
