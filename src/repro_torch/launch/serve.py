"""Serving launcher: batched greedy generation with the family's cache
(port of `repro.launch.serve`): the text-in families, ssm, hybrid, dense
and moe (mamba2-130m, zamba2-2.7b, qwen3-1.7b, qwen2-7b, granite-34b,
stablelm-12b, qwen3-moe-30b-a3b, dbrx-132b).  The vlm and encdec families
need stub embeddings in their batches, which the engine does not take: the
CLI refuses them, as the reference's does.

    PYTHONPATH=src python -m repro_torch.launch.serve --arch zamba2-2.7b \
        --reduced --num-requests 8 --max-new 16 --device cpu

Without ``--device cpu`` it runs on the card (and raises without one).
Parameters are random, drawn from ``--seed``.
"""
import argparse
import time


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", required=True)
    ap.add_argument("--reduced", action="store_true")
    ap.add_argument("--num-requests", type=int, default=8)
    ap.add_argument("--prompt-len", type=int, default=16)
    ap.add_argument("--max-new", type=int, default=16)
    ap.add_argument("--batch", type=int, default=8)
    ap.add_argument("--device", default="cuda")
    ap.add_argument("--seed", type=int, default=0)
    args = ap.parse_args(argv)

    import numpy as np
    import torch

    from repro_torch import configs
    from repro_torch._device import resolve_device
    from repro_torch.configs.base import ShapeConfig
    from repro_torch.models import api
    from repro_torch.serving import GenerationEngine, Request

    dev = resolve_device(args.device)
    if dev.type == "cuda":
        torch.backends.cuda.matmul.allow_tf32 = False
        torch.backends.cudnn.allow_tf32 = False
    cfg = (configs.get_reduced(args.arch) if args.reduced
           else configs.get(args.arch))
    if cfg.family in ("vlm", "encdec"):
        raise SystemExit(f"{args.arch}: the serve CLI takes the text-in "
                         "families; the vlm and encdec batches carry stub "
                         "embeddings (launch.steps takes them)")
    shape = ShapeConfig("serve_cli", args.prompt_len + args.max_new,
                        args.batch, "prefill")
    params = api.init(args.seed, cfg, shape, device=dev)
    engine = GenerationEngine(params, cfg,
                              max_len=args.prompt_len + args.max_new,
                              batch_size=args.batch, device=dev)

    rng = np.random.RandomState(args.seed)
    pending = [Request(prompt=rng.randint(
        0, cfg.vocab_size, size=rng.randint(4, args.prompt_len + 1)
    ).astype(np.int32), max_new_tokens=args.max_new)
        for _ in range(args.num_requests)]

    t0 = time.time()
    done = 0
    while pending:
        batch_reqs = pending[:args.batch]
        pending = pending[args.batch:]
        engine.generate(batch_reqs)
        done += len(batch_reqs)
        for i, r in enumerate(batch_reqs):
            print(f"req[{done - len(batch_reqs) + i}] "
                  f"prompt_len={r.prompt.shape[0]} -> {r.output.tolist()}")
    dt = time.time() - t0
    total_tokens = done * args.max_new
    print(f"served {done} requests, {total_tokens} tokens in {dt:.2f}s "
          f"({total_tokens / dt:.1f} tok/s) on {dev}")
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
