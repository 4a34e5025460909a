"""Serve a small LM with batched requests through the port's
GenerationEngine (PyTorch; the card by default).

    PYTHONPATH=src python examples/torch_serve_lm.py [--arch qwen3-1.7b] \
        [--device cpu]

Shows: mixed-length prompts left-padded into one batch, one prefill, then
cached greedy decode; per-request EOS handling; throughput accounting.
The REDUCED config with random weights from seed 0.
"""
import argparse
import time

import numpy as np

from repro_torch import configs
from repro_torch.configs.base import ShapeConfig
from repro_torch.models import api
from repro_torch.serving.engine import GenerationEngine, Request


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", default="qwen3-1.7b")
    ap.add_argument("--batch", type=int, default=4)
    ap.add_argument("--max-new", type=int, default=12)
    ap.add_argument("--device", default="cuda",
                    help="cuda (default) or cpu")
    args = ap.parse_args(argv)

    cfg = configs.get_reduced(args.arch)
    max_len = 64
    shape = ShapeConfig("serve", max_len, args.batch, "prefill")
    params = api.init(0, cfg, shape, device=args.device)
    engine = GenerationEngine(params, cfg, max_len=max_len,
                              batch_size=args.batch, device=args.device)

    rng = np.random.RandomState(0)
    reqs = [Request(prompt=rng.randint(0, cfg.vocab_size,
                                       size=ln).astype(np.int32),
                    max_new_tokens=args.max_new, eos_id=0)
            for ln in (5, 11, 17, 23)[:args.batch]]
    t0 = time.time()
    engine.generate(reqs)
    dt = time.time() - t0
    total = 0
    for i, r in enumerate(reqs):
        print(f"req[{i}] prompt={r.prompt.shape[0]} tokens "
              f"-> generated {r.output.shape[0]}: {r.output.tolist()}")
        total += r.output.shape[0]
    print(f"{total} tokens in {dt:.2f}s ({total/dt:.1f} tok/s, "
          f"batch={args.batch})")
    print("OK")


if __name__ == "__main__":
    main()
