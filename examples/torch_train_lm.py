"""End-to-end LM training on the port: a trimmed Mamba2 on the
synthetic Markov stream for a few hundred steps; the loss must drop well
below its start.  On the card by default (the scan's forward is kernel
B2); --device cpu runs its plain version.

    PYTHONPATH=src python examples/torch_train_lm.py [--steps 300] \
        [--device cpu]

(Any arch works via --arch; mamba2-130m at trimmed width is the default
because it is the fastest ~100M-class config.)
"""
import argparse
import dataclasses


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--steps", type=int, default=300)
    ap.add_argument("--arch", default="mamba2-130m")
    ap.add_argument("--width", type=int, default=256)
    ap.add_argument("--layers", type=int, default=4)
    ap.add_argument("--seq-len", type=int, default=128)
    ap.add_argument("--batch", type=int, default=8)
    ap.add_argument("--vocab", type=int, default=1024)
    ap.add_argument("--device", default="cuda",
                    help="cuda (default) or cpu")
    args = ap.parse_args(argv)

    from repro_torch import configs
    from repro_torch.configs.base import ShapeConfig
    from repro_torch.data.pipeline import make_batch
    from repro_torch.launch.steps import make_train_step
    from repro_torch.models import api
    from repro_torch.optim import AdamWConfig, adamw_init
    from repro_torch.tree import tree_leaves

    base = configs.get(args.arch)
    cfg = dataclasses.replace(
        base, d_model=args.width, num_layers=args.layers,
        vocab_size=args.vocab, param_dtype="float32", activation_dtype="float32",
        ssm_headdim=32, ssm_state=32, ssm_chunk=32)
    shape = ShapeConfig("example", args.seq_len, args.batch, "train")
    params = api.init(0, cfg, shape, device=args.device)
    n_params = sum(x.numel() for x in tree_leaves(params))
    print(f"{cfg.name} trimmed: {n_params/1e6:.1f}M params")

    opt_cfg = AdamWConfig(lr=1e-3, warmup_steps=20, total_steps=args.steps)
    opt_state = adamw_init(params)
    step_fn = make_train_step(cfg, opt_cfg)

    first = None
    for step in range(args.steps):
        batch = make_batch(cfg, shape, step=step, device=args.device)
        params, opt_state, metrics = step_fn(params, opt_state, batch)
        loss = float(metrics["loss"])
        if first is None:
            first = loss
        if step % 25 == 0 or step == args.steps - 1:
            print(f"step {step:4d} loss {loss:.4f}")
    print(f"loss: {first:.3f} -> {loss:.3f}")
    assert loss < first * 0.8, "training failed to reduce loss"
    print("OK")


if __name__ == "__main__":
    main()
