"""Fault-tolerant training launcher (port of `repro.launch.train`), one
device.

    PYTHONPATH=src python -m repro_torch.launch.train --arch qwen3-1.7b \
        --reduced --steps 200 --ckpt-dir /tmp/ckpt --save-every 50 \
        [--device cpu]

The reference's flags and behaviour, on the card by default (``--device
cuda``; without a card that raises, with no CPU fallback):

  * **checkpoint/restart**: atomic commits every --save-every steps (the
    writer thread of `checkpoint.CheckpointManager`); on start, resume
    from the newest committed checkpoint, printing ``resumed from
    checkpoint step N``: a preempted job relaunches with the same command
    line.  --stop-after N checkpoints and exits after step N (a simulated
    preemption; the schedule's horizon stays --steps).
  * **exact restart**: the data pipeline addresses rows by (step, row),
    so a resumed run replays the same stream.
  * **straggler mitigation**: a step's wall time against an EWMA; a step
    over --deadline-factor x EWMA is an incident, and --max-incidents
    incidents checkpoint and exit with code 75 so a scheduler can reshape
    the job.
  * metrics stream to <ckpt-dir>/metrics.jsonl (one JSON a step).

One process, one device: the reference's multi-host start
(`jax.distributed.initialize`) and its sharded meshes wait for ROADMAP
A9b and the sharding rules.  A ``WORLD_SIZE`` above 1 or --model-axis
above 1 raises `NotImplementedError`; ``--mesh host`` on one device is
the single-device case, as in the reference.
"""
import argparse
import json
import os
import time


def parse_args(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", required=True)
    ap.add_argument("--reduced", action="store_true")
    ap.add_argument("--steps", type=int, default=100)
    ap.add_argument("--stop-after", type=int, default=None,
                    help="checkpoint and exit after this step (simulated "
                         "preemption; schedule horizon stays --steps)")
    ap.add_argument("--seq-len", type=int, default=128)
    ap.add_argument("--batch", type=int, default=8)
    ap.add_argument("--lr", type=float, default=3e-4)
    ap.add_argument("--ckpt-dir", default=None)
    ap.add_argument("--save-every", type=int, default=50)
    ap.add_argument("--keep", type=int, default=3)
    ap.add_argument("--mesh", choices=["host", "single"], default="host")
    ap.add_argument("--model-axis", type=int, default=1)
    ap.add_argument("--deadline-factor", type=float, default=3.0)
    ap.add_argument("--max-incidents", type=int, default=5)
    ap.add_argument("--log-every", type=int, default=10)
    ap.add_argument("--device", default="cuda",
                    help="torch device to train on (default cuda; the CPU "
                         "only when asked: --device cpu)")
    return ap.parse_args(argv)


def _single_device(args):
    """Refuse what needs more than one device (ROADMAP A9b)."""
    world = int(os.environ.get("WORLD_SIZE", "1"))
    if world > 1:
        raise NotImplementedError(
            f"WORLD_SIZE={world}: multi-process training (a torch."
            "distributed process group) waits for ROADMAP A9b")
    if args.model_axis > 1:
        raise NotImplementedError(
            f"--model-axis {args.model_axis}: model-parallel sharding waits "
            "for the sharding rules slice (ROADMAP A9b)")


def main(argv=None):
    args = parse_args(argv)
    _single_device(args)

    from repro_torch import configs
    from repro_torch._device import resolve_device
    from repro_torch.checkpoint import CheckpointManager
    from repro_torch.configs.base import ShapeConfig
    from repro_torch.data.pipeline import make_batch
    from repro_torch.launch import steps
    from repro_torch.models import api
    from repro_torch.optim import AdamWConfig, adamw_init

    dev = resolve_device(args.device)
    cfg = (configs.get_reduced(args.arch) if args.reduced
           else configs.get(args.arch))
    shape = ShapeConfig("train_cli", args.seq_len, args.batch, "train")
    opt_cfg = AdamWConfig(lr=args.lr, warmup_steps=max(args.steps // 20, 1),
                          total_steps=args.steps)

    params = api.init(0, cfg, shape, device=dev)
    opt_state = adamw_init(params)
    start_step = 0

    mgr = None
    if args.ckpt_dir:
        mgr = CheckpointManager(args.ckpt_dir, keep=args.keep)
        latest = mgr.latest_step()
        if latest is not None:
            _, restored = mgr.restore({"params": params, "opt": opt_state})
            params, opt_state = restored["params"], restored["opt"]
            start_step = latest
            print(f"resumed from checkpoint step {latest}", flush=True)

    step_fn = steps.make_train_step(cfg, opt_cfg)

    metrics_path = (os.path.join(args.ckpt_dir, "metrics.jsonl")
                    if args.ckpt_dir else None)
    mfile = open(metrics_path, "a") if metrics_path else None
    try:
        ewma, incidents = None, 0
        stop_at = min(args.steps, args.stop_after or args.steps)
        for step in range(start_step, stop_at):
            t0 = time.time()
            batch = make_batch(cfg, shape, step=step, dp_rank=0, dp_size=1,
                               device=dev)
            params, opt_state, metrics = step_fn(params, opt_state, batch)
            loss = float(metrics["loss"])
            dt_step = time.time() - t0

            # ---- straggler detection -----------------------------------
            if ewma is None:
                ewma = dt_step
            else:
                if dt_step > args.deadline_factor * ewma \
                        and step > start_step + 3:
                    incidents += 1
                    print(f"[straggler] step {step} took {dt_step:.2f}s "
                          f"(ewma {ewma:.2f}s), incident {incidents}",
                          flush=True)
                    if mgr and incidents >= args.max_incidents:
                        mgr.save(step + 1, {"params": params,
                                            "opt": opt_state},
                                 blocking=True)
                        print("[straggler] checkpoint-and-exit for "
                              "resharding", flush=True)
                        return 75
                ewma = 0.9 * ewma + 0.1 * dt_step

            if step % args.log_every == 0 or step == args.steps - 1:
                print(f"step {step} loss {loss:.4f} "
                      f"lr {float(metrics['lr']):.2e} "
                      f"gnorm {float(metrics['grad_norm']):.2f} "
                      f"{dt_step*1e3:.0f}ms dp=1", flush=True)
            if mfile:
                mfile.write(json.dumps({"step": step, "loss": loss,
                                        "t": dt_step}) + "\n")
                mfile.flush()
            if mgr and (step + 1) % args.save_every == 0:
                mgr.save(step + 1, {"params": params, "opt": opt_state},
                         blocking=False)

        if mgr:
            mgr.save(stop_at, {"params": params, "opt": opt_state},
                     blocking=True)
    finally:
        if mgr:
            mgr.wait()
        if mfile:
            mfile.close()
    if stop_at < args.steps:
        print(f"stopped (simulated preemption) at step {stop_at}",
              flush=True)
    else:
        print("training complete", flush=True)
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
