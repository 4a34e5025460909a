"""Fault-tolerant training launcher (port of `repro.launch.train`), on
one device or across processes: data-parallel, tensor/expert-parallel
(--model-axis), or both.

    PYTHONPATH=src python -m repro_torch.launch.train --arch qwen3-1.7b \
        --reduced --steps 200 --ckpt-dir /tmp/ckpt --save-every 50 \
        [--device cpu]
    PYTHONPATH=src python -m torch.distributed.run --standalone \
        --nproc-per-node 2 -m repro_torch.launch.train --arch mamba2-130m \
        --reduced --device cpu --dist-backend gloo --steps 4 \
        [--model-axis 2]

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

Across processes: started as several processes (``WORLD_SIZE`` above 1,
`torch.distributed.run`'s environment), each rank joins the group
(`distributed.process_group.DataParallel`, backend --dist-backend: nccl
needs one card a rank, gloo lets ranks share one and runs on the CPU) on
a (WORLD_SIZE / --model-axis, --model-axis) mesh of (data, model) axes,
takes rank 0's initial params whole and keeps its shards of them
(`distributed.sharding.shard_of` under the rules' specs: a model axis
splits heads, FFN widths, experts and the vocabulary), trains on the rows
of its data coordinate of the same global batch
(`data.pipeline.rank_batch`: --batch is global; the model axis's ranks
take the same rows), and steps with `launch.steps.make_train_step(cfg,
opt_cfg, rules)`: the model's Megatron collectives over the model axis,
gradients summed over the data axis, ZeRO-1 optimizer state (this rank's
shard).  Checkpoints hold the global content, gathered from the ranks'
shards and written by rank 0; a resumed run restores its own shards
(`CheckpointManager.restore_sharded`), so a job may resume at another
data or model size (elastic: 2 -> 1, 1 -> 2, TP-2 -> 1, 1 -> TP-2).  The
straggler decision is agreed by the ranks (an incident on any rank is
one on all), so they checkpoint and exit 75 together.  Rank 0 prints and
writes the metrics.
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
    ap.add_argument("--dist-backend", choices=["nccl", "gloo"],
                    default="nccl",
                    help="torch.distributed backend when WORLD_SIZE > 1 "
                         "(nccl: one card a rank; gloo: ranks may share a "
                         "card, or run on the CPU)")
    return ap.parse_args(argv)


def main(argv=None):
    args = parse_args(argv)
    from repro_torch.distributed import process_group

    world = process_group.world_size()
    if world == 1:
        if args.model_axis > 1:
            raise ValueError(f"--model-axis {args.model_axis} needs that "
                             "many processes (WORLD_SIZE); this is one")
        return _train(args, None)
    if args.mesh != "host":
        raise ValueError(f"--mesh {args.mesh} runs one process; "
                         f"WORLD_SIZE={world} takes --mesh host")
    group = process_group.DataParallel.start(args.dist_backend, args.device)
    try:
        return _train(args, group)
    finally:
        group.close()


def _train(args, group):
    import torch

    from repro_torch import configs
    from repro_torch._device import resolve_device
    from repro_torch.checkpoint import CheckpointManager
    from repro_torch.configs.base import ShapeConfig
    from repro_torch.data.pipeline import rank_batch
    from repro_torch.distributed import ShardingRules
    from repro_torch.distributed.sharding import mesh_coords, shard_of
    from repro_torch.launch import mesh as mesh_lib
    from repro_torch.launch import steps
    from repro_torch.models import api
    from repro_torch.optim import AdamWConfig, adamw_init
    from repro_torch.optim.adamw import (AdamWState, zero1_init,
                                         zero1_gather_state)
    from repro_torch.tree import tree_map

    dev = group.device if group else resolve_device(args.device)
    rank = group.rank if group else 0
    lead = rank == 0
    cfg = (configs.get_reduced(args.arch) if args.reduced
           else configs.get(args.arch))
    shape = ShapeConfig("train_cli", args.seq_len, args.batch, "train")
    opt_cfg = AdamWConfig(lr=args.lr, warmup_steps=max(args.steps // 20, 1),
                          total_steps=args.steps)

    params = api.init(0, cfg, shape, device=dev)
    rules = mesh = None
    data_rank, dp, tp = 0, 1, 1
    if group is None:
        opt_state = adamw_init(params)
    else:
        mesh = mesh_lib.make_host_mesh(model=args.model_axis, group=group)
        rules = ShardingRules(mesh=mesh, cfg=cfg)
        data_rank, dp = (mesh.axis_groups["data"].rank,
                         mesh.axis_groups["data"].world)
        tp = mesh.shape["model"]
        group.broadcast_(params)
        whole = params
        pspecs = rules.param_pspecs(whole)
        zspecs = steps.zero1_specs(rules, whole)
        shapes = tree_map(lambda p: tuple(p.shape), whole)
        opt_state = zero1_init(whole, zspecs, mesh, rank)
        coords = mesh_coords(mesh, rank)
        params = tree_map(lambda p, s: shard_of(p, s, coords, mesh), whole,
                          pspecs)
        del whole
    start_step = 0

    def saved_tree():
        """The checkpoint's global content (under a group, every rank
        gathers the params' model-axis shards and the ZeRO-1 shards;
        rank 0 writes)."""
        if group is None:
            return {"params": params, "opt": opt_state}
        return {"params": group.gather(params, pspecs, mesh, shapes),
                "opt": zero1_gather_state(opt_state, zspecs, group, mesh,
                                          shapes)}

    mgr = None
    if args.ckpt_dir:
        mgr = CheckpointManager(args.ckpt_dir, keep=args.keep, group=group)
        latest = mgr.latest_step()
        if latest is not None:
            if group is None:
                _, restored = mgr.restore({"params": params,
                                           "opt": opt_state})
            else:
                whole = tree_map(lambda p, n: torch.empty(
                    n, dtype=p.dtype, device=dev), params, shapes)
                like = {"params": whole, "opt": AdamWState(
                    opt_state.step, whole, whole, whole)}
                specs = {"params": pspecs,
                         "opt": AdamWState((), zspecs, zspecs, zspecs)}
                _, restored = mgr.restore_sharded(like, specs, mesh, rank)
            params, opt_state = restored["params"], restored["opt"]
            start_step = latest
            if lead:
                print(f"resumed from checkpoint step {latest}", flush=True)

    step_fn = steps.make_train_step(cfg, opt_cfg, rules)

    metrics_path = (os.path.join(args.ckpt_dir, "metrics.jsonl")
                    if args.ckpt_dir and lead else None)
    mfile = open(metrics_path, "a") if metrics_path else None
    try:
        ewma, incidents = None, 0
        stop_at = min(args.steps, args.stop_after or args.steps)
        for step in range(start_step, stop_at):
            t0 = time.time()
            batch = rank_batch(cfg, shape, step, data_rank, dp, device=dev)
            params, opt_state, metrics = step_fn(params, opt_state, batch)
            loss = float(metrics["loss"])
            dt_step = time.time() - t0

            # ---- straggler detection (agreed across the ranks) ----------
            slow = (ewma is not None and dt_step > args.deadline_factor * ewma
                    and step > start_step + 3)
            if group is not None:
                slow = bool(group.max(float(slow)) > 0)
            if slow:
                incidents += 1
                if lead:
                    print(f"[straggler] step {step} took {dt_step:.2f}s "
                          f"(ewma {ewma:.2f}s), incident {incidents}",
                          flush=True)
                if mgr and incidents >= args.max_incidents:
                    mgr.save(step + 1, saved_tree(), blocking=True)
                    if lead:
                        print("[straggler] checkpoint-and-exit for "
                              "resharding", flush=True)
                    return 75
            ewma = dt_step if ewma is None else 0.9 * ewma + 0.1 * dt_step

            if lead and (step % args.log_every == 0
                         or step == args.steps - 1):
                print(f"step {step} loss {loss:.4f} "
                      f"lr {float(metrics['lr']):.2e} "
                      f"gnorm {float(metrics['grad_norm']):.2f} "
                      f"{dt_step*1e3:.0f}ms dp={dp}"
                      + (f" tp={tp}" if tp > 1 else ""), flush=True)
            if mfile:
                mfile.write(json.dumps({"step": step, "loss": loss,
                                        "t": dt_step}) + "\n")
                mfile.flush()
            if mgr and (step + 1) % args.save_every == 0:
                mgr.save(step + 1, saved_tree(), blocking=False)

        if mgr:
            mgr.save(stop_at, saved_tree(), blocking=True)
    finally:
        if mgr:
            mgr.wait()
        if mfile:
            mfile.close()
    if lead:
        if stop_at < args.steps:
            print(f"stopped (simulated preemption) at step {stop_at}",
                  flush=True)
        else:
            print("training complete", flush=True)
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
