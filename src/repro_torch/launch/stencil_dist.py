"""Sharded multi-physics stencil launcher and self-check (port of
`repro.launch.stencil_dist`).

Runs the sharded temporally-blocked layer (`distributed/halo.py`) for any
registered physics on a `ShardMesh` of `--mesh PXxPY` shards and checks the
result — wavefields and per-step receiver traces — against the port's
single-device Listing-1 reference.

  # on the card (every shard on the visible cards, kernel B1c per pass):
  python -m repro_torch.launch.stencil_dist --check --mesh 2x2 --n 64

  # on the CPU (the kernel's plain version per shard):
  python -m repro_torch.launch.stencil_dist --device cpu --mesh 4x2 \\
      --check --n 32 --nt 8 --T 2

  # two-level plan: inner tile below the shard block, overlapped first
  # step, time-nested (a depth-4 exchange consumed by depth-2 passes):
  python -m repro_torch.launch.stencil_dist --device cpu --check \\
      --inner-tile 4,8 --overlap --T 2 --outer-T 4

  # the joint autotuner picks (T, inner tile, overlap) for the block:
  python -m repro_torch.launch.stencil_dist --device cpu --check --auto-plan

  # dry run on the production mesh (16x16, or 2x16x16 with --multipod) for
  # a 512^3 grid, shapes only: no card needed
  python -m repro_torch.launch.stencil_dist --device cpu --dryrun --multipod

  # one shard a process: --mesh PXxPY over WORLD_SIZE = PX * PY ranks, each
  # holding its block and exchanging halos with its neighbours
  # (`DataParallel.exchange`; nccl needs a card a rank, gloo stages a
  # card's strips through the host); --check gathers the fields on rank 0
  python -m torch.distributed.run --standalone --nproc-per-node 4 \
      -m repro_torch.launch.stencil_dist --mesh 2x2 --device cpu \
      --dist-backend gloo --check

Across ranks every rank runs the same plan: with --auto-plan rank 0 picks
it (`cached_plan_hierarchy`) and broadcasts it.  Rank 0 prints, and with
--telemetry writes the trace and the drift report from its own clock
(every rank runs the measurement).
"""
import argparse
import json
import os
import sys
import time

# one candidate space for --auto-plan (the reference's)
AUTO_TILES = (4, 8, 16, 32, 64, 128)
AUTO_DEPTHS = (1, 2, 4, 8)


def tol_ok(err: float, scale: float) -> bool:
    """The reference launcher's acceptance rule."""
    return err <= 5e-4 * scale + 1e-6


def _build_case(physics_name, shape, order, dt, grid, rng, device):
    """(physics, state tuple, params dict, ref_fn) for one physics: the
    model from `launch.stencil_survey.build_model` (elastic moduli in SI
    units, initial velocities divided by the impedance rho vp so each term
    of the update moves its field visibly), a random initial state, and
    the single-device Listing-1 reference.

    ref_fn(nt, g, gr) -> (state tuple in state_fields order,
                          rec (nt, nrec, rec_channels))."""
    import numpy as np
    import torch

    from repro_torch.core.propagators import elastic as el
    from repro_torch.core.propagators import tti as tt
    from repro_torch.kernels import ref
    from repro_torch.kernels import tb_physics as phys
    from repro_torch.launch.stencil_survey import build_model

    physics = phys.PHYSICS[physics_name]
    params = build_model(physics_name, shape, grid, rng, device=device)
    dev = params[physics.param_fields[0]].device
    state = tuple(torch.as_tensor((0.01 * rng.randn(*shape))
                                  .astype(np.float32), device=dev)
                  for _ in physics.state_fields)
    kw = dict(device=dev)
    if physics_name == "acoustic":
        def ref_fn(nt, g, gr):
            (r0, r1), recs = ref.acoustic_reference(
                nt, state[0], state[1], params["m"], params["damp"], dt,
                grid.spacing, order, g=g, receivers=gr, **kw)
            return (r0, r1), recs[..., None]
    elif physics_name == "tti":
        def ref_fn(nt, g, gr):
            rst, recs = ref.tti_reference(
                nt, tt.TTIState(*state), tt.TTIParams(**params), dt,
                grid.spacing, order, g=g, receivers=gr, **kw)
            return tuple(rst), recs[..., None]
    else:
        impedance = torch.sqrt((params["lam"] + 2 * params["mu"])
                               / params["b"])
        state = tuple(s / impedance if f in ("vx", "vy", "vz") else s
                      for f, s in zip(physics.state_fields, state))

        def ref_fn(nt, g, gr):
            rst, recs = ref.elastic_reference(
                nt, el.ElasticState(*state), el.ElasticParams(**params), dt,
                grid.spacing, order, g=g, receivers=gr, **kw)
            return tuple(rst), recs
    return physics, state, params, ref_fn


def dryrun_sizes(plan, nz: int) -> dict:
    """What one shard of `plan` holds and moves, computed from sizes:
    torch has no compile-time `memory_analysis` / `cost_analysis` (the
    reference reads XLA's), so nothing here is measured or compiled.
    ``shard_fields_bytes``: the state and params over the block padded by
    the exchange halo, and the domain mask; ``launch_bytes``: the largest
    inner pass's kernel launch on one shard row (outputs, receiver
    partials, scratch, the params' copies; `stencil_tb.launch_bytes`);
    ``exchange_bytes_per_tile``: the state fields' deep exchange of one
    time tile at their per-field depths; ``flops_per_step``: the
    propagator's model FLOPs a step over the shard's block."""
    import torch

    from repro_torch.core.temporal_blocking import (PHYSICS_COSTS,
                                                    nested_pass_geometry)
    from repro_torch.kernels import ops
    from repro_torch.kernels import stencil_tb as ker

    physics = plan.physics
    bx, by = plan.block
    h = plan.halo
    item = 4
    padded = (bx + 2 * h) * (by + 2 * h) * nz
    nfields = len(physics.state_fields) + len(physics.param_fields)
    launch = 0
    for geom in nested_pass_geometry(plan.block, plan.inner_tile, plan.T,
                                     plan.inner_T, plan.r_step):
        spec = ops.pass_inner_spec(geom, nz, plan.order, plan.dt,
                                   plan.spacing, 1, 1, torch.float32,
                                   physics)
        launch = max(launch, ker.launch_bytes(spec, physics)
                     + ker.launch_shared_bytes(spec, physics))
    exchange = sum(((bx + 2 * d) * (by + 2 * d) - bx * by) * nz * item
                   for d in plan.field_depths(plan.T))
    flops = PHYSICS_COSTS[physics.name].flops_per_point(plan.order)
    return {"shard_fields_bytes": nfields * padded * item
            + (bx + 2 * h) * (by + 2 * h) * item,
            "launch_bytes": int(launch),
            "exchange_bytes_per_tile": int(exchange),
            "flops_per_step": float(flops * bx * by * nz)}


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--physics", default="acoustic",
                    choices=("acoustic", "tti", "elastic"))
    ap.add_argument("--mesh", default="4x2",
                    help="PXxPY shards along x and y")
    ap.add_argument("--device", default="cuda",
                    help="cuda (every visible card, default; a rank's own "
                         "with --dist-backend) or cpu")
    ap.add_argument("--dist-backend", default=None, choices=("nccl", "gloo"),
                    help="run one shard a process, started by "
                         "torch.distributed.run: --mesh must count "
                         "WORLD_SIZE shards")
    ap.add_argument("--inner", default=None, choices=("torch", "cuda"),
                    help="per-shard executor: the CUDA TB kernel or its "
                         "plain version (default: cuda on a card, torch on "
                         "the CPU)")
    ap.add_argument("--inner-tile", default=None,
                    help="tx,ty spatial tile of the inner trapezoid (must "
                         "divide the shard block); default: one tile "
                         "covering the block")
    ap.add_argument("--outer-T", type=int, default=None, dest="outer_T",
                    help="time-nest the two levels: exchange at this depth "
                         "while --T becomes the inner (per-pass) depth; "
                         "default: flat (outer depth = --T)")
    ap.add_argument("--overlap", action="store_true",
                    help="split the first step of a tile into an interior "
                         "update and rim strips")
    ap.add_argument("--uniform-halo", action="store_true",
                    help="disable per-field exchange depths (ship every "
                         "state field at the full T*r_step)")
    ap.add_argument("--auto-plan", action="store_true",
                    help="joint two-level autotune of T, inner tile and "
                         "overlap for this block (cached_plan_hierarchy)")
    ap.add_argument("--check", action="store_true")
    ap.add_argument("--sweep-T", default=None,
                    help="comma list of T depths; checks per-step receiver "
                         "traces agree across all of them")
    ap.add_argument("--dryrun", action="store_true",
                    help="report the autotuner's plan, the last-run drift "
                         "and the plan for a 512^3 grid on the production "
                         "mesh, with its sizes; shapes only, no card")
    ap.add_argument("--multipod", action="store_true",
                    help="with --dryrun: the 2x16x16 multi-pod mesh")
    ap.add_argument("--interp", default="linear",
                    choices=("linear", "sinc"),
                    help="source/receiver interpolation kernel: trilinear "
                         "or Kaiser-windowed sinc (Hicks 2002)")
    ap.add_argument("--interp-order", type=int, default=None,
                    dest="interp_order",
                    help="sinc support radius r ((2r)**3 grid points per "
                         "off-grid coordinate; default 1 linear / 4 sinc)")
    ap.add_argument("--n", type=int, default=32)
    ap.add_argument("--nt", type=int, default=8)
    ap.add_argument("--T", type=int, default=2)
    ap.add_argument("--order", type=int, default=4)
    ap.add_argument("--telemetry", nargs="?", const="", default=None,
                    metavar="PATH",
                    help="enable telemetry: span collection (Chrome trace "
                         "to PATH, default results/telemetry_dist_torch"
                         ".json) plus a predicted-vs-measured cost-model "
                         "drift report beside it")
    args = ap.parse_args(argv)
    if args.auto_plan and (args.inner_tile or args.overlap or args.sweep_T
                           or args.outer_T):
        ap.error("--auto-plan picks T/inner tile/overlap itself; it cannot "
                 "be combined with --inner-tile, --overlap, --outer-T or "
                 "--sweep-T")
    if args.outer_T and args.sweep_T:
        ap.error("--sweep-T sweeps the exchange depth; it cannot be "
                 "combined with --outer-T")
    if args.dryrun and args.dist_backend:
        ap.error("--dryrun builds shapes only; it runs in one process")
    try:
        pgrid = tuple(int(v) for v in args.mesh.lower().split("x"))
        assert len(pgrid) == 2
    except (ValueError, AssertionError):
        ap.error(f"--mesh {args.mesh!r}: expected PXxPY, e.g. 2x2")
    if not args.dist_backend:
        return _run(args, pgrid, None)
    from repro_torch.distributed.process_group import DataParallel

    group = DataParallel.start(args.dist_backend, args.device)
    try:
        return _run(args, pgrid, group)
    finally:
        group.close()


def _run(args, pgrid, group):
    """The launcher's work on one process's mesh: every shard, or (over
    `group`) this rank's."""
    import numpy as np
    import torch

    from repro_torch import telemetry as tele
    from repro_torch.core import interp as interp_mod
    from repro_torch.core import sources as S
    from repro_torch.core.grid import Grid
    from repro_torch.core.temporal_blocking import HierPlan, TBPlan
    from repro_torch.distributed.halo import (DistTBPlan, dist_plan_from_hier,
                                              gather_blocks, mesh_shift_fns,
                                              sharded_tb_propagate)
    from repro_torch.kernels import tb_physics as phys
    from repro_torch.launch import mesh as mesh_lib
    from repro_torch.launch.dryrun import stencil_plan_report
    from repro_torch.survey.plan_cache import cached_plan_hierarchy

    lead = group is None or group.rank == 0

    def say(*a, **kw):
        if lead:
            print(*a, **kw)

    if args.dryrun:
        mesh = mesh_lib.make_production_mesh(multi_pod=args.multipod)
    elif group is not None:
        mesh = mesh_lib.make_rank_mesh(pgrid, group)
        route = ("the host (pinned buffers)" if group.p2p_route == "host"
                 else "the devices")
        say(f"rank mesh {pgrid[0]}x{pgrid[1]}: one shard a rank, "
            f"{group.world} ranks over {group.backend}, halo strips through "
            f"{route}")
    else:
        mesh = mesh_lib.ShardMesh(pgrid,
                                  devices=mesh_lib.mesh_devices(args.device))
    on_card = mesh.devices[0].type == "cuda"
    inner = args.inner or ("cuda" if on_card else "torch")
    telemetry_path = None
    if args.telemetry is not None:
        tele.enable()
        telemetry_path = args.telemetry or os.path.join(
            "results", "telemetry_dist_torch.json")

    def sync():
        if on_card:
            for d in mesh.devices:
                torch.cuda.synchronize(d)

    def build_plan(shape, grid, physics, order, dt, T):
        """DistTBPlan from the two-level flags (or the joint autotuner
        with --auto-plan)."""
        px, py = mesh.pgrid
        block = (shape[0] // px, shape[1] // py)
        common = dict(inner=inner, per_field_halo=not args.uniform_halo)
        if args.auto_plan:
            # every rank runs one plan: rank 0's pick, broadcast
            picked = [None]
            if lead:
                hier, _entry, info = cached_plan_hierarchy(
                    args.physics, shape[2], order, block, tiles=AUTO_TILES,
                    depths=AUTO_DEPTHS)
                say(f"plan cache {'HIT' if info.hit else 'MISS'} "
                    f"key={info.key}")
                picked = [hier.to_dict()]
            if group is not None and group.world > 1:
                import torch.distributed as dist

                dist.broadcast_object_list(picked, src=group.ranks[0],
                                           group=group.pg)
            hier = HierPlan.from_dict(picked[0])
            say(f"auto-plan: outer T={hier.outer_T} "
                f"inner T={hier.inner.T} inner tile={hier.inner.tile} "
                f"overlap={hier.overlap} "
                f"field depths={hier.field_depths}")
            return dist_plan_from_hier(mesh, shape, physics, order, hier,
                                       dt, grid.spacing, **common)
        # --outer-T decouples the levels: --T is then the inner depth
        T_outer = args.outer_T or T
        inner_plan = None
        if args.inner_tile or T != T_outer:
            tile = (tuple(int(v) for v in args.inner_tile.split(","))
                    if args.inner_tile else block)
            inner_plan = TBPlan(tile, T, physics.step_radius(order))
        return DistTBPlan(mesh=mesh, grid_shape=shape, physics=physics,
                          order=order, T=T_outer, dt=dt,
                          spacing=grid.spacing, inner_plan=inner_plan,
                          overlap=args.overlap, **common)

    if args.dryrun:
        n = 512
        shape = (n, n, n)
        grid = Grid(shape=shape, spacing=(10.0,) * 3)
        px, py = mesh.pgrid
        # the same candidate space as --auto-plan, so with --auto-plan the
        # recommendation below is the plan built
        report = stencil_plan_report(
            args.physics, shape[2], args.order,
            (shape[0] // px, shape[1] // py),
            interp=interp_mod.spec_for(args.interp, args.interp_order),
            tiles=AUTO_TILES, depths=AUTO_DEPTHS)
        print("autotuner recommendation:", json.dumps(report))
        ld = report.get("last_drift")
        if ld:
            ratios = {t: s["geomean_ratio"]
                      for t, s in ld["summary"].items()
                      if s.get("geomean_ratio") is not None}
            print("last-run drift (measured/predicted, "
                  f"{ld['n_records']} rec @ {ld['path']}):",
                  " ".join(f"{t}={v:.3g}x"
                           for t, v in sorted(ratios.items()))
                  or "no finite ratios")
        else:
            print("last-run drift: none recorded — run --telemetry on a "
                  "measured launch to populate it")
        plan = build_plan(shape, grid, phys.PHYSICS[args.physics],
                          args.order, 1e-3, args.T)
        plan.validate()
        print(f"plan: mesh {dict(mesh.shape)} (shard grid {mesh.pgrid}, "
              f"block {plan.block}), outer_T={plan.T} "
              f"inner_T={plan.inner_T} inner_tile={plan.inner_tile} "
              f"overlap={plan.overlap} "
              f"field_depths={plan.field_depths(plan.T)}")
        print("sizes (computed from shapes; torch has no compile-time "
              "memory or cost analysis):",
              json.dumps(dryrun_sizes(plan, shape[2])))
        if telemetry_path:
            print("telemetry trace:",
                  tele.collector().export(telemetry_path))
        print(f"stencil distributed dry-run OK ({args.physics}, "
              f"{'multi' if args.multipod else 'single'}-pod)")
        return 0

    n, nt, order = args.n, args.nt, args.order
    shape = (n, n, n // 2)
    grid = Grid(shape=shape, spacing=(10.0,) * 3)
    dt = grid.cfl_dt(3000.0, order)
    rng = np.random.RandomState(0)
    physics, state, params, ref_fn = _build_case(
        args.physics, shape, order, dt, grid, rng, mesh.devices[0])
    ext = np.asarray(grid.extent)
    ispec = interp_mod.spec_for(args.interp, args.interp_order)
    src = S.SparseOperator(5.0 + rng.rand(3, 3) * (ext - 10.0))
    wav = S.ricker_wavelet(nt, dt, f0=12.0, num=3)
    g = S.precompute(src, grid, wav, interp=ispec, device=mesh.devices[0])
    rec = S.SparseOperator(5.0 + rng.rand(4, 3) * (ext - 10.0))
    gr = S.precompute_receivers(rec, grid, interp=ispec,
                                device=mesh.devices[0])

    def run(T):
        plan = build_plan(shape, grid, physics, order, dt, T)
        with tele.span("dist.propagate", T=T, nt=nt) as sp:
            out = sharded_tb_propagate(plan, nt, state, params, g=g,
                                       receivers=gr)
            sp.sync(out)
        return plan, out

    def measure_drift(plan):
        """Predicted vs measured seconds per point-step for the executed
        plan: total from the whole propagation, exchange from an
        exchange-only run of the same per-field schedule, kernel phase as
        their difference (read against max(compute, memory)).  Across
        ranks every rank runs it and rank 0 reports its own clock."""
        from repro_torch.distributed.halo import (_split_blocks,
                                                  exchange_to_depth)

        bx, by = plan.block
        nz = shape[2]
        times = []
        for _ in range(3):
            sync()
            t0 = time.perf_counter()
            sharded_tb_propagate(plan, nt, state, params, g=g, receivers=gr)
            sync()
            times.append(time.perf_counter() - t0)
        total_pps = min(times) / (bx * by * nz * nt)
        depths = plan.field_depths(plan.T)
        blocks = [_split_blocks(s, plan) for s in state]
        times = []
        for _ in range(5):
            sync()
            t0 = time.perf_counter()
            with tele.span("dist.exchange_bench"):
                for b, d in zip(blocks, depths):
                    exchange_to_depth(b, d, plan.halo,
                                      shift_fns=mesh_shift_fns(plan.mesh))
                sync()
            times.append(time.perf_counter() - t0)
        # one deep exchange buys T steps of the whole shard block
        ex_pps = min(times) / (bx * by * nz * plan.T)
        kernel_pps = max(total_pps - ex_pps, 0.0)
        predicted = tele.predict_plan_terms(
            args.physics, nz, order,
            TBPlan(plan.inner_tile, plan.inner_T, plan.r_step),
            outer_T=plan.T, block=plan.block, overlap=plan.overlap)
        measured = {"total_s": total_pps, "exchange_s": ex_pps,
                    "kernel_s": kernel_pps, "compute_s": kernel_pps,
                    "memory_s": kernel_pps}
        ledger = tele.DriftLedger()
        rec = ledger.record(
            {"physics": args.physics, "grid": list(shape), "nt": nt,
             "mesh": dict(mesh.shape), "block": [bx, by],
             "outer_T": plan.T, "inner_T": plan.inner_T,
             "inner_tile": list(plan.inner_tile), "overlap": plan.overlap,
             "inner": inner, "devices": [str(d) for d in mesh.devices]},
            predicted, measured)
        path = (ledger.save(os.path.splitext(telemetry_path)[0]
                            + "_drift.json") if lead else None)
        for what, terms in (("predicted", rec["predicted"]),
                            ("measured ", measured)):
            say(f"drift {what} s/pt-step:",
                json.dumps({k: terms[k] for k in
                            ("compute_s", "memory_s", "exchange_s",
                             "total_s")}))
        say("drift ratio measured/predicted:", json.dumps(rec["ratio"]))
        say("drift report written to", path)

    if args.sweep_T:
        depths = [int(t) for t in args.sweep_T.split(",")]
        traces = {T: run(T)[1][1] for T in depths}
        base = traces[depths[0]]
        scale = float(base.abs().max()) + 1e-30
        ok = True
        for T in depths[1:]:
            err = float((traces[T] - base).abs().max())
            say(f"trace T={T} vs T={depths[0]}: max|err| {err:.3e} "
                f"(scale {scale:.3e})")
            ok = ok and tol_ok(err, scale)
        if telemetry_path and lead:
            say("telemetry trace:",
                tele.collector().export(telemetry_path))
        say("SWEEP", "PASS" if ok else "FAIL")
        return 0 if ok else 1

    plan, (dstate, drec) = run(args.T)
    say(f"sharded {args.physics} propagate done on mesh "
        f"{dict(mesh.shape)} over {[str(d) for d in mesh.devices]} "
        f"(inner={inner}, inner_tile={args.inner_tile or 'block'}, "
        f"overlap={args.overlap}, "
        f"per_field_halo={not args.uniform_halo}, nt={nt}, "
        f"outer_T={plan.T}, inner_T={plan.inner_T})")

    if telemetry_path:
        measure_drift(plan)
        if lead:
            say("telemetry trace:",
                tele.collector().export(telemetry_path))

    def check(dstate, drec):
        """The fields and traces against the Listing-1 reference, by the
        reference launcher's rule; prints and returns the verdict."""
        rstate, rrec = ref_fn(nt, g, gr)
        ok = True
        for f, dv, rv in zip(physics.state_fields, dstate, rstate):
            err = float((dv - rv).abs().max())
            scale = float(rv.abs().max()) + 1e-30
            say(f"max|err| {f}={err:.3e} (field scale {scale:.3e})")
            ok = ok and tol_ok(err, scale)
        rec_err = float((drec - rrec).abs().max())
        rec_scale = float(rrec.abs().max()) + 1e-30
        say(f"max|err| rec={rec_err:.3e} (trace scale {rec_scale:.3e})")
        ok = ok and tol_ok(rec_err, rec_scale)
        say("CHECK", "PASS" if ok else "FAIL")
        return ok

    if not args.check:
        return 0
    if group is None:
        return 0 if check(dstate, drec) else 1
    # rank 0 holds the fields put together; its verdict is every rank's
    dstate = gather_blocks(dstate, mesh, dst=0)
    ok = check(dstate, drec) if lead else True
    return 0 if float(group.max(0.0 if ok else 1.0)) == 0.0 else 1

if __name__ == "__main__":
    sys.exit(main())
