"""Rank processes for `tests/test_torch_halo_ranks.py`: one spawn of
`WORLD` CPU ``gloo`` ranks (`_torch_dp_workers.run_ranks`) runs every
case of the module, each on the ranks its mesh counts (a sub-group where
the mesh has fewer shards than the world), so that 2-shard meshes run side
by side.  This module imports no JAX: a rank starts with torch and the
port only.
"""
import contextlib
import io

import torch
import torch.distributed as dist

WORLD = 4


def _groups(world, rank_sets):
    """{ranks: this rank's `DataParallel` over them, or None where it is
    not a member}: every rank creates every sub-group, in one order."""
    from repro_torch.distributed.process_group import DataParallel

    me = dist.get_rank()
    out = {}
    for ranks in sorted(set(rank_sets)):
        pg = None if len(ranks) == world else dist.new_group(list(ranks))
        out[ranks] = (DataParallel(ranks.index(me), len(ranks),
                                   torch.device("cpu"), "gloo", pg=pg,
                                   ranks=ranks)
                      if me in ranks else None)
    return out


def _np(t):
    """numpy of `t` (bf16 as float32: numpy has no bf16)."""
    if t is None:
        return None
    t = t.detach()
    return (t.float() if t.dtype == torch.bfloat16 else t).numpy()


def exchange_case(group, pgrid, grid, depth, h):
    """This rank's `exchange_to_depth` (timed: `DataParallel.timing`) and
    `halo_exchange_2d` of its block of the shard grid `grid` (numpy
    blocks) on a rank's view of a `pgrid` mesh, the rounds counted and the
    transport's counts of the former."""
    from repro_torch.distributed import halo as H
    from repro_torch.launch.mesh import make_rank_mesh

    mesh = make_rank_mesh(pgrid, group)
    px, py = pgrid
    i, j = divmod(group.rank, py)
    blocks = [[torch.as_tensor(grid[a][b]) if (a, b) == (i, j) else None
               for b in range(py)] for a in range(px)]
    before = dict(group.p2p)
    group.timing = True
    got = H.exchange_to_depth(blocks, depth, h, mesh=mesh)
    group.timing = False
    p2p = {k: group.p2p[k] - before[k] for k in before}
    rounds = mesh.exchange_rounds
    full = H.halo_exchange_2d(blocks, h, mesh=mesh)
    assert all(b is None for r, row in enumerate(got)
               for c, b in enumerate(row) if (r, c) != (i, j))
    return {"shard": (i, j), "depth": _np(got[i][j]), "full": _np(full[i][j]),
            "rounds": rounds, "p2p": p2p}


def propagation_case(group, physics, pgrid, shape, T, tile, inner_T, nt,
                     extra, dt, state, params, g, gr):
    """One sharded propagation on a rank's view of a `pgrid` mesh: the
    fields gathered on the group's rank 0, the traces on every rank, the
    executor calls (one a pass) and exchange rounds of this rank."""
    from repro_torch.core.temporal_blocking import TBPlan
    from repro_torch.distributed import halo as H
    from repro_torch.kernels import ops
    from repro_torch.kernels import tb_physics as phys
    from repro_torch.launch.mesh import make_rank_mesh

    p = phys.PHYSICS[physics]
    mesh = make_rank_mesh(pgrid, group)
    inner_plan = (TBPlan(tile, inner_T, p.step_radius(4))
                  if tile is not None else None)
    plan = H.DistTBPlan(mesh=mesh, grid_shape=shape, physics=p, order=4,
                        T=T, dt=dt, spacing=(10.0,) * 3, inner="torch",
                        inner_plan=inner_plan, **extra)
    rows = []
    sent = group.p2p["bytes_sent"]
    orig = ops.EXECUTORS["torch"]
    ops.EXECUTORS["torch"] = lambda *a, **k: (
        rows.append(a[2][0].shape[0]) or orig(*a, **k))
    try:
        st, rec = H.sharded_tb_propagate(plan, nt, state,
                                         dict(zip(p.param_fields, params)),
                                         g, gr)
    finally:
        ops.EXECUTORS["torch"] = orig
    bx, by = plan.block
    assert all(tuple(a.shape) == (bx, by, shape[2]) for a in st)
    rounds = mesh.exchange_rounds
    full = H.gather_blocks(st, mesh, dst=0)
    return {"fields": None if full is None else [_np(a) for a in full],
            "rec": _np(rec), "rows": rows, "rounds": rounds,
            "bytes_sent": group.p2p["bytes_sent"] - sent}


def survey_case(group, pgrid, physics, shape, nt, dt, params, shots, T,
                tile, inner_T):
    """`SurveyEngine.run_sharded` on a rank's view of a `pgrid` mesh: the
    traces (in survey order) and the route's stats."""
    from repro_torch.core.grid import Grid
    from repro_torch.core.temporal_blocking import TBPlan
    from repro_torch.distributed import halo as H
    from repro_torch.kernels import tb_physics as phys
    from repro_torch.launch.mesh import make_rank_mesh
    from repro_torch.survey import PlanCache, SurveyEngine

    p = phys.PHYSICS[physics]
    grid = Grid(shape=shape, spacing=(10.0,) * 3)
    engine = SurveyEngine(physics, grid, params, nt, dt,
                          plan=TBPlan((8, 8), 2, p.step_radius(4)),
                          plan_cache=PlanCache(), bucket_cap=2, device="cpu")
    dplan = H.DistTBPlan(mesh=make_rank_mesh(pgrid, group), grid_shape=shape,
                         physics=p, T=T, dt=dt, spacing=grid.spacing,
                         inner="torch",
                         inner_plan=TBPlan(tile, inner_T, p.step_radius(4)))
    res = engine.run_sharded(shots, dplan)
    return {"traces": res.traces, "stats": res.stats}


def launcher_case(group, argv):
    """`launch.stencil_dist.main(argv)` in this rank (the group already
    started: the launcher takes it); its exit code and what it printed."""
    from repro_torch.launch import stencil_dist

    buf = io.StringIO()
    with contextlib.redirect_stdout(buf):
        rc = stencil_dist.main(argv)
    return {"rc": rc, "out": buf.getvalue()}


KINDS = {"exchange": exchange_case, "propagation": propagation_case,
         "survey": survey_case, "launcher": launcher_case}


def halo_ranks(rank, world, cases):
    """Every case of `cases` ([(kind, ranks, args)]) on the ranks it
    names, in order; {case index: result} of the cases this rank ran."""
    torch.manual_seed(0)
    groups = _groups(world, [tuple(r) for _, r, _ in cases])
    out = {}
    for n, (kind, ranks, args) in enumerate(cases):
        group = groups[tuple(ranks)]
        if group is not None:
            out[n] = KINDS[kind](group, *args)
    dist.barrier()
    return out
