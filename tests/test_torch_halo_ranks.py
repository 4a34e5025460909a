"""The sharded layer one shard a process (`distributed.halo` on a rank's
view of the mesh, `launch.mesh.make_rank_mesh`, the halo transport
`process_group.DataParallel.exchange`) on the CPU, in spawned ``gloo``
ranks.

One spawn of `W.WORLD` ranks (`_torch_halo_workers.halo_ranks`, a
rendezvous file, one intra-op thread a rank) runs every case of the
module, each on the ranks its mesh counts: 2x1 and 1x2 meshes on ranks
{0, 1} and {2, 3} side by side, a 3x1 on {0, 1, 2}, 2x2 on all four.  The
ranks import torch and the port only; the JAX oracles run here.

(a) The exchange: each rank's `exchange_to_depth` / `halo_exchange_2d`
    equals the reference's under the collective-free `_sim_shifts`
    (tests/test_torch_halo.py), array for array, at depth 0, below the
    window depth and at it.
(b) Whole propagations (all three physics; the remainder tile,
    time-nested passes, `overlap`, the uniform halo): the fields gathered
    on rank 0 (`gather_blocks`) and every rank's traces within
    `FIELD_RTOL` of the single-controller `ShardMesh` run on the same plan
    (the fields bit-equal to it), and within `_assert_match`'s tolerances
    of the reference's Listing-1 oracle; each rank one executor call a pass
    of one shard row, as many as the single controller makes, and the
    exchange rounds the plan needs.
(c) `SurveyEngine.run_sharded` across ranks against `run`; the launcher
    (`launch.stencil_dist.main`) in the ranks with its two-level flags, and
    under `torch.distributed.run`; the refusals (a world other than px*py,
    nccl on the CPU); the message plan of the shifts (peers and tags) for
    the nccl route, which needs a card a rank.
"""
import os
import subprocess
import sys
import types

import numpy as np
import pytest
import torch

from repro_torch.core import temporal_blocking as ttb
from repro_torch.core.grid import Grid
from repro_torch.distributed import halo as H
from repro_torch.distributed.process_group import DataParallel
from repro_torch.kernels import ops, tb_physics as tphys
from repro_torch.launch import mesh as mesh_lib, stencil_dist
from repro_torch.survey import PlanCache, SurveyEngine

import _torch_halo_workers as W
from _torch_dp_workers import run_ranks
from test_torch_case import FIELD_RTOL, field_err
from test_torch_halo import (CPU, JH, _assert_match, _case, _oracles,
                             _sim_shifts, _sparse_pair, jnp)

TIMEOUT = 240.0
SHAPE = (32, 32, 16)
SURVEY_SHAPE = (16, 16, 8)
ALL = (0, 1, 2, 3)

# (mesh, block, window depth h, exchange depth, ranks)
EXCHANGE_CASES = [
    ((1, 2), (4, 6, 2), 1, 1, (0, 1)),
    ((2, 1), (5, 4, 3), 3, 2, (2, 3)),
    ((3, 1), (5, 4, 3), 4, 1, (0, 1, 2)),
    ((2, 2), (4, 4, 2), 3, 0, ALL),          # depth 0: no message at all
    ((2, 2), (6, 4, 3), 4, 2, ALL),          # below the window depth
    ((2, 2), (4, 5, 2), 3, 3, ALL),
]

# physics, mesh, T (outer), inner tile, inner T, nt, extra plan fields,
# ranks (SHARDED_CASES' kinds of schedule, on meshes of 2 and 4 ranks)
PROP_CASES = [
    ("acoustic", (2, 1), 2, None, None, 5, {}, (0, 1)),       # remainder
    ("tti", (1, 2), 2, (8, 8), 2, 3, {"overlap": True}, (2, 3)),
    ("elastic", (2, 1), 2, (8, 8), 1, 5, {}, (0, 1)),         # time-nested
    ("acoustic", (1, 2), 4, (8, 8), 2, 6, {"per_field_halo": False},
     (2, 3)),
    ("acoustic", (2, 2), 4, None, None, 7, {}, ALL),
    ("acoustic", (2, 2), 4, (8, 8), 2, 7, {"overlap": True}, ALL),
    ("tti", (2, 2), 2, None, None, 5, {}, ALL),
    ("tti", (2, 2), 2, (8, 16), 1, 4, {}, ALL),
    ("elastic", (2, 2), 2, (8, 8), 2, 5, {"overlap": True}, ALL),
    ("elastic", (2, 2), 2, None, None, 4, {"per_field_halo": False}, ALL),
]

SURVEY_PHYSICS = ["acoustic", "elastic"]

LAUNCH = ["--device", "cpu", "--dist-backend", "gloo", "--mesh", "2x2",
          "--check", "--n", "32", "--nt", "8", "--T", "2"]
LAUNCH_FLAGS = [
    ["--physics", "tti", "--nt", "5"],
    ["--physics", "elastic", "--nt", "5", "--uniform-halo"],
    ["--inner-tile", "4,8", "--overlap", "--T", "2", "--outer-T", "4",
     "--nt", "7"],
    ["--auto-plan"],
    ["--sweep-T", "1,2,4"],
]


@pytest.fixture(autouse=True)
def _one_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _exchange_grid(pgrid, block, h):
    px, py = pgrid
    rng = np.random.RandomState(px * 10 + py + h)
    return [[rng.randn(*block).astype(np.float32) for _ in range(py)]
            for _ in range(px)]


def _prop_inputs(physics, nt):
    """(case, state, params, reference sparse pair, port sparse pair)."""
    c, state, params = _case(physics, SHAPE, nt=nt, seed=4)
    return (c, state, params) + _sparse_pair(c)


def _survey_inputs(physics):
    from repro_torch.launch import stencil_survey

    grid = Grid(shape=SURVEY_SHAPE, spacing=(10.0,) * 3)
    dt = grid.cfl_dt(3000.0, 4)
    rng = np.random.RandomState(0)
    params = stencil_survey.build_model(physics, SURVEY_SHAPE, grid, rng,
                                        device="cpu")
    shots = stencil_survey.build_survey(grid, dt, 5, 2, rng)
    return grid, dt, params, shots


def _cases():
    """Every case the ranks run, in order: (kind, ranks, args)."""
    out = []
    for pgrid, block, h, depth, ranks in EXCHANGE_CASES:
        out.append(("exchange", ranks,
                    (pgrid, _exchange_grid(pgrid, block, h), depth, h)))
    for physics, pgrid, T, tile, inner_T, nt, extra, ranks in PROP_CASES:
        c, state, params, _, (tg, tgr) = _prop_inputs(physics, nt)
        out.append(("propagation", ranks,
                    (physics, pgrid, SHAPE, T, tile, inner_T, nt, extra,
                     c.dt, state, params, tg, tgr)))
    for physics in SURVEY_PHYSICS:
        grid, dt, params, shots = _survey_inputs(physics)
        out.append(("survey", ALL, ((2, 2), physics, SURVEY_SHAPE, 5, dt,
                                    params, shots, 2, (4, 8), 1)))
    for flags in LAUNCH_FLAGS:
        out.append(("launcher", ALL, (LAUNCH + flags,)))
    return out


N_EXCHANGE, N_PROP = len(EXCHANGE_CASES), len(PROP_CASES)
N_SURVEY = len(SURVEY_PHYSICS)
_runs = {}


@pytest.fixture
def ranks_out(tmp_path):
    """[each rank's {case index: result}] of one spawn for the module."""
    if "out" not in _runs:
        _runs["out"] = run_ranks(W.halo_ranks, W.WORLD,
                                 str(tmp_path / "rdzv"), (_cases(),),
                                 timeout=TIMEOUT)
    return _runs["out"]


def _results(out, n, ranks):
    """{rank in the case's group: its result} of case n."""
    return {r: out[g][n] for r, g in enumerate(ranks)}


# ---------------------------------------------------------------------------
# (a) The exchange
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("n", range(N_EXCHANGE))
def test_rank_exchange_matches_reference(ranks_out, n):
    pgrid, block, h, depth, ranks = EXCHANGE_CASES[n]
    px, py = pgrid
    grid = _exchange_grid(pgrid, block, h)
    res = _results(ranks_out, n, ranks)
    assert sorted(res) == list(range(px * py))
    for k, got in res.items():
        i, j = divmod(k, py)
        assert got["shard"] == (i, j)
        assert got["rounds"] == (1 if depth else 0)
        # one strip to each neighbour: x strips of the block, y strips of
        # the x-padded block; four shifts a round, each timed
        bx, by, nz = block
        nx_ = (i > 0) + (i < px - 1)
        ny_ = (j > 0) + (j < py - 1)
        sent = 4 * depth * nz * (nx_ * by + ny_ * (bx + 2 * depth))
        p2p = got["p2p"]
        assert p2p["bytes_sent"] == sent and p2p["bytes_recv"] == sent
        assert p2p["messages"] == (2 * (nx_ + ny_) if depth else 0)
        assert p2p["calls"] == (4 if depth else 0)
        assert (p2p["transfer_s"] > 0) == bool(depth)
        assert p2p["wait_s"] >= 0
        nbrs = {(di, dj): (jnp.asarray(grid[i + di][j + dj])
                           if 0 <= i + di < px and 0 <= j + dj < py
                           else None)
                for di in (-1, 0, 1) for dj in (-1, 0, 1)
                if (di, dj) != (0, 0)}
        shifts = _sim_shifts(nbrs)
        centre = jnp.asarray(grid[i][j])
        np.testing.assert_array_equal(got["depth"], np.asarray(
            JH.exchange_to_depth(centre, depth, h, "x", "y",
                                 shift_fns=shifts)))
        np.testing.assert_array_equal(got["full"], np.asarray(
            JH.halo_exchange_2d(centre, h, "x", "y", shift_fns=shifts)))


class _FakeGroup:
    """What `rank_shift_fns` reads of a group, recording each exchange
    call's (sends' peers, receives' peers, tag); zeros come back."""

    def __init__(self, rank, world):
        self.rank, self.world = rank, world
        self.calls = []

    def exchange(self, sends, recvs, tag=0):
        self.calls.append(([p for p, _ in sends], [p for p, _, _ in recvs],
                           tag))
        return [torch.zeros(shape, dtype=dtype) for _, shape, dtype in recvs]


@pytest.mark.parametrize("pgrid", [(2, 2), (2, 1), (1, 2), (3, 1), (1, 1)])
def test_shift_message_plan(pgrid):
    """The messages of one exchange round at every rank of a mesh (what
    nccl would send, and gloo does): call n of every rank carries one tag,
    each send has the matching receive in the peer's call n, no pair
    exchanges two messages a way in a call, and an axis without a
    neighbour sends nothing."""
    px, py = pgrid
    fakes = [_FakeGroup(k, px * py) for k in range(px * py)]
    for k, fake in enumerate(fakes):
        mesh = mesh_lib.ShardMesh(pgrid, devices=CPU)
        mesh.process_group = fake
        i, j = divmod(k, py)
        blocks = [[torch.zeros(4, 5, 2) if (a, b) == (i, j) else None
                   for b in range(py)] for a in range(px)]
        out = H.halo_exchange_2d(blocks, 2, mesh=mesh)
        assert out[i][j].shape == (8, 9, 2)
        assert mesh.exchange_rounds == 1
    # four shifts a round: x from low, x from high, y from low, y from high
    assert all([c[2] for c in f.calls] == [0, 1, 2, 3] for f in fakes)
    for k, fake in enumerate(fakes):
        i, j = divmod(k, py)
        for n, (sends, recvs, tag) in enumerate(fake.calls):
            assert len(set(sends)) == len(sends)
            assert len(set(recvs)) == len(recvs)
            for peer in sends:
                assert k in fakes[peer].calls[n][1]
            for peer in recvs:
                assert k in fakes[peer].calls[n][0]
            dim, up = divmod(tag, 2)
            n_axis, c = ((px, i), (py, j))[dim]
            if n_axis == 1:
                assert sends == [] and recvs == []
    msgs = sum(len(s) for f in fakes for s, _, _ in f.calls)
    assert msgs == 2 * ((px - 1) * py + px * (py - 1))


def test_p2p_route():
    cpu, card = torch.device("cpu"), torch.device("cuda", 0)
    assert DataParallel(0, 2, cpu, "gloo").p2p_route == "device"
    assert DataParallel(0, 2, card, "gloo").p2p_route == "host"
    assert DataParallel(0, 2, card, "nccl").p2p_route == "device"


# ---------------------------------------------------------------------------
# (b) Whole propagations
# ---------------------------------------------------------------------------

def _single_controller(physics, pgrid, T, tile, inner_T, nt, extra, c, state,
                       params, tg, tgr):
    """The single-controller run on the same plan: (fields, traces,
    executor rows a call, rounds)."""
    p = tphys.PHYSICS[physics]
    inner_plan = (ttb.TBPlan(tile, inner_T, p.step_radius(4))
                  if tile is not None else None)
    plan = H.DistTBPlan(mesh=mesh_lib.ShardMesh(pgrid, devices=CPU),
                        grid_shape=SHAPE, physics=p, order=4, T=T, dt=c.dt,
                        spacing=(10.0,) * 3, inner="torch",
                        inner_plan=inner_plan, **extra)
    rows = []
    orig = ops.EXECUTORS["torch"]
    try:
        ops.EXECUTORS["torch"] = lambda *a, **k: (
            rows.append(a[2][0].shape[0]) or orig(*a, **k))
        st, rec = H.sharded_tb_propagate(plan, nt, state,
                                         dict(zip(p.param_fields, params)),
                                         tg, tgr)
    finally:
        ops.EXECUTORS["torch"] = orig
    return plan, [a.numpy() for a in st], rec.numpy(), rows, \
        plan.mesh.exchange_rounds


@pytest.mark.parametrize("n", range(N_PROP))
def test_rank_propagation_matches_single_controller_and_listing1(ranks_out,
                                                                 n):
    physics, pgrid, T, tile, inner_T, nt, extra, ranks = PROP_CASES[n]
    c, state, params, (jg, jgr), (tg, tgr) = _prop_inputs(physics, nt)
    res = _results(ranks_out, N_EXCHANGE + n, ranks)
    plan, sst, srec, srows, srounds = _single_controller(
        physics, pgrid, T, tile, inner_T, nt, extra, c, state, params, tg,
        tgr)
    p = tphys.PHYSICS[physics]
    fields = res[0]["fields"]
    assert all(r["fields"] is None for k, r in res.items() if k)
    # every rank holds the same traces
    for r in res.values():
        np.testing.assert_array_equal(r["rec"], res[0]["rec"])
    rec = res[0]["rec"]
    what = f"{physics} {pgrid} T={T} tile={tile} {extra}"
    for f, a, b in zip(p.state_fields, fields, sst):
        assert field_err(a, b) <= FIELD_RTOL, (what, f)
        np.testing.assert_array_equal(a, b, err_msg=f"{what} {f}")
    for k in range(rec.shape[-1]):
        assert field_err(rec[..., k], srec[..., k]) <= FIELD_RTOL, what
    rst, rrec = _oracles(physics, c, state, params, jg, jgr)
    _assert_match(p.state_fields, fields, rst, rec, rrec, what)
    # one call a pass of one shard row, as many calls as the single
    # controller's (all its rows at once); the rounds the plan needs
    n_main, rem = divmod(nt, T)
    rounds = len(p.param_fields)
    rounds += n_main * sum(d > 0 for d in plan.field_depths(T))
    if rem:
        rounds += sum(d > 0 for d in plan.field_depths(rem))
    assert srounds == rounds
    for r in res.values():
        assert r["rows"] == [1] * len(srows), what
        assert r["rounds"] == rounds, what
        assert r["bytes_sent"] > 0
    assert srows == [pgrid[0] * pgrid[1]] * len(srows)


# ---------------------------------------------------------------------------
# (c) The survey, the launcher, the refusals
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("n", range(N_SURVEY))
def test_run_sharded_in_ranks_matches_run(ranks_out, n):
    physics = SURVEY_PHYSICS[n]
    grid, dt, params, shots = _survey_inputs(physics)
    p = tphys.PHYSICS[physics]
    engine = SurveyEngine(physics, grid, params, 5, dt,
                          plan=ttb.TBPlan((8, 8), 2, p.step_radius(4)),
                          plan_cache=PlanCache(), bucket_cap=2, device="cpu")
    want = engine.run(shots).traces
    res = _results(ranks_out, N_EXCHANGE + N_PROP + n, ALL)
    for k, r in res.items():
        s = r["stats"]
        assert (s["route"], s["shots"], s["ranks"]) == ("sharded", 2, 4)
        assert s["mesh"] == {"data": 2, "model": 2}
        assert len(r["traces"]) == len(shots)
        for a, b in zip(r["traces"], want):
            assert a.shape == b.shape
            for ch in range(a.shape[-1] if a.ndim == 3 else 1):
                x = a[..., ch] if a.ndim == 3 else a
                y = b[..., ch] if b.ndim == 3 else b
                assert field_err(x, y) <= FIELD_RTOL, (physics, k)


@pytest.mark.parametrize("n", range(len(LAUNCH_FLAGS)))
def test_launcher_in_ranks(ranks_out, n):
    res = _results(ranks_out, N_EXCHANGE + N_PROP + N_SURVEY + n, ALL)
    flags = LAUNCH_FLAGS[n]
    assert all(r["rc"] == 0 for r in res.values()), res[0]["out"]
    out = res[0]["out"]
    assert ("SWEEP PASS" if "--sweep-T" in flags else "CHECK PASS") in out
    assert "4 ranks over gloo" in out
    # rank 0 alone prints
    assert all(r["out"] == "" for k, r in res.items() if k)


def test_launcher_under_torchrun(tmp_path):
    env = dict(os.environ, OMP_NUM_THREADS="1",
               PYTHONPATH=os.pathsep.join(
                   [os.path.join(os.path.dirname(__file__), "..", "src")]
                   + [p for p in [os.environ.get("PYTHONPATH")] if p]))
    cmd = [sys.executable, "-m", "torch.distributed.run", "--standalone",
           "--nproc-per-node", "4", "-m", "repro_torch.launch.stencil_dist",
           "--mesh", "2x2", "--device", "cpu", "--dist-backend", "gloo",
           "--check", "--n", "16", "--nt", "5", "--T", "2"]
    done = subprocess.run(cmd, env=env, cwd=tmp_path, capture_output=True,
                          text=True, timeout=TIMEOUT)
    assert done.returncode == 0, done.stdout + done.stderr
    assert done.stdout.count("CHECK PASS") == 1, done.stdout


def test_rank_mesh_counts_every_rank():
    group = types.SimpleNamespace(rank=1, world=2,
                                  device=torch.device("cpu"))
    with pytest.raises(ValueError, match="2x2 mesh has 4 shards, the "
                                         "process group 2 ranks"):
        mesh_lib.make_rank_mesh((2, 2), group)
    with pytest.raises(ValueError, match="a 1x1 mesh has 1 shards, the "
                                         "process group 2 ranks"):
        mesh_lib.make_rank_mesh((1, 1), group)
    mesh = mesh_lib.make_rank_mesh((2, 1), group)
    assert mesh.pgrid == (2, 1) and mesh.rank == 1
    assert mesh.groups() == [(torch.device("cpu"), [1])]
    assert mesh.device_of(1) == torch.device("cpu")
    with pytest.raises(ValueError, match="belongs to rank 0"):
        mesh.device_of(0)
    plan = H.DistTBPlan(mesh=mesh, grid_shape=(32, 32, 8), inner="cuda")
    with pytest.raises(ValueError, match="inner='cuda'"):
        plan.validate()


def test_launcher_refusals():
    with pytest.raises(ValueError, match="nccl runs on cards only"):
        stencil_dist.main(["--device", "cpu", "--dist-backend", "nccl",
                           "--mesh", "2x2"])
    with pytest.raises(SystemExit):
        stencil_dist.main(["--device", "cpu", "--dist-backend", "gloo",
                           "--dryrun"])
