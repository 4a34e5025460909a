"""The paper's side of the port against the JAX package: the paper's
cases (`configs/paper_stencil`), the plan report of the dry run
(`launch/dryrun.stencil_plan_report`), the dry run itself
(`launch/stencil_dist --dryrun`), the production meshes, the time-tile
schedule (`core/temporal_blocking.TimeTileSchedule`, `tiled_propagate`)
and reduced paper cases at orders 8 and 12 through the TB entry points.

Tolerances: the reference tests' own (`tests/test_propagators.py`: atol
1e-6 for tiled against naive; `tests/test_kernel_multiphysics.py`: rtol
2e-4, atol 1e-5 for TB) and each field and receiver channel within
`FIELD_RTOL` of its own scale.
"""
import dataclasses
import json
import os

import numpy as np
import jax.numpy as jnp
import pytest

from repro.configs import paper_stencil as jps
from repro.core import boundary as jbd, sources as JS, stencil as jst
from repro.core import temporal_blocking as jtb
from repro.core.grid import Grid as JGrid
from repro.core.propagators import acoustic as jac, elastic as jel, \
    tti as jtt
from repro.kernels import ops as jops
from repro.survey import plan_cache as jpc
from repro_torch.configs import paper_stencil as tps
from repro_torch.core import boundary as tbd, sources as TS, stencil as tst
from repro_torch.core import temporal_blocking as ttb
from repro_torch.core.grid import Grid as TGrid
from repro_torch.core.propagators import acoustic as tac, elastic as tel
from repro_torch.kernels import ops as tops, tb_physics as tphys
from repro_torch.launch import dryrun as tdry, mesh as tmesh, stencil_dist
from repro_torch.survey import plan_cache as tpc
from test_torch_case import FIELD_RTOL, assert_fields_close, trace_channels

CASES = [(p, so) for p in ("acoustic", "tti", "elastic") for so in (4, 8, 12)]


# ---------------------------------------------------------------------------
# configs/paper_stencil
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("physics,order", CASES)
def test_paper_cases_equal_reference(physics, order):
    for make in (lambda m: m.full_case(physics, order),
                 lambda m: m.reduced_case(physics, order),
                 lambda m: m.reduced_case(physics, order, n=20,
                                          time_ms=7.5)):
        a, b = make(tps), make(jps)
        assert dataclasses.asdict(a) == dataclasses.asdict(b)
        for dt in (1e-3, 1.164486e-3, 0.512, 3.0):
            assert a.nt(dt) == b.nt(dt)
    assert [dataclasses.asdict(c) for c in tps.PAPER_CASES] == \
        [dataclasses.asdict(c) for c in jps.PAPER_CASES]


def test_stencil_radius_and_acoustic_helpers():
    for order in (2, 4, 8, 12, 16):
        assert tst.radius(order) == jst.radius(order)
    shape = (6, 5, 4)
    for dtype in (4, 2):
        assert tac.hbm_bytes_per_step(shape, dtype) == \
            jac.hbm_bytes_per_step(shape, dtype)
    state = tac.init_state(shape, device="cpu")
    jstate = jac.init_state(shape)
    for a, b in zip(state, jstate):
        assert tuple(a.shape) == b.shape and str(a.dtype)[6:] == b.dtype
        assert not a.any()
    m = (1.0 / np.random.RandomState(0).uniform(1500, 3500, shape) ** 2
         ).astype(np.float32)
    import torch
    got = tac.max_velocity(tac.AcousticParams(torch.as_tensor(m), None))
    assert got == jac.max_velocity(jac.AcousticParams(jnp.asarray(m), None))


# ---------------------------------------------------------------------------
# core/temporal_blocking.TimeTileSchedule and tiled_propagate
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("nt,T", [(12, 1), (12, 5), (7, 3), (3, 8), (0, 2)])
def test_time_tile_schedule_equals_reference(nt, T):
    a, b = ttb.TimeTileSchedule(nt, T), jtb.TimeTileSchedule(nt, T)
    assert (a.num_tiles, a.padded_nt) == (b.num_tiles, b.padded_nt)
    np.testing.assert_array_equal(a.tile_starts(), np.asarray(b.tile_starts()))
    with pytest.raises(ValueError):
        ttb.TimeTileSchedule(nt, 0)


SHAPE = (24, 20, 22)          # tests/test_propagators.py
SPACING = (10.0, 10.0, 10.0)
NT = 12


def _acoustic_setup():
    """tests/test_propagators.py's `_setup_acoustic` for both packages."""
    vp = np.full(SHAPE, 1500.0)
    vp[12:] = 2500.0
    m = (1.0 / vp ** 2).astype(np.float32)
    jgrid, tgrid = JGrid(SHAPE, SPACING), TGrid(SHAPE, SPACING)
    dt = jgrid.cfl_dt(2500.0, 4)
    src = np.array([[105.0, 95.0, 55.0]])
    wav = JS.ricker_wavelet(NT, dt, f0=15.0)
    rec = np.array([[55.0, 95.0, 105.0], [155.0, 95.0, 105.0]])
    jp = jac.AcousticParams(m=jnp.asarray(m), damp=jbd.damping_field(
        SHAPE, nbl=4, spacing=SPACING))
    tp = tac.AcousticParams(m=tops.torch.as_tensor(m), damp=tbd.damping_field(
        SHAPE, nbl=4, spacing=SPACING, device="cpu"))
    return (dt, (jp, JS.precompute(JS.SparseOperator(src), jgrid, wav),
                 JS.precompute_receivers(JS.SparseOperator(rec), jgrid),
                 jgrid),
            (tp, TS.precompute(TS.SparseOperator(src), tgrid, wav,
                               device="cpu"),
             TS.precompute_receivers(TS.SparseOperator(rec), tgrid,
                                     device="cpu"), tgrid))


@pytest.mark.parametrize("T", [1, 3, 5])
def test_acoustic_tiled_equals_naive_and_reference(T):
    dt, (jp, jg, jgr, jgrid), (tp, tg, tgr, tgrid) = _acoustic_setup()

    def step_fn(state, t):
        return tac.step(state, t, tp, tg, dt, SPACING, 4)

    def rec_out(state, t):
        return TS.interpolate(state.u, tgr)

    state = tac.init_state(SHAPE, device="cpu")
    ref_final, ref_recs = tac.propagate(NT, state, tp, tg, dt, tgrid, 4,
                                        receivers=tgr)
    tb_final, tb_recs = ttb.tiled_propagate(step_fn, NT, T, state,
                                            per_step_out=rec_out)
    np.testing.assert_allclose(ref_final.u.numpy(), tb_final.u.numpy(),
                               atol=1e-6)
    np.testing.assert_allclose(ref_recs.numpy(), tb_recs.numpy(), atol=1e-6)

    jstate = jac.init_state(SHAPE)
    jfinal, jrecs = jtb.tiled_propagate(
        lambda s, t: jac.step(s, t, jp, jg, dt, SPACING, 4), NT, T, jstate,
        per_step_out=lambda s, t: JS.interpolate(s.u, jgr))
    np.testing.assert_allclose(tb_final.u.numpy(), np.asarray(jfinal.u),
                               rtol=2e-4, atol=1e-6)
    np.testing.assert_allclose(tb_recs.numpy(), np.asarray(jrecs),
                               rtol=2e-4, atol=1e-6)


def _elastic_setup():
    """tests/test_propagators.py's `TestElastic._setup` for both packages
    (moduli in SI units, as there)."""
    vp, vs, rho = 2000.0, 1000.0, 1800.0
    mu = rho * vs ** 2
    lam = rho * vp ** 2 - 2 * mu
    full = [np.full(SHAPE, v, np.float32) for v in (lam, mu, 1.0 / rho)]
    jgrid, tgrid = JGrid(SHAPE, SPACING), TGrid(SHAPE, SPACING)
    dt = 0.5 * jgrid.cfl_dt(2000.0, 4)
    src = np.array([[105.0, 95.0, 55.0]])
    wav = JS.ricker_wavelet(NT, dt, f0=12.0) * 1e3
    jp = jel.ElasticParams(*(jnp.asarray(a) for a in full),
                           damp=jbd.damping_field(SHAPE, nbl=4,
                                                  spacing=SPACING))
    tp = tel.ElasticParams(*(tops.torch.as_tensor(a) for a in full),
                           damp=tbd.damping_field(SHAPE, nbl=4,
                                                  spacing=SPACING,
                                                  device="cpu"))
    return (dt, jp, JS.precompute(JS.SparseOperator(src), jgrid, wav), tp,
            TS.precompute(TS.SparseOperator(src), tgrid, wav, device="cpu"),
            tgrid)


@pytest.mark.parametrize("T", [1, 3, 5])
def test_elastic_tiled_equals_naive_and_reference(T):
    dt, jp, jg, tp, tg, tgrid = _elastic_setup()
    state = tel.init_state(SHAPE, device="cpu")
    ref_final, _ = tel.propagate(NT, state, tp, tg, dt, tgrid, 4)
    tb_final, outs = ttb.tiled_propagate(
        lambda s, t: tel.step(s, t, tp, tg, dt, SPACING, 4), NT, T, state)
    assert outs is None
    for a, b in zip(ref_final, tb_final):
        np.testing.assert_allclose(a.numpy(), b.numpy(), atol=1e-6)
    jfinal, _ = jtb.tiled_propagate(
        lambda s, t: jel.step(s, t, jp, jg, dt, SPACING, 4), NT, T,
        jel.init_state(SHAPE))
    assert_fields_close(zip(tel.ElasticState._fields, tb_final, jfinal),
                        FIELD_RTOL, f"elastic tiled T={T}")


def test_tiled_propagate_stacks_tuple_outputs():
    def step_fn(s, t):
        return s + 1.0

    def out(s, t):
        return (s * 2.0, s - t)

    _, (a, b) = ttb.tiled_propagate(step_fn, 5, 2,
                                    tops.torch.zeros(3), per_step_out=out)
    assert a.shape == (5, 3) and b.shape == (5, 3)
    np.testing.assert_array_equal(a[:, 0].numpy(), [2, 4, 6, 8, 10])
    np.testing.assert_array_equal(b[:, 0].numpy(), [1, 1, 1, 1, 1])


# ---------------------------------------------------------------------------
# launch/dryrun.stencil_plan_report, launch/mesh, stencil_dist --dryrun
# ---------------------------------------------------------------------------

# the reference's hardware figures, passed to both (tests/test_torch_plan.py)
REF_HW = dict(vmem_budget=96 * 2 ** 20, peak_flops=197e12, hbm_bw=819e9,
              link_bw=45e9, link_latency=1.5e-6)
SWEEP = dict(tiles=(8, 16, 32), depths=(1, 2, 4), **REF_HW)


def _drift_report():
    return {"records": [{"cell": {"physics": "acoustic"}}, {"cell": {}}],
            "summary": {"compute_s": {"geomean_ratio": 1.5, "n": 2},
                        "memory_s": {"geomean_ratio": None, "n": 0}}}


def _reference_dryrun():
    """`repro.launch.dryrun`, whose import sets XLA_FLAGS to 512 host
    devices for its own process: restored at once, so that the other
    tests' JAX backend, wherever it starts, sees the devices it would."""
    before = os.environ.get("XLA_FLAGS")
    from repro.launch import dryrun
    if before is None:
        os.environ.pop("XLA_FLAGS", None)
    else:
        os.environ["XLA_FLAGS"] = before
    return dryrun


@pytest.mark.parametrize("physics,order", [("acoustic", 4), ("tti", 8),
                                           ("elastic", 12)])
@pytest.mark.parametrize("with_drift", [False, True])
def test_stencil_plan_report_equals_reference(physics, order, with_drift,
                                              tmp_path, monkeypatch):
    jdry = _reference_dryrun()
    monkeypatch.chdir(tmp_path)
    if with_drift:
        os.makedirs("results")
        from repro.telemetry import drift as jdrift
        from repro_torch.telemetry import drift as tdrift
        for path in (jdrift.DEFAULT_PATH, tdrift.DEFAULT_PATH):
            with open(path, "w") as f:
                json.dump(_drift_report(), f)
    from repro.core import interp as JI
    from repro_torch.core import interp as TI
    caches = (tpc.PlanCache(), jpc.PlanCache())
    for hit in (False, True):
        got = tdry.stencil_plan_report(physics, 64, order, (32, 32),
                                       plan_cache=caches[0],
                                       interp=TI.spec_for("sinc", 2),
                                       **SWEEP)
        want = jdry.stencil_plan_report(physics, 64, order, (32, 32),
                                        plan_cache=caches[1],
                                        interp=JI.spec_for("sinc", 2),
                                        **SWEEP)
        assert got["cache"]["hit"] is hit
        tdrift_, jdrift_ = got.pop("last_drift"), want.pop("last_drift")
        assert got == want
        if with_drift:
            assert tdrift_.pop("path") != jdrift_.pop("path")
            assert tdrift_ == jdrift_
        else:
            assert tdrift_ is None and jdrift_ is None


@pytest.mark.parametrize("multi_pod", [False, True])
def test_production_mesh_is_shapes_only(multi_pod):
    mesh = tmesh.make_production_mesh(multi_pod=multi_pod)
    want = {"data": 16, "model": 16}
    if multi_pod:
        want = {"pod": 2, **want}
    assert mesh.shape == want and list(mesh.shape) == list(want)
    assert mesh.pgrid == (16, 16) and mesh.size == 256
    assert all(d.type == "meta" for d in mesh.devices)
    host = tmesh.make_host_mesh(device="cpu")
    assert host.pgrid == (1, 1) and host.devices[0].type == "cpu"
    assert tmesh.make_mesh((4, 2), ("data", "model"), ("cpu",)).pgrid == \
        (4, 2)
    with pytest.raises(ValueError):
        tmesh.ShardMesh((2, 2), ("data",), ("cpu",))


@pytest.mark.parametrize("args", [[], ["--multipod"],
                                  ["--physics", "elastic", "--order", "8",
                                   "--auto-plan"]])
def test_stencil_dist_dryrun_without_a_card(args, tmp_path, monkeypatch,
                                            capsys):
    monkeypatch.chdir(tmp_path)
    assert stencil_dist.main(["--device", "cpu", "--dryrun", *args]) == 0
    out = capsys.readouterr().out
    physics = args[1] if args and args[0] == "--physics" else "acoustic"
    pod = "multi" if "--multipod" in args else "single"
    assert out.rstrip().endswith(
        f"stencil distributed dry-run OK ({physics}, {pod}-pod)")
    report = json.loads(out.split("autotuner recommendation: ")[1]
                        .splitlines()[0])
    assert report["block"] == [32, 32] and report["nz"] == 512
    sizes = json.loads(out.split("cost analysis): ")[1].splitlines()[0])
    assert min(sizes.values()) > 0
    assert "last-run drift: none recorded" in out


# ---------------------------------------------------------------------------
# Reduced paper cases at orders 8 and 12 through the TB entry points
# ---------------------------------------------------------------------------

def _paper_inputs(case):
    """numpy inputs of a reduced paper case as `chip_smoke.full_case`
    builds the full one (two layers vmin/vmax, TTI's eps/delta layered and
    its angles smooth, elastic in SI units), plus a random initial state
    (elastic velocities divided by the impedance) so every term moves."""
    shape, h = case.shape, case.spacing
    rng = np.random.RandomState(case.space_order)
    top = np.arange(shape[2]) < shape[2] // 2

    def layered(a, b):
        return np.broadcast_to(np.where(top, a, b), shape).astype(np.float32)

    x = np.arange(shape[0])[:, None, None] / shape[0]
    y = np.arange(shape[1])[None, :, None] / shape[1]
    angle = np.broadcast_to(0.25 * (1 + np.sin(2 * np.pi * x)
                                    * np.cos(2 * np.pi * y)), shape)
    damp = tbd.damping_field(shape, case.nbl, h, device="cpu").numpy()
    m = layered(1 / case.vmin ** 2, 1 / case.vmax ** 2)
    name = case.propagator
    if name == "acoustic":
        params = (m, damp)
    elif name == "tti":
        params = (m, damp, layered(0.1, 0.2), layered(0.05, 0.1),
                  angle.astype(np.float32), (0.5 * angle).astype(np.float32))
    else:
        rho, vp = 2100.0, np.where(top, case.vmin, case.vmax)
        vs = vp / 1.9
        params = (layered(*(rho * (vp ** 2 - 2 * vs ** 2))[[0, -1]]),
                  layered(*(rho * vs ** 2)[[0, -1]]),
                  layered(1 / rho, 1 / rho), damp)
    nfields = len(tphys.PHYSICS[name].state_fields)
    state = tuple((0.01 * rng.randn(*shape)
                   / (rho * case.vmax if name == "elastic" and i < 3
                      else 1.0)).astype(np.float32)
                  for i in range(nfields))
    grid = TGrid(shape, h)
    vfast = case.vmax * np.sqrt(1.4) if name == "tti" else case.vmax
    dt = grid.cfl_dt(vfast, case.space_order)
    ext = np.asarray(grid.extent)
    src = np.array([[0.53, 0.47, 0.41]]) * ext
    rec = np.stack([np.linspace(0.2, 0.8, 4) * ext[0],
                    np.full(4, 0.52 * ext[1]), np.full(4, 0.3 * ext[2])], 1)
    wav = JS.ricker_wavelet(case.nt(dt), dt, case.f0)
    return state, params, dt, src, wav, rec


JAX_TB = {"acoustic": lambda nt, s, p, *a, **k: jops.acoustic_tb_propagate(
    nt, *s, *p, *a, **k), "tti": jops.tti_tb_propagate,
    "elastic": jops.elastic_tb_propagate}
PORT_TB = {"acoustic": lambda nt, s, p, *a, **k: tops.acoustic_tb_propagate(
    nt, *s, *p, *a, **k), "tti": tops.tti_tb_propagate,
    "elastic": tops.elastic_tb_propagate}
JAX_TYPES = {"acoustic": (lambda *a: a, lambda *a: a),
             "tti": (jtt.TTIState, jtt.TTIParams),
             "elastic": (jel.ElasticState, jel.ElasticParams)}


@pytest.mark.parametrize("physics", ["acoustic", "tti", "elastic"])
@pytest.mark.parametrize("order", [8, 12])
def test_reduced_paper_case_tb_matches_reference(physics, order):
    case = tps.reduced_case(physics, order, n=16,
                            time_ms=5.0 if physics == "tti" else 3.3)
    state, params, dt, src, wav, rec = _paper_inputs(case)
    nt = case.nt(dt)
    assert nt >= 3 and nt % 2                   # two tiles and a remainder
    r = tphys.PHYSICS[physics].step_radius(order)
    tgrid, jgrid = TGrid(case.shape, case.spacing), \
        JGrid(case.shape, case.spacing)
    g = TS.precompute(TS.SparseOperator(src), tgrid, wav, device="cpu")
    gr = TS.precompute_receivers(TS.SparseOperator(rec), tgrid,
                                 device="cpu")
    tstate, trec = PORT_TB[physics](
        nt, state, params, g, gr, ttb.TBPlan((16, 16), 2, r), order, dt,
        case.spacing, device="cpu")
    st_t, par_t = JAX_TYPES[physics]
    jstate, jrec = JAX_TB[physics](
        nt, st_t(*(jnp.asarray(a) for a in state)),
        par_t(*(jnp.asarray(a) for a in params)),
        JS.precompute(JS.SparseOperator(src), jgrid, wav),
        JS.precompute_receivers(JS.SparseOperator(rec), jgrid),
        jtb.TBPlan((16, 16), 2, r), order, dt, case.spacing,
        executor="jnp")
    names = tphys.PHYSICS[physics].state_fields
    for n, a, b in zip(names, tstate, jstate):
        np.testing.assert_allclose(a.numpy(), np.asarray(b), rtol=2e-4,
                                   atol=1e-5, err_msg=n)
    assert_fields_close(zip(names, (a.numpy() for a in tstate), jstate),
                        FIELD_RTOL, f"{case.name}")
    np.testing.assert_allclose(trec.numpy(), np.asarray(jrec), rtol=2e-4,
                               atol=1e-5)
    assert_fields_close(trace_channels(trec.numpy(), jrec), FIELD_RTOL,
                        f"{case.name} traces")
    assert float(np.abs(np.asarray(jrec)).max()) > 0


# ---------------------------------------------------------------------------
# The tile loop's memory (what lets the order-12 cases fit the card)
# ---------------------------------------------------------------------------

def test_tile_loop_lets_each_unpadded_state_go(monkeypatch):
    """While a time tile's launch runs, the state it padded is no longer
    held (only the caller's first state is): `ops.propagation_bytes`
    counts one state beside the padded copy and the outputs."""
    import weakref

    from test_torch_case import acoustic_case

    c = acoustic_case(nt=7)
    held, prev = [], []
    plain = tops.EXECUTORS["torch"]

    def check(spec, physics, state_pads, *args, **kw):
        held.append([r() is not None for r in prev])
        out = plain(spec, physics, state_pads, *args, **kw)
        prev[:] = [weakref.ref(f) for f in out[0]]
        return out

    monkeypatch.setitem(tops.EXECUTORS, "torch", check)
    g = TS.precompute(TS.SparseOperator(c.src), TGrid(c.shape, c.spacing),
                      c.wav, device="cpu")
    tops.acoustic_tb_propagate(c.nt, c.u0, c.u1, c.m, c.damp, g, None,
                               ttb.TBPlan((8, 8), 2, 2), c.order, c.dt,
                               c.spacing, executor="torch", device="cpu")
    assert held == [[], [False, False], [False, False], [False, False]]


def test_propagation_bytes_counts_the_tile_loop():
    """`ops.propagation_bytes` by hand for elastic at 512^3, order 4, T = 4
    (z-streamed) with a depth-3 remainder: the caller's 9 + 4 fields, both
    tiles' padded params, the scratch of the larger launch, then the main
    tile's param copies, padded state and outputs."""
    from repro_torch.kernels import stencil_tb as tker

    p = tphys.ELASTIC
    n, field = 512, 512 ** 3 * 4
    plan = ttb.TBPlan((32, 32), 4, 4)
    spec = tops.make_spec((n,) * 3, plan, 4, 1.0, (1.0,) * 3, 1, 1,
                          physics=p)
    rspec = tops.make_spec((n,) * 3, ttb.TBPlan((32, 32), 3, 4), 4, 1.0,
                           (1.0,) * 3, 1, 1, physics=p)

    def padded(h):
        return (n + 2 * h) ** 2 * n * 4

    scratch = tker.scratch_bytes(spec, p, 1)
    assert scratch >= tker.scratch_bytes(rspec, p, 1)
    want = (13 * field + 4 * padded(16) + 4 * padded(12) + scratch
            + tker.launch_shared_bytes(spec, p) + 9 * padded(16)
            + tker.launch_bytes(spec, p) - scratch)
    assert tops.propagation_bytes(p, (n,) * 3, 399, plan, 4) == want
    # no remainder: nt a multiple of T
    assert tops.propagation_bytes(p, (n,) * 3, 400, plan, 4) == \
        want - 4 * padded(12)


def test_chip_smoke_builds_the_paper_cases_from_the_config():
    """`chip_smoke.full_case` (also the tools' case) takes the paper's
    values from `configs/paper_stencil`: order 4 by default, the CFL step
    at the case's order, so nt grows with the order."""
    import sys
    from pathlib import Path

    sys.path.insert(0, str(Path(__file__).resolve().parents[1]))
    import chip_smoke as cs

    assert cs.SHAPE == (512, 512, 512) and cs.ORDER == 4
    assert sorted(cs.PAPER_EXTRA) == sorted(
        (p, so) for p, so in CASES if so != 4)
    nts = {}
    for physics, order in CASES:
        fc = cs.full_case(physics, "cpu", shape=(32, 32, 32),
                          **({} if order == 4 else {"order": order}))
        case = tps.full_case(physics, order)
        assert fc.case == case and fc.order == order
        assert fc.spacing == case.spacing
        assert fc.nt == case.nt(fc.dt) and fc.g.nt == fc.nt
        nts[physics, order] = fc.nt
    for physics in ("acoustic", "tti", "elastic"):
        assert nts[physics, 4] < nts[physics, 8] < nts[physics, 12]
    assert (nts["acoustic", 4], nts["tti", 4]) == (399, 236)
