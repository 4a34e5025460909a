"""The CUDA kernels against their plain PyTorch versions, on the card: the
TB kernels (B1a-B1d, B1a-bf16) and the Mamba2 SSD scan (B2).

Marked `cuda`; each test skips (inside its body) when no card is present,
so the CPU runs collect the same tests on every worker.  This file imports
neither JAX nor the JAX package, so it runs on a machine that has only the
port's dependencies:

    python -m pytest -q -m cuda tests/test_torch_cuda.py

The batched launch (B shots, the shot axis in the kernel's grid) is held
against the plain version and against B single-shot launches, which it
must equal bit for bit, and a small survey on the card against sequential
calls.

Tolerance: rtol 2e-4, atol 1e-6 for acoustic (tests/test_kernel_stencil_tb.py),
rtol 2e-4, atol 1e-5 for TTI and elastic (tests/test_kernel_multiphysics.py),
and for these each field and receiver channel within `FIELD_RTOL` of its own
scale (the elastic cases are in SI units, with velocities near 1e-9).  The
bf16 acoustic tile: the reference's bf16 bound (0.1 max|f32| + 1e-2).  The
SSD scan: rtol 1e-4 and atol 1e-5 x max(1, max|plain|)
(tests/test_kernel_ssd.py; the atol scaled as in tests/test_torch_ssd.py),
and max|diff| / max|plain| <= 1e-5; a bf16 y within one bf16 rounding
(2^-8 relative) of the plain float32 y.  The scan under a gradient
(`SSDScanFn`): float32 gradients within 1e-4 of each max|plain gradient|.
"""
import dataclasses

import numpy as np
import pytest
import torch

from repro_torch.core.temporal_blocking import TBPlan
from repro_torch.kernels import ops, ref, stencil_tb as ker, \
    tb_physics as phys
from test_torch_case import FIELD_RTOL, MULTI_CASES, acoustic_case, \
    assert_fields_close, port_sparse, trace_channels

RTOL, ATOL = 2e-4, 1e-6
MP_ATOL = 1e-5


def _card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card (the kernel has no CPU mode)")
    return torch.device("cuda", 0)


def _schedules(spec, p):
    """Every schedule the physics' kernel runs at `spec`: None for the
    first, the z-streamed sub-tile plan where one fits a block, and the
    cluster-shared trapezoid (B5) or z-wavefront (B6) where the kernel has
    one, whichever `launch_plan` would pick."""
    out = [None]
    try:
        out.append(ker.stream_plan(spec, p))
    except ValueError:
        pass
    for make in (ker.cluster_plan, ker.wave_plan):
        try:
            out.append(make(spec, p))
        except ValueError:
            pass
    return out


def _operands(c, T, tile, dev, sources=True, t0=1, dtype=torch.float32):
    g, gr = port_sparse(c, device=dev) if sources else (None, None)
    params = {"m": torch.as_tensor(c.m, device=dev).to(dtype),
              "damp": torch.as_tensor(c.damp, device=dev).to(dtype)}
    # one shot: a shot axis of 1
    state = tuple(torch.as_tensor(a, device=dev).to(dtype)[None]
                  for a in (c.u0, c.u1))
    spec, st, rt, ppads = ops.prepare_tiles(
        TBPlan(tile, T, c.order // 2), phys.ACOUSTIC, state[0][0], params, g,
        gr, c.order, c.dt, c.spacing)
    pads, sc, sv, rc, rw = ops.tile_operands(
        spec, state, g.src_dcmp[None] if sources else None, st, rt, t0)
    return spec, (pads, ppads, sc, sv, rc, rw)


@pytest.mark.cuda
@pytest.mark.parametrize("T,tile,order,shape,sources", [
    (1, (8, 8), 4, (16, 16, 40), True),
    (2, (16, 8), 2, (32, 16, 37), True),
    (3, (8, 8), 8, (16, 24, 33), True),
    (4, (16, 16), 4, (32, 32, 45), True),
    (2, (16, 16), 8, (32, 32, 29), False),
    # the z-streamed schedule's edges: nz below the z ring (order 8: 9
    # planes), the largest radius (order 16), H above the tile, nz not a
    # multiple of the output staging's 8 planes, T = 1
    (2, (8, 8), 8, (16, 16, 3), True),
    (2, (8, 8), 16, (16, 16, 13), True),
    (4, (8, 8), 8, (16, 16, 20), True),
    (1, (16, 8), 4, (32, 16, 13), True),
])
def test_kernel_matches_plain(T, tile, order, shape, sources, monkeypatch):
    dev = _card()
    c = acoustic_case(shape=shape, order=order, nt=8, nsrc=3, nrec=4)
    spec, args = _operands(c, T, tile, dev, sources)
    (p0, p1), prec = ker.tb_time_tile_plain(spec, phys.ACOUSTIC, *args)
    for plan in _schedules(spec, phys.ACOUSTIC):
        monkeypatch.setattr(ker, "launch_plan", lambda s, q, x=plan: x)
        before = ker.launches
        (k0, k1), krec = ker.tb_time_tile(spec, phys.ACOUSTIC, *args)
        assert ker.launches == before + 1
        torch.cuda.synchronize()
        for k, p in ((k0, p0), (k1, p1), (krec, prec)):
            assert k.shape == p.shape
            torch.testing.assert_close(k, p, rtol=RTOL, atol=ATOL)


@pytest.mark.cuda
def test_propagate_on_card_matches_reference_and_cpu():
    dev = _card()
    c = acoustic_case(shape=(32, 16, 24), nt=7)
    g, gr = port_sparse(c, device=dev)
    plan = TBPlan((8, 8), 3, 2)
    (u0, u1), rec = ops.acoustic_tb_propagate(
        c.nt, c.u0, c.u1, c.m, c.damp, g, gr, plan, 4, c.dt, c.spacing)
    (r0, r1), rrec = ref.acoustic_reference(
        c.nt, c.u0, c.u1, c.m, c.damp, c.dt, c.spacing, 4, g=g,
        receivers=gr)
    cg, cgr = port_sparse(c, device="cpu")
    (_, h1), hrec = ops.acoustic_tb_propagate(
        c.nt, c.u0, c.u1, c.m, c.damp, cg, cgr, plan, 4, c.dt, c.spacing,
        device="cpu")
    assert u1.device.type == "cuda"
    torch.testing.assert_close(u1, r1, rtol=RTOL, atol=ATOL)
    torch.testing.assert_close(rec, rrec, rtol=RTOL, atol=ATOL)
    np.testing.assert_allclose(u1.cpu().numpy(), h1.numpy(), rtol=RTOL,
                               atol=ATOL)
    np.testing.assert_allclose(rec.cpu().numpy(), hrec.numpy(), rtol=RTOL,
                               atol=ATOL)


def _bf16_bound(f32):
    """tests/test_kernel_stencil_tb.py::test_bf16_runs_and_tracks_f32's
    bound, from the float32 result: 0.1 max(max|f32|, 1e-3) + 1e-2."""
    return 0.1 * max(float(f32.abs().max()), 1e-3) + 1e-2


# bf16 kernel vs the plain bf16 version: both compute in float32 and round
# at the same stores, so they differ by rounding flips of a few bf16
# spacings (2^-8..2^-7 of a value)
BF16_PLAIN_RTOL = 2 ** -6


def _bf16_close(got, plain):
    """max|diff| <= 2^-6 max|plain|, per receiver channel for partials
    (B, ntx, nty, T, capr, chan) and over the whole of a field."""
    pairs = ([(got[..., c], plain[..., c]) for c in range(got.shape[-1])]
             if got.dim() == 6 else [(got, plain)])
    for g, p in pairs:
        g, p = g.float().cpu(), p.float().cpu()
        assert float((g - p).abs().max()) <= \
            BF16_PLAIN_RTOL * float(p.abs().max())


@pytest.mark.cuda
def test_wrapper_rejects_what_the_kernel_does_not_take():
    """The acoustic kernel takes bf16 (B1a-bf16): held to the plain bf16
    version within 2^-6 of each field's and receiver channel's scale, and
    to the float32 kernel within the reference's bf16 bound.
    A bf16 field under a float32 spec, bf16 TTI, bf16 with a domain mask,
    a strided field, a wrong shape and a CPU field are refused."""
    dev = _card()
    c = acoustic_case(shape=(16, 16, 12), nt=4)
    spec, (pads, ppads, sc, sv, rc, rw) = _operands(c, 2, (8, 8), dev)
    bspec, bargs = _operands(c, 2, (8, 8), dev, dtype=torch.bfloat16)
    assert bspec.dtype == torch.bfloat16
    before = ker.launches
    kst, krec = ker.tb_time_tile(bspec, phys.ACOUSTIC, *bargs)
    assert ker.launches == before + 1
    pst, prec = ker.tb_time_tile_plain(bspec, phys.ACOUSTIC, *bargs)
    fst, frec = ker.tb_time_tile(spec, phys.ACOUSTIC, pads, ppads, sc, sv,
                                 rc, rw)
    torch.cuda.synchronize()
    for k, p, f in zip((*kst, krec), (*pst, prec), (*fst, frec)):
        assert k.dtype == torch.bfloat16 and k.shape == f.shape
        assert torch.isfinite(k.float()).all()
        _bf16_close(k, p)
        assert float((k.float() - f).abs().max()) <= _bf16_bound(f)
    bf = tuple(p.to(torch.bfloat16) for p in pads)
    with pytest.raises(TypeError, match="dtype"):
        ker.tb_time_tile(spec, phys.ACOUSTIC, bf, ppads, sc, sv, rc, rw)
    mc = MULTI_CASES["tti"](shape=(16, 16, 12), nt=4)
    tp, tspec, targs = _mp_operands(mc, 2, (8, 8), dev)
    with pytest.raises(TypeError, match="acoustic only"):
        ker.tb_time_tile(dataclasses.replace(tspec, dtype=torch.bfloat16),
                         tp, *(tuple(a.to(torch.bfloat16) for a in t)
                               for t in targs[:2]), *targs[2:])
    dom = torch.ones((1, 16 + 2 * bspec.halo, 16 + 2 * bspec.halo),
                     device=dev)
    with pytest.raises(TypeError, match="B1c"):
        ker.tb_time_tile(bspec, phys.ACOUSTIC, *bargs, dom=dom)
    strided = (pads[0].transpose(1, 2), pads[1])
    with pytest.raises(ValueError, match="contiguous"):
        ker.tb_time_tile(spec, phys.ACOUSTIC, strided, ppads, sc, sv, rc, rw)
    with pytest.raises(ValueError, match="shape"):
        ker.tb_time_tile(spec, phys.ACOUSTIC, pads, ppads, sc, sv[:, :1],
                         rc, rw)
    cpu = tuple(p.cpu() for p in ppads)
    with pytest.raises(ValueError, match="cpu"):
        ker.tb_time_tile(spec, phys.ACOUSTIC, pads, cpu, sc, sv, rc, rw)


def _mp_operands(c, T, tile, dev, sources=True, t0=1):
    """A TTI or elastic case's kernel operands for the time tile at t0."""
    physics = phys.PHYSICS[c.physics]
    g, gr = port_sparse(c, device=dev) if sources else (None, None)
    params = {f: torch.as_tensor(a, device=dev)
              for f, a in zip(physics.param_fields, c.params)}
    state = tuple(torch.as_tensor(a, device=dev)[None] for a in c.state)
    spec, st, rt, ppads = ops.prepare_tiles(
        TBPlan(tile, T, physics.step_radius(c.order)), physics, state[0][0],
        params, g, gr, c.order, c.dt, c.spacing)
    pads, sc, sv, rc, rw = ops.tile_operands(
        spec, state, g.src_dcmp[None] if sources else None, st, rt, t0)
    return physics, spec, (pads, ppads, sc, sv, rc, rw)


@pytest.mark.cuda
@pytest.mark.parametrize("physics", ["tti", "elastic"])
@pytest.mark.parametrize("T,tile,order,shape,sources", [
    (1, (8, 8), 4, (16, 16, 40), True),
    (2, (16, 8), 2, (32, 16, 37), True),
    (4, (8, 8), 4, (16, 24, 33), True),
    (2, (8, 8), 8, (16, 16, 29), False),
    # nz below the z taps' reach, the largest radius, H above the tile
    (2, (8, 8), 8, (16, 16, 3), True),
    (1, (8, 8), 16, (16, 16, 13), True),
    (4, (8, 8), 2, (16, 16, 13), True),
    # TTI's launch takes its z-streamed schedule here (halo 8, overhang 4)
    (2, (16, 16), 4, (32, 32, 20), True),
])
def test_multiphysics_kernel_matches_plain(physics, T, tile, order, shape,
                                           sources, monkeypatch):
    dev = _card()
    c = MULTI_CASES[physics](shape=shape, order=order, nt=8, nsrc=3, nrec=4)
    p, spec, args = _mp_operands(c, T, tile, dev, sources)
    if physics == "tti" and (T, tile, order) == (2, (16, 16), 4):
        assert ker.launch_plan(spec, p) is not None
    pst, prec = ker.tb_time_tile_plain(spec, p, *args)
    for plan in _schedules(spec, p):
        monkeypatch.setattr(ker, "launch_plan", lambda s, q, x=plan: x)
        before = ker.launches
        kst, krec = ker.tb_time_tile(spec, p, *args)
        assert ker.launches == before + 1
        torch.cuda.synchronize()
        assert krec.shape == prec.shape == (1, *spec.ntiles, T,
                                            spec.rec_cap, p.rec_channels)
        for k, q in zip((*kst, krec), (*pst, prec)):
            torch.testing.assert_close(k, q, rtol=RTOL, atol=MP_ATOL)
        assert_fields_close(
            [(f, k.cpu(), q.cpu())
             for f, k, q in zip(p.state_fields, kst, pst)]
            + [(f"rec[{i}]", krec[..., i].cpu(), prec[..., i].cpu())
               for i in range(p.rec_channels)], FIELD_RTOL, physics)


@pytest.mark.cuda
@pytest.mark.parametrize("physics", ["tti", "elastic"])
def test_multiphysics_propagate_on_card_matches_reference(physics):
    dev = _card()
    c = MULTI_CASES[physics](shape=(32, 16, 24), nt=7)
    g, gr = port_sparse(c, device=dev)
    entry, oracle = {"tti": (ops.tti_tb_propagate, ref.tti_reference),
                     "elastic": (ops.elastic_tb_propagate,
                                 ref.elastic_reference)}[physics]
    plan = TBPlan((8, 8), 3, phys.PHYSICS[physics].step_radius(4))
    st, rec = entry(c.nt, c.state, c.params, g, gr, plan, 4, c.dt, c.spacing)
    rst, rrec = oracle(c.nt, c.state, c.params, c.dt, c.spacing, 4, g=g,
                       receivers=gr)
    cg, cgr = port_sparse(c, device="cpu")
    hst, hrec = entry(c.nt, c.state, c.params, cg, cgr, plan, 4, c.dt,
                      c.spacing, device="cpu")
    assert rec.device.type == "cuda"
    for a, b, h in zip((*st, rec), (*rst, rrec), (*hst, hrec)):
        torch.testing.assert_close(a, b, rtol=RTOL, atol=MP_ATOL)
        np.testing.assert_allclose(a.cpu().numpy(), h.numpy(), rtol=RTOL,
                                   atol=MP_ATOL)
    names = phys.PHYSICS[physics].state_fields
    for want, what in ((rst, rrec), "reference"), ((hst, hrec), "CPU run"):
        assert_fields_close(zip(names, [a.cpu() for a in st],
                                [b.cpu() for b in want[0]]), FIELD_RTOL,
                            f"{physics} vs the {what}")
        assert_fields_close(trace_channels(rec.cpu(), want[1].cpu()),
                            FIELD_RTOL, f"{physics} vs the {what}")


@pytest.mark.cuda
def test_multiphysics_wrapper_rejects_wrong_fields():
    dev = _card()
    c = MULTI_CASES["tti"](shape=(16, 16, 12), nt=4)
    p, spec, (pads, ppads, sc, sv, rc, rw) = _mp_operands(c, 2, (8, 8), dev)
    with pytest.raises(ValueError, match="takes 10 fields"):
        ker.tb_time_tile(spec, p, pads, ppads[:5], sc, sv, rc, rw)
    with pytest.raises(ValueError, match="step radius"):
        ker.tb_time_tile(spec, phys.ACOUSTIC, pads[:2], ppads[:2], sc, sv,
                         rc, rw)


def _batch_operands(physics, cases, T, tile, dev, t0=1):
    """Operands of one batched time tile: shot b is `cases[b]`'s state and
    sources, or its sources' tables with zero values (a null shot) where
    `cases[b]` is (case, False); the params are the first case's."""
    first = cases[0][0]
    params = {f: torch.as_tensor(a, device=dev)
              for f, a in zip(physics.param_fields, first.params)} \
        if physics.name != "acoustic" else \
        {"m": torch.as_tensor(first.m, device=dev),
         "damp": torch.as_tensor(first.damp, device=dev)}
    sparse = [port_sparse(c, device=dev) for c, _ in cases]
    src_cap = max(g.npts for g, _ in sparse)
    rec_cap = max(gr.indices.shape[0] * gr.indices.shape[1]
                  for _, gr in sparse)
    spec = ops.make_spec(first.shape, TBPlan(tile, T, physics.step_radius(
        first.order)), first.order, first.dt, first.spacing, src_cap,
        rec_cap, physics=physics)
    tabs = [ops.build_tables(spec, g, gr, params, physics, src_cap=src_cap,
                             rec_cap=rec_cap) for g, gr in sparse]
    dcmp = torch.zeros((len(cases), first.nt, src_cap), device=dev)
    for b, ((_, live), (g, _)) in enumerate(zip(cases, sparse)):
        if live:
            dcmp[b, :, :g.npts] = g.src_dcmp
    states = [(c.u0, c.u1) if physics.name == "acoustic" else c.state
              for c, _ in cases]
    state = tuple(torch.stack([torch.as_tensor(s[i], device=dev)
                               for s in states])
                  for i in range(len(states[0])))
    pads, sc, sv, rc, rw = ops.tile_operands(
        spec, state, dcmp, ops.stack_tables([t[0] for t in tabs]),
        ops.stack_tables([t[1] for t in tabs]), t0)
    ppads = tuple(ops.pad_xy(params[f], spec.halo, "edge")
                  for f in physics.param_fields)
    return spec, (pads, ppads, sc, sv, rc, rw)


@pytest.mark.cuda
@pytest.mark.parametrize("physics", ["acoustic", "tti", "elastic"])
def test_batched_kernel_matches_plain_and_single_launches(physics):
    """B = 3 in one launch, the third a null shot: equal to the plain
    version within the tolerances, and to 3 single-shot launches bit for
    bit (the arithmetic per point is the same)."""
    dev = _card()
    p = phys.PHYSICS[physics]
    make = acoustic_case if physics == "acoustic" else MULTI_CASES[physics]
    cases = [(make(shape=(32, 16, 29), order=4, nt=8, nsrc=n, nrec=4,
                   seed=s), live)
             for n, s, live in ((1, 1, True), (3, 2, True), (2, 3, False))]
    spec, args = _batch_operands(p, cases, 2, (16, 8), dev)
    if physics != "elastic":            # halo 8 (TTI): z-streamed
        assert ker.launch_plan(spec, p) is not None
    before = ker.launches
    kst, krec = ker.tb_time_tile(spec, p, *args)
    assert ker.launches == before + 1
    pst, prec = ker.tb_time_tile_plain(spec, p, *args)
    torch.cuda.synchronize()
    assert krec.shape == prec.shape == (3, *spec.ntiles, 2, spec.rec_cap,
                                        p.rec_channels)
    atol = ATOL if physics == "acoustic" else MP_ATOL
    for k, q in zip((*kst, krec), (*pst, prec)):
        torch.testing.assert_close(k, q, rtol=RTOL, atol=atol)
    assert_fields_close(
        [(f, k.cpu(), q.cpu()) for f, k, q in zip(p.state_fields, kst, pst)]
        + [(f"rec[{i}]", krec[..., i].cpu(), prec[..., i].cpu())
           for i in range(p.rec_channels)], FIELD_RTOL, physics)
    pads, ppads, sc, sv, rc, rw = args
    for b in range(3):
        ost, orec = ker.tb_time_tile(
            spec, p, tuple(f[b:b + 1] for f in pads), ppads, sc[b:b + 1],
            sv[b:b + 1], rc[b:b + 1], rw[b:b + 1])
        assert torch.equal(orec, krec[b:b + 1])
        for a, k in zip(ost, kst):
            assert torch.equal(a, k[b:b + 1])


@pytest.mark.cuda
@pytest.mark.parametrize("physics", ["acoustic", "tti", "elastic"])
def test_survey_on_card_matches_sequential(physics):
    """A small survey through the CUDA kernels: every shot's traces as a
    sequential call's, one build per bucket, and the launches counted."""
    from repro_torch.core.grid import Grid
    from repro_torch.launch.stencil_survey import build_model, \
        build_survey, sequential_traces
    from repro_torch.survey import PlanCache, SurveyEngine

    dev = _card()
    shape = (32, 32, 24)
    grid = Grid(shape, (10.0,) * 3)
    dt = grid.cfl_dt(3000.0, 4)
    rng = np.random.RandomState(0)
    params = build_model(physics, shape, grid, rng, device=dev)
    shots = build_survey(grid, dt, 7, 5, rng)
    engine = SurveyEngine(physics, grid, params, 7, dt, bucket_cap=2,
                          plan_cache=PlanCache(),
                          plan_kwargs={"tiles": (8, 16)}, device=dev)
    assert engine.executor == "cuda"
    before = ker.launches
    res = engine.run(shots)
    assert ker.launches - before == res.stats["batches"] * -(
        -7 // engine.plan.T)
    assert set(res.stats["traces_per_bucket"].values()) == {1}
    assert len(engine.batch_times) == res.stats["batches"]
    seq = sequential_traces(physics, shots, grid, params, engine.plan, 4,
                            dt, 7, device=dev)
    for got, want in zip(res.traces, seq):
        assert_fields_close(trace_channels(got, want), FIELD_RTOL, physics)


@pytest.mark.cuda
def test_survey_scratch_is_made_once_and_reused(monkeypatch):
    """The engine makes the kernel's scratch once, when it is built, and
    every launch of its executables gets that block: the same data_ptr
    across batches (4 shots in 4 buckets, one executable each) and across
    the remainder tile (nt = 5, T = 2)."""
    from repro_torch.core.grid import Grid
    from repro_torch.launch.stencil_survey import build_model, build_survey
    from repro_torch.survey import PlanCache, SurveyEngine

    dev = _card()
    shape = (32, 32, 24)
    grid = Grid(shape, (10.0,) * 3)
    dt = grid.cfl_dt(3000.0, 4)
    rng = np.random.RandomState(0)
    params = build_model("tti", shape, grid, rng, device=dev)
    shots = build_survey(grid, dt, 5, 4, rng)
    engine = SurveyEngine("tti", grid, params, 5, dt, bucket_cap=2,
                          plan=TBPlan((16, 16), 2, phys.TTI.step_radius(4)),
                          plan_cache=PlanCache(), device=dev)
    assert engine._scratch is not None
    seen = []
    launch = ops.EXECUTORS["cuda"]

    def spy(spec, *args, scratch=None, **kw):
        seen.append((spec.T, scratch.data_ptr()))
        return launch(spec, *args, scratch=scratch, **kw)

    monkeypatch.setitem(ops.EXECUTORS, "cuda", spy)
    res = engine.run(shots)
    assert res.stats["batches"] >= 2
    assert [T for T, _ in seen] == [2, 2, 1] * res.stats["batches"]
    assert {ptr for _, ptr in seen} == {engine._scratch.data_ptr()}


def _edge_case(physics, T, tile, seed=5):
    """A case whose source sits in a tile's halo with one grid point on the
    boundary of the region the first injection covers (tile 0's last row
    of it) and one just outside, and whose receiver's footprint is the
    corner of four tiles' centres."""
    make = acoustic_case if physics == "acoustic" else MULTI_CASES[physics]
    c = make(shape=(24, 16, 13), order=4, nt=8, nsrc=1, nrec=2, seed=seed)
    r = phys.PHYSICS[physics].step_radius(4)
    h = c.spacing[0]
    edge = tile[0] - 1 + (T - 1) * r + 0.5        # between two grid points
    src = np.array([[edge, 4.3, 6.4]]) * h
    rec = np.array([[tile[0] - 0.5, tile[1] - 0.5, 5.2], [3.2, 9.7, 7.6]]) * h
    return c._replace(src=src, rec=rec)


@pytest.mark.cuda
@pytest.mark.parametrize("physics", ["acoustic", "tti", "elastic"])
@pytest.mark.parametrize("T", [2, 3])
def test_trapezoid_edges_match_plain(physics, T):
    """A source point on a trapezoid boundary in the halo, another just
    outside it (the kernel skips it: it cannot reach the centre), and a
    receiver on the corner of four tiles: the kernel against the plain
    version, which injects everywhere in the window."""
    dev = _card()
    tile = (8, 8)
    c = _edge_case(physics, T, tile)
    if physics == "acoustic":
        spec, args = _operands(c, T, tile, dev)
        p = phys.ACOUSTIC
    else:
        p, spec, args = _mp_operands(c, T, tile, dev)
    assert float(args[3].abs().sum()) > 0          # the source is live
    if physics == "tti":                # halo 8 and 12: z-streamed
        assert ker.launch_plan(spec, p) is not None
    kst, krec = ker.tb_time_tile(spec, p, *args)
    pst, prec = ker.tb_time_tile_plain(spec, p, *args)
    torch.cuda.synchronize()
    atol = ATOL if physics == "acoustic" else MP_ATOL
    for k, q in zip((*kst, krec), (*pst, prec)):
        torch.testing.assert_close(k, q, rtol=RTOL, atol=atol)
    assert_fields_close(
        [(f, k.cpu(), q.cpu()) for f, k, q in zip(p.state_fields, kst, pst)]
        + [(f"rec[{i}]", krec[..., i].cpu(), prec[..., i].cpu())
           for i in range(p.rec_channels)], FIELD_RTOL, physics)
    assert float(prec.abs().max()) > 0             # the receivers saw it


# ---------------------------------------------------------------------------
# Kernel B1c: a sharded pass (per-row params and domain mask)
# ---------------------------------------------------------------------------

def _pass_case(physics, shape, nt, dev):
    """A case's state, params dict and sparse structures on `dev`."""
    p = phys.PHYSICS[physics]
    if physics == "acoustic":
        c = acoustic_case(shape=shape, nt=nt, nsrc=3, nrec=4, seed=7)
        state, params = (c.u0, c.u1), (c.m, c.damp)
    else:
        c = MULTI_CASES[physics](shape=shape, nt=nt, nsrc=3, nrec=4, seed=7)
        state, params = c.state, c.params
    state = tuple(torch.as_tensor(a, device=dev) for a in state)
    params = {f: torch.as_tensor(a, device=dev)
              for f, a in zip(p.param_fields, params)}
    return c, state, params, port_sparse(c, device=dev)


@pytest.mark.cuda
@pytest.mark.parametrize("physics", ["acoustic", "tti", "elastic"])
@pytest.mark.parametrize("nested", [False, True])
def test_sharded_kernel_matches_plain_and_single_device(physics, nested,
                                                        monkeypatch):
    """A 2x2 mesh on the card (4 shard rows a launch, each with its own
    params and mask): every pass's launch against the plain version on
    the same operands — flat passes, time-nested passes (the first with
    d_out > 0 on a grid rounded up to the tile: block 24 + 2 * 4 to 36 for
    tile 12), the remainder depth — and the result against the
    single-device run on the card."""
    from repro_torch.distributed import halo as H
    from repro_torch.launch.mesh import ShardMesh

    dev = _card()
    p = phys.PHYSICS[physics]
    r = p.step_radius(4)
    T = 4 if physics == "acoustic" else 2
    nt = 2 * T + 1
    c, state, params, (g, gr) = _pass_case(physics, (48, 48, 24), nt, dev)
    inner = (TBPlan((12, 12), T // 2, r) if nested else None)
    plan = H.DistTBPlan(mesh=ShardMesh((2, 2), devices=(dev,)),
                        grid_shape=c.shape, physics=p, T=T, dt=c.dt,
                        spacing=c.spacing, inner="cuda", inner_plan=inner)
    seen, streamed = [], []

    def compare(spec, physics_, *args, dom=None, param_copies=None,
                scratch=None):
        k = ker.tb_time_tile(spec, physics_, *args, dom=dom,
                             param_copies=param_copies, scratch=scratch)
        q = ker.tb_time_tile_plain(spec, physics_, *args, dom=dom)
        seen.append((spec.nx, spec.T))
        streamed.append(ker.launch_plan(spec, physics_) is not None)
        atol = ATOL if physics == "acoustic" else MP_ATOL
        for a, b in zip((*k[0], k[1]), (*q[0], q[1])):
            torch.testing.assert_close(a, b, rtol=RTOL, atol=atol)
        assert_fields_close(
            [(f, a.cpu(), b.cpu())
             for f, a, b in zip(p.state_fields, k[0], q[0])]
            + [(f"rec[{i}]", k[1][..., i].cpu(), q[1][..., i].cpu())
               for i in range(p.rec_channels)], FIELD_RTOL, physics)
        return k

    monkeypatch.setitem(ops.EXECUTORS, "cuda", compare)
    before = ker.launches
    st, rec = H.sharded_tb_propagate(plan, nt, state, params, g, gr)
    # (pass grid, pass depth): 2 tiles, then the depth-1 remainder
    want = ([(36, T // 2), (24, T // 2)] * 2 + [(24, 1)] if nested
            else [(24, T)] * 2 + [(24, 1)])
    assert seen == want and ker.launches - before == len(want)
    if physics == "tti":                # the flat passes: halo 8
        assert any(streamed)
    single = {"acoustic": lambda: ops.acoustic_tb_propagate(
        nt, *state, params["m"], params["damp"], g, gr,
        TBPlan((8, 8), T, r), 4, c.dt, c.spacing, device=dev),
        "tti": lambda: ops.tti_tb_propagate(
            nt, state, tuple(params.values()), g, gr, TBPlan((8, 8), T, r),
            4, c.dt, c.spacing, device=dev),
        "elastic": lambda: ops.elastic_tb_propagate(
            nt, state, tuple(params.values()), g, gr, TBPlan((8, 8), T, r),
            4, c.dt, c.spacing, device=dev)}[physics]
    sst, srec = single()
    if srec.dim() == 2:
        srec = srec[..., None]
    assert_fields_close(
        [(f, a.cpu(), b.cpu()) for f, a, b in zip(p.state_fields, st, sst)]
        + list(trace_channels(rec.cpu(), srec.cpu())), FIELD_RTOL,
        f"{physics} sharded vs single device")


@pytest.mark.cuda
@pytest.mark.parametrize("physics", ["acoustic", "tti", "elastic"])
def test_dom_grid_mask_equals_the_grid_predicate(physics):
    """With `dom` the grid's own mask and the params given one a row, the
    kernel equals the single-device launch bit for bit."""
    dev = _card()
    if physics == "acoustic":
        c = acoustic_case(shape=(32, 16, 29), nt=8, nsrc=3, nrec=4)
        spec, args = _operands(c, 2, (16, 8), dev)
        p = phys.ACOUSTIC
    else:
        c = MULTI_CASES[physics](shape=(32, 16, 29), nt=8, nsrc=3, nrec=4)
        p, spec, args = _mp_operands(c, 2, (16, 8), dev)
    pads, ppads, sc, sv, rc, rw = args
    h = spec.halo
    gx = torch.arange(-h, spec.nx + h, device=dev)
    gy = torch.arange(-h, spec.ny + h, device=dev)
    dom = (((gx >= 0) & (gx < spec.nx))[:, None]
           & ((gy >= 0) & (gy < spec.ny))).float()[None].contiguous()
    a_st, a_rec = ker.tb_time_tile(spec, p, *args)
    b_st, b_rec = ker.tb_time_tile(spec, p, pads,
                                   tuple(q[None].contiguous() for q in ppads),
                                   sc, sv, rc, rw, dom=dom)
    torch.cuda.synchronize()
    assert torch.equal(a_rec, b_rec)
    assert all(torch.equal(x, y) for x, y in zip(a_st, b_st))
    with pytest.raises(ValueError, match="dom"):
        ker.tb_time_tile(spec, p, *args, dom=dom[:, 1:].contiguous())


@pytest.mark.cuda
@pytest.mark.parametrize("physics", ["acoustic", "tti", "elastic"])
def test_dom_batch_of_three_equals_the_grid_predicate(physics):
    """B = 3 rows with `dom` (each the grid's mask) and the params one a
    row: bit for bit the batched launch without `dom`, and within the
    tolerances of the plain version."""
    dev = _card()
    p = phys.PHYSICS[physics]
    make = acoustic_case if physics == "acoustic" else MULTI_CASES[physics]
    cases = [(make(shape=(32, 16, 29), order=4, nt=8, nsrc=n, nrec=4,
                   seed=s), True) for n, s in ((1, 1), (3, 2), (2, 3))]
    spec, args = _batch_operands(p, cases, 2, (16, 8), dev)
    pads, ppads, sc, sv, rc, rw = args
    h = spec.halo
    gx = torch.arange(-h, spec.nx + h, device=dev)
    gy = torch.arange(-h, spec.ny + h, device=dev)
    dom = (((gx >= 0) & (gx < spec.nx))[:, None]
           & ((gy >= 0) & (gy < spec.ny))).float()
    dom = dom[None].expand(3, -1, -1).contiguous()
    rows = tuple(q[None].expand(3, *q.shape).contiguous() for q in ppads)
    a_st, a_rec = ker.tb_time_tile(spec, p, *args)
    b_st, b_rec = ker.tb_time_tile(spec, p, pads, rows, sc, sv, rc, rw,
                                   dom=dom)
    q_st, q_rec = ker.tb_time_tile_plain(spec, p, pads, rows, sc, sv, rc,
                                         rw, dom=dom)
    torch.cuda.synchronize()
    assert torch.equal(a_rec, b_rec)
    assert all(torch.equal(x, y) for x, y in zip(a_st, b_st))
    atol = ATOL if physics == "acoustic" else MP_ATOL
    for k, q in zip((*b_st, b_rec), (*q_st, q_rec)):
        torch.testing.assert_close(k, q, rtol=RTOL, atol=atol)


@pytest.mark.cuda
@pytest.mark.parametrize("physics", ["acoustic", "tti", "elastic"])
def test_launch_refuses_a_subtile_that_does_not_fit(physics, monkeypatch):
    """The C entry sizes a z-streamed block from the sub-tile it is given
    and refuses one whose shared memory exceeds a block's, or that does
    not divide the tile; the first schedule (0, 0) runs the same shape."""
    dev = _card()
    c = (acoustic_case if physics == "acoustic" else MULTI_CASES[physics])(
        shape=(16, 16, 13), order=16, nt=8, nsrc=3, nrec=4)
    if physics == "acoustic":
        spec, args = _operands(c, 4, (8, 8), dev)
        p = phys.ACOUSTIC
    else:
        p, spec, args = _mp_operands(c, 4, (8, 8), dev)
    with pytest.raises(ValueError):
        ker.stream_plan(spec, p)
    for bad in ((8, 8, 1), (3, 8, 1)):
        monkeypatch.setattr(ker, "launch_plan", lambda s, q, x=bad: x)
        with pytest.raises(RuntimeError, match="launch failed"):
            ker.tb_time_tile(spec, p, *args)
    monkeypatch.setattr(ker, "launch_plan", lambda s, q: None)
    kst, krec = ker.tb_time_tile(spec, p, *args)
    pst, prec = ker.tb_time_tile_plain(spec, p, *args)
    atol = ATOL if physics == "acoustic" else MP_ATOL
    for k, q in zip((*kst, krec), (*pst, prec)):
        torch.testing.assert_close(k, q, rtol=RTOL, atol=atol)


# B5 at halos 32 and 48 (TTI and elastic, orders 8 and 12, T = 4) on 2 x 2
# spec tiles: the default cluster (16 blocks a tile here, beyond the
# portable 8), one block a tile, 2 and 8; B6 (acoustic) at halos 16 (T =
# 4) and 12 (order 12, T = 2) with the cluster and planes a step
# `launch_plan` takes, at halo 24 with 16 blocks, and at halos 8 and 12
# (T = 2) with 2, 4 and 8 blocks a cluster at one or two planes a step
CLUSTER_CASES = [(p, o, 4, c, None) for p in ("tti", "elastic")
                 for o, c in ((8, None), (12, None), (8, 1), (12, 2),
                              (8, 8))] + [
    ("acoustic", 8, 4, None, None), ("acoustic", 12, 2, None, None),
    ("acoustic", 12, 4, 16, 2), ("acoustic", 8, 2, 2, 2),
    ("acoustic", 12, 2, 4, 2), ("acoustic", 8, 2, 8, 1),
    ("acoustic", 12, 2, 8, 1), ("acoustic", 8, 4, 4, 1)]


@pytest.mark.cuda
@pytest.mark.parametrize("physics,order,T,cluster,planes", CLUSTER_CASES)
def test_cluster_kernel_matches_first_and_plain(physics, order, T, cluster,
                                                planes, monkeypatch):
    """The cluster-shared schedules, the trapezoid B5 (TTI, elastic) and
    the z-wavefront B6 (acoustic), which `launch_plan` takes at these
    halos, equal the first schedule bit for bit (fields and receiver
    partials) and hold to the plain version; with `dom` the grid's own
    mask and the params one a row (the sharded layer's launch, B1c) each
    equals itself without them; B6's launch of two shots equals two
    single-shot launches."""
    dev = _card()
    if physics == "acoustic":
        p = phys.ACOUSTIC
        cases = [(acoustic_case(shape=(64, 64, 24), order=order, nt=8,
                                nsrc=3, nrec=4, seed=sd), True)
                 for sd in (1, 2)]
        spec, both = _batch_operands(p, cases, T, (32, 32), dev)
        args = tuple(tuple(f[:1] for f in a) if i == 0 else
                     a if i == 1 else a[:1] for i, a in enumerate(both))
        if cluster is None:
            plan = ker.launch_plan(spec, p)
            assert isinstance(plan, ker.WavePlan)
        else:
            plan = ker.wave_plan(spec, p, cluster, planes)
            assert plan.planes == planes
        atol = ATOL
    else:
        c = MULTI_CASES[physics](shape=(64, 64, 24), order=order, nt=8,
                                 nsrc=3, nrec=4)
        p, spec, args = _mp_operands(c, T, (32, 32), dev)
        plan = ker.launch_plan(spec, p)
        assert isinstance(plan, ker.ClusterPlan) and plan.cluster == 16
        if cluster is not None:
            plan = ker.cluster_plan(spec, p, cluster)
        atol = MP_ATOL
    kind = ker.schedule_name(plan)
    before = dict(ker.schedule_launches)
    monkeypatch.setattr(ker, "launch_plan", lambda s, q, x=plan: x)
    kst, krec = ker.tb_time_tile(spec, p, *args)
    monkeypatch.setattr(ker, "launch_plan", lambda s, q: None)
    fst, frec = ker.tb_time_tile(spec, p, *args)
    assert ker.schedule_launches[kind] == before[kind] + 1
    assert ker.schedule_launches["first"] == before["first"] + 1
    pst, prec = ker.tb_time_tile_plain(spec, p, *args)
    torch.cuda.synchronize()
    for k, f in zip((*kst, krec), (*fst, frec)):
        assert torch.equal(k, f)
    for k, q in zip((*kst, krec), (*pst, prec)):
        torch.testing.assert_close(k, q, rtol=RTOL, atol=atol)
    assert_fields_close(
        [(f, k.cpu(), q.cpu()) for f, k, q in zip(p.state_fields, kst, pst)]
        + [(f"rec[{i}]", krec[..., i].cpu(), prec[..., i].cpu())
           for i in range(p.rec_channels)], FIELD_RTOL, physics)
    assert float(prec.abs().max()) > 0
    pads, ppads, sc, sv, rc, rw = args
    h = spec.halo
    gx = torch.arange(-h, spec.nx + h, device=dev)
    gy = torch.arange(-h, spec.ny + h, device=dev)
    dom = (((gx >= 0) & (gx < spec.nx))[:, None]
           & ((gy >= 0) & (gy < spec.ny))).float()[None].contiguous()
    monkeypatch.setattr(ker, "launch_plan", lambda s, q, x=plan: x)
    dst, drec = ker.tb_time_tile(spec, p, pads,
                                 tuple(q[None].contiguous() for q in ppads),
                                 sc, sv, rc, rw, dom=dom)
    torch.cuda.synchronize()
    for k, d in zip((*kst, krec), (*dst, drec)):
        assert torch.equal(k, d)
    if physics == "acoustic":
        bst, brec = ker.tb_time_tile(spec, p, *both)
        pads2, _, sc2, sv2, rc2, rw2 = both
        ost, orec = ker.tb_time_tile(spec, p, tuple(f[1:] for f in pads2),
                                     ppads, sc2[1:], sv2[1:], rc2[1:],
                                     rw2[1:])
        torch.cuda.synchronize()
        assert float(brec[1].abs().max()) > 0
        for b, k in zip((*bst, brec), (*kst, krec)):
            assert torch.equal(b[:1], k)
        for b, k in zip((*bst, brec), (*ost, orec)):
            assert torch.equal(b[1:], k)


@pytest.mark.cuda
def test_wave_launch_refuses_a_parts_table_that_does_not_fit(monkeypatch):
    """The C entry checks B6's parts table before it launches: a block
    given less shared memory than its part needs, a cluster that is not
    px x py blocks, a cut line outside the tile, or one block holding a
    tile whose rings do not fit are refused; the table as planned runs."""
    dev = _card()
    c = acoustic_case(shape=(64, 64, 24), order=8, nt=8, nsrc=3, nrec=4)
    spec, args = _operands(c, 4, (32, 32), dev)
    p = phys.ACOUSTIC
    plan = ker.wave_plan(spec, p)
    assert plan.parts == (2, 2)
    wx, wy, _ = spec.window
    h = spec.halo
    bad = [dataclasses.replace(plan, smem=plan.smem // 2),
           dataclasses.replace(plan, cluster=2),
           dataclasses.replace(plan, xcuts=(0, h, wx)),
           dataclasses.replace(plan, cluster=1, parts=(1, 1),
                               xcuts=(0, wx), ycuts=(0, wy),
                               smem=ker._STREAM_SMEM)]
    assert ker.wave_smem(4, spec.radius, wx, wy, (0, wx), (0, wy)) \
        > ker._STREAM_SMEM
    for b in bad:
        monkeypatch.setattr(ker, "launch_plan", lambda s, q, x=b: x)
        with pytest.raises(RuntimeError, match="launch failed"):
            ker.tb_time_tile(spec, p, *args)
    monkeypatch.setattr(ker, "launch_plan", lambda s, q, x=plan: x)
    kst, krec = ker.tb_time_tile(spec, p, *args)
    pst, prec = ker.tb_time_tile_plain(spec, p, *args)
    for k, q in zip((*kst, krec), (*pst, prec)):
        torch.testing.assert_close(k, q, rtol=RTOL, atol=ATOL)


@pytest.mark.cuda
@pytest.mark.parametrize("physics", ["tti", "elastic"])
def test_cluster_launch_refuses_a_bad_chunk_table(physics, monkeypatch):
    """The C entry checks B5's chunk table before it launches: chunks that
    overlap, leave a point of a pass out, or need more shared memory than
    the launch gives are refused; the table as planned runs."""
    dev = _card()
    c = MULTI_CASES[physics](shape=(64, 64, 24), order=8, nt=8, nsrc=3,
                             nrec=4)
    p, spec, args = _mp_operands(c, 4, (32, 32), dev)
    plan = ker.cluster_plan(spec, p)
    first = plan.chunks[0]
    x0, y0, h, w = first[0][0]
    overlap = ((first[0] + ((x0, y0, 1, 1),),) + first[1:],)
    missing = ((first[0][1:],) + first[1:],)
    bad = [dataclasses.replace(plan, chunks=ch + plan.chunks[1:])
           for ch in (overlap, missing)]
    bad.append(dataclasses.replace(plan, smem=plan.smem // 4))
    for b in bad:
        monkeypatch.setattr(ker, "launch_plan", lambda s, q, x=b: x)
        with pytest.raises(RuntimeError, match="launch failed"):
            ker.tb_time_tile(spec, p, *args)
    monkeypatch.setattr(ker, "launch_plan", lambda s, q, x=plan: x)
    kst, krec = ker.tb_time_tile(spec, p, *args)
    pst, prec = ker.tb_time_tile_plain(spec, p, *args)
    for k, q in zip((*kst, krec), (*pst, prec)):
        torch.testing.assert_close(k, q, rtol=RTOL, atol=MP_ATOL)


@pytest.mark.cuda
def test_bf16_propagate_on_card_tracks_f32_and_cpu():
    """ops.acoustic_tb_propagate with bf16 fields runs kernel B1a-bf16,
    tracks the float32 run within the reference test's bound, and the
    plain bf16 run on the CPU within 2^-6 of its scale."""
    dev = _card()
    c = acoustic_case(nt=4)
    plan = TBPlan(tile=(8, 8), T=2, radius=2)
    g, gr = port_sparse(c, device=dev)
    (_, f1), _ = ops.acoustic_tb_propagate(
        c.nt, c.u0, c.u1, c.m, c.damp, g, gr, plan, 4, c.dt, c.spacing)
    bf = [torch.from_numpy(a).to(torch.bfloat16)
          for a in (c.u0, c.u1, c.m, c.damp)]
    before = ker.launches
    (_, b1), _ = ops.acoustic_tb_propagate(
        c.nt, *(a.to(dev) for a in bf), g, gr, plan, 4, c.dt, c.spacing)
    assert ker.launches == before + 2 and b1.dtype == torch.bfloat16
    cg, cgr = port_sparse(c, device="cpu")
    (_, h1), _ = ops.acoustic_tb_propagate(
        c.nt, *bf, cg, cgr, plan, 4, c.dt, c.spacing, device="cpu")
    bound = _bf16_bound(f1)
    b = b1.float().cpu()
    assert torch.isfinite(b).all()
    assert float((b - f1.cpu()).abs().max()) <= bound
    _bf16_close(b, h1)


# ---------------------------------------------------------------------------
# Kernel B2: the Mamba2 SSD chunked scan
# ---------------------------------------------------------------------------

SSD_RTOL, SSD_ATOL, SSD_FIELD_RTOL = 1e-4, 1e-5, 1e-5


def _ssd_inputs(shape, seed, dtype, with_h0, dev):
    """tests/test_kernel_ssd.py's draws; x, B and C in `dtype`, dt and A
    float32 (as block_forward makes them), h0 float32 or None."""
    from repro_torch.kernels import ssd_scan as ssd

    Bsz, S, H, G, N, P, Q = shape
    rng = np.random.RandomState(seed)
    x = rng.randn(Bsz, S, H, P)
    dtv = 0.1 + 0.5 * rng.rand(Bsz, S, H)
    Bm = rng.randn(Bsz, S, G, N)
    Cm = rng.randn(Bsz, S, G, N)
    A = -np.exp(0.3 * rng.randn(H))
    h0 = rng.randn(Bsz, H, N, P) if with_h0 else None
    t = lambda a, d=torch.float32: None if a is None else \
        torch.as_tensor(a, dtype=torch.float32, device=dev).to(d)  # noqa
    spec = ssd.SSDSpec(seq_len=S, chunk=Q, nheads=H, ngroups=G, headdim=P,
                       state=N)
    return spec, (t(x, dtype), t(dtv), t(Bm, dtype), t(Cm, dtype), t(A)), \
        t(h0)


def _ssd_close(got, want):
    err = float((got - want).abs().max())
    scale = float(want.abs().max())
    torch.testing.assert_close(got, want, rtol=SSD_RTOL,
                               atol=SSD_ATOL * max(1.0, scale))
    assert err <= SSD_FIELD_RTOL * scale, (err, scale)


# (B, S, H, G, N, P, Q)
SSD_SHAPES = [
    (2, 16, 4, 2, 8, 8, 4),          # tests/test_kernel_ssd.py's shapes
    (2, 32, 4, 2, 8, 8, 32),
    (1, 16, 2, 1, 4, 4, 8),
    (2, 24, 6, 3, 5, 8, 4),
    (3, 8, 4, 4, 16, 16, 8),
    (2, 256, 24, 1, 128, 64, 64),    # mamba2-130m's head shape
    (8, 1024, 24, 1, 128, 64, 64),   # its serve call
    (2, 64, 4, 1, 128, 64, 64),      # its head shape, one chunk
    (2, 256, 8, 2, 128, 64, 64),     # its head shape, two groups
    (2, 256, 8, 1, 64, 64, 128),     # zamba2-2.7b's head shape
]


@pytest.mark.cuda
@pytest.mark.parametrize("shape", SSD_SHAPES)
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("with_h0", [False, True])
def test_ssd_kernel_matches_plain(shape, dtype, with_h0):
    """Each schedule of B2 on the shapes it takes: tensor cores for bf16
    inputs at (N, P, Q) = (128, 64, 64) (four shapes) and (64, 64, 128)
    (zamba2-2.7b's), float32 cores for the rest (the float32 inputs at
    every shape, bf16 at the small ones)."""
    from repro_torch.kernels import ssd_scan as ssd

    dev = _card()
    spec, args, h0 = _ssd_inputs(shape, 3, dtype, with_h0, dev)
    tc = dtype == torch.bfloat16 and shape[4:] in ((128, 64, 64),
                                                   (64, 64, 128))
    assert ssd.schedule_of(spec, dtype) == ("tensor cores" if tc
                                            else "float32 cores")
    before = ssd.launches
    y, h = ssd.ssd_scan(spec, *args, h0=h0)
    assert ssd.launches == before + 1
    py, ph = ssd.ssd_scan_plain(spec, *args, h0=h0)
    torch.cuda.synchronize()
    assert y.dtype == torch.float32 and h.dtype == torch.float32
    _ssd_close(y, py)
    _ssd_close(h, ph)


@pytest.mark.cuda
def test_ssd_kernel_bf16_output():
    """A bf16 y within one bf16 rounding of the plain float32 y, on both
    schedules and at both head shapes of the tensor-core one."""
    from repro_torch.kernels import ssd_scan as ssd

    dev = _card()
    for shape in (SSD_SHAPES[3], SSD_SHAPES[7], SSD_SHAPES[9]):
        spec, args, h0 = _ssd_inputs(shape, 4, torch.bfloat16, True, dev)
        y, _ = ssd.ssd_scan(dataclasses.replace(spec, dtype=torch.bfloat16),
                            *args, h0=h0)
        py, _ = ssd.ssd_scan_plain(spec, *args, h0=h0)
        assert y.dtype == torch.bfloat16
        torch.testing.assert_close(
            y.float(), py, rtol=2 ** -8,
            atol=SSD_ATOL * max(1.0, float(py.abs().max())))


@pytest.mark.cuda
def test_ssd_tensor_core_schedule_refuses_other_shapes(monkeypatch):
    """The C entry takes the tensor-core schedule only for bf16 inputs at
    (N, P, Q) = (128, 64, 64) (mamba2-130m's heads) or (64, 64, 128)
    (zamba2-2.7b's): asked for it elsewhere, or for float32 inputs at
    those shapes, the launch is refused and the wrapper raises (no
    fallback)."""
    from repro_torch.kernels import ssd_scan as ssd

    dev = _card()
    monkeypatch.setattr(ssd, "schedule_of", lambda spec, dt: "tensor cores")
    for shape, dtype in ((SSD_SHAPES[4], torch.bfloat16),
                         (SSD_SHAPES[7], torch.float32),
                         (SSD_SHAPES[9], torch.float32)):
        spec, args, _ = _ssd_inputs(shape, 0, dtype, False, dev)
        before = ssd.launches
        with pytest.raises(RuntimeError, match="launch failed"):
            ssd.ssd_scan(spec, *args)
        assert ssd.launches == before


@pytest.mark.cuda
def test_ssd_tensor_core_tables_equal_the_mirrors():
    """The C library's intra-chunk parts (`repro_ssd_intra_jobs`) and
    shared bytes a block at both head shapes equal `ssd_scan.tc_intra_jobs`
    and `tc_smem_bytes`, which the CPU tests check; both shapes hold two
    blocks an SM."""
    import ctypes

    from repro_torch.kernels import ssd_scan as ssd

    _card()
    lib = ssd._bind()
    for N, P, Q in ssd.TC_SHAPES:
        out = (ctypes.c_int * (5 * ssd.TC_WARPS))()
        assert lib.repro_ssd_intra_jobs(Q, out) == ssd.TC_WARPS
        assert [tuple(out[5 * w:5 * w + 5]) for w in range(ssd.TC_WARPS)] \
            == ssd.tc_intra_jobs(Q)
        assert lib.repro_ssd_smem_bytes(N, P, Q, 1) == \
            ssd.tc_smem_bytes(N, P, Q)[0]
        assert lib.repro_ssd_blocks_per_sm(0, N, P, Q, 1) == 2
    assert lib.repro_ssd_smem_bytes(8, 8, 4, 1) == 0


@pytest.mark.cuda
def test_ssd_wrapper_rejects_what_the_kernel_does_not_take():
    from repro_torch.kernels import ssd_scan as ssd

    dev = _card()
    spec, (x, dtv, Bm, Cm, A), _ = _ssd_inputs(SSD_SHAPES[0], 0,
                                               torch.float32, False, dev)
    with pytest.raises(ValueError, match="cpu"):
        ssd.ssd_scan(spec, x, dtv, Bm, Cm, A.cpu())
    with pytest.raises(TypeError, match="dtype"):
        ssd.ssd_scan(spec, x.half(), dtv, Bm, Cm, A)
    with pytest.raises(TypeError, match="dtype"):
        ssd.ssd_scan(spec, x, dtv, Bm.bfloat16(), Cm, A)
    with pytest.raises(TypeError, match="dtype"):
        ssd.ssd_scan(spec, x, dtv.bfloat16(), Bm, Cm, A)
    with pytest.raises(ValueError, match="shape"):
        ssd.ssd_scan(spec, x, dtv, Bm[..., :-1].contiguous(), Cm, A)
    with pytest.raises(ValueError, match="contiguous"):
        ssd.ssd_scan(spec, x, dtv, Bm.transpose(1, 2).contiguous()
                     .transpose(1, 2), Cm, A)
    with pytest.raises(ValueError, match="divide"):
        ssd.ssd_scan(dataclasses.replace(spec, seq_len=15, chunk=4),
                     x[:, :15].contiguous(), dtv[:, :15].contiguous(),
                     Bm[:, :15].contiguous(), Cm[:, :15].contiguous(), A)
    big = ssd.SSDSpec(seq_len=256, chunk=256, nheads=1, ngroups=1,
                      headdim=64, state=128)
    z = torch.zeros
    with pytest.raises(ValueError, match="shared memory"):
        ssd.ssd_scan(big, z((1, 256, 1, 64), device=dev),
                     z((1, 256, 1), device=dev),
                     z((1, 256, 1, 128), device=dev),
                     z((1, 256, 1, 128), device=dev), z((1,), device=dev))


# the scan under a gradient (`ssd_scan.SSDScanFn`), as chip_smoke.py's
# train-mamba2 phase checks it: mamba2-130m's and zamba2-2.7b's head shapes
SSD_GRAD_SHAPES = [(2, 1024, 24, 1, 128, 64, 64), (2, 1024, 80, 1, 64, 64,
                                                    128)]
SSD_GRAD_TOL = 1e-4          # float32: max|diff| / max|plain gradient|
SSD_GRAD_TOL_BF16 = 2 ** -6  # bf16 inputs (chip_smoke.GRAD_TOL_BF16)


def _scan_grads(spec, args, cots, scan):
    leaves = [a.detach().clone().requires_grad_() for a in args]
    y, h = scan(spec, *leaves)
    return (torch.autograd.grad((y, h), leaves, cots), y.grad_fn,
            (y.detach(), h.detach()))


@pytest.mark.cuda
@pytest.mark.parametrize("shape", SSD_GRAD_SHAPES)
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_ssd_grads_through_kernel_match_plain(shape, dtype):
    """`ssd_scan` on grad-requiring card tensors launches B2 once through
    `SSDScanFn`; its y and h_final against `ssd_scan_plain`'s within the
    kernel's bounds (`_ssd_close`), and its gradients of x, dt, B, C and
    A (random cotangents on y and h_final) against autograd straight
    through `ssd_scan_plain`, in the inputs' dtypes and finite: float32
    within 1e-4 of each max|plain gradient|, bf16 (the tensor cores)
    within 2^-6 (the backward computes in float32 from the same inputs;
    the two differ by the final bf16 cast and the order of sums)."""
    from repro_torch.kernels import ssd_scan as ssd

    dev = _card()
    spec, args, _ = _ssd_inputs(shape, 5, dtype, False, dev)
    Bsz, S, H, G, N, P, Q = shape
    gen = torch.Generator(device=dev).manual_seed(6)
    cots = (torch.randn((Bsz, S, H, P), generator=gen, device=dev),
            torch.randn((Bsz, H, N, P), generator=gen, device=dev))
    before = ssd.launches
    got, fn, out = _scan_grads(spec, args, cots, ssd.ssd_scan)
    assert ssd.launches == before + 1
    assert type(fn).__name__ == "SSDScanFnBackward"
    want, _, plain = _scan_grads(spec, args, cots, ssd.ssd_scan_plain)
    torch.cuda.synchronize()
    for o, p in zip(out, plain):
        _ssd_close(o, p)
    tol = SSD_GRAD_TOL if dtype == torch.float32 else SSD_GRAD_TOL_BF16
    for g, w, a in zip(got, want, args):
        assert g.dtype == w.dtype == a.dtype
        assert torch.isfinite(g).all()
        err = float((g.float() - w.float()).abs().max())
        assert err <= tol * float(w.float().abs().max())


@pytest.mark.cuda
def test_ssd_cuda_launch_refuses_a_grad_requiring_input():
    """Reached under grad mode with an input that requires grad, the CUDA
    launch raises rather than cut the graph; `ssd_scan` itself goes
    through `SSDScanFn`, and under no_grad launches directly."""
    from repro_torch.kernels import ssd_scan as ssd

    dev = _card()
    spec, args, _ = _ssd_inputs(SSD_SHAPES[0], 0, torch.float32, False, dev)
    x = args[0].clone().requires_grad_()
    before = ssd.launches
    with pytest.raises(RuntimeError, match="SSDScanFn"):
        ssd._ssd_scan_cuda(spec, x, *args[1:], None)
    assert ssd.launches == before
    with torch.no_grad():
        y, _ = ssd._ssd_scan_cuda(spec, x, *args[1:], None)
    assert y.grad_fn is None and ssd.launches == before + 1
    y, _ = ssd.ssd_scan(spec, x, *args[1:])
    assert type(y.grad_fn).__name__ == "SSDScanFnBackward"


@pytest.mark.cuda
def test_train_step_on_card_matches_cpu():
    """REDUCED mamba2-130m in float32: a train step's loss and gradients on
    the card (B2 under remat="full": two launches a layer, the forward and
    the recompute) match the CPU's (the plain scan)."""
    from repro_torch import configs
    from repro_torch.configs.base import ShapeConfig
    from repro_torch.data.pipeline import make_batch
    from repro_torch.kernels import ssd_scan as ssd
    from repro_torch.launch import steps
    from repro_torch.models import api
    from repro_torch.tree import tree_leaves

    dev = _card()
    cfg = dataclasses.replace(configs.get_reduced("mamba2-130m"),
                              param_dtype="float32",
                              activation_dtype="float32")
    shape = ShapeConfig("t", 45, 2, "train")
    cpu_params = api.init(0, cfg, shape, device="cpu")
    batch = make_batch(cfg, shape, device="cpu")
    before = ssd.launches
    (loss, _, _), grads = steps.loss_and_grads(
        _to(cpu_params, dev), cfg, {k: v.to(dev) for k, v in batch.items()})
    assert ssd.launches == before + 2 * cfg.num_layers
    (want, _, _), wgrads = steps.loss_and_grads(cpu_params, cfg, batch)
    assert abs(float(loss) - float(want)) <= 1e-5 * abs(float(want))
    for g, w in zip(tree_leaves(grads), tree_leaves(wgrads)):
        assert float((g.cpu() - w).abs().max()) <= \
            SSD_GRAD_TOL * float(w.abs().max())


@pytest.mark.cuda
def test_mamba2_on_card_launches_b2_and_matches_cpu():
    """REDUCED float32 on the card: prefill launches B2 once a layer, its
    logits and cache match the CPU run (plain scan), and the engine's
    greedy tokens equal the CPU engine's."""
    from repro_torch import configs
    from repro_torch.kernels import ssd_scan as ssd
    from repro_torch.models import api
    from repro_torch.serving import GenerationEngine, Request

    dev = _card()
    cfg = dataclasses.replace(configs.get_reduced("mamba2-130m"),
                              param_dtype="float32",
                              activation_dtype="float32")
    cpu_params = api.init(0, cfg, device="cpu")
    params = {k: ({n: t.to(dev) for n, t in v.items()}
                  if isinstance(v, dict) else v.to(dev))
              for k, v in cpu_params.items()}
    toks = torch.as_tensor(np.random.RandomState(0).randint(
        0, cfg.vocab_size, (3, 21)), dtype=torch.int32)
    before = ssd.launches
    logits, cache = api.prefill(params, cfg, {"tokens": toks.to(dev)}, 32,
                                cache_dtype=torch.float32)
    assert ssd.launches == before + cfg.num_layers
    want, wcache = api.prefill(cpu_params, cfg, {"tokens": toks}, 32,
                               cache_dtype=torch.float32)
    for got, ref_ in ((logits, want), (cache.state, wcache.state),
                      (cache.conv, wcache.conv)):
        _ssd_close(got.cpu(), ref_)
    prompts = [np.asarray(toks[i, :n]) for i, n in enumerate((21, 9, 14))]
    outs = []
    for p_, d in ((params, dev), (cpu_params, "cpu")):
        eng = GenerationEngine(p_, cfg, max_len=32, batch_size=3, device=d)
        outs.append([r.output for r in eng.generate(
            [Request(prompt=p, max_new_tokens=6) for p in prompts])])
    for a, b in zip(*outs):
        np.testing.assert_array_equal(a, b)


def _to(tree, dev):
    return {k: _to(v, dev) if isinstance(v, dict) else v.to(dev)
            for k, v in tree.items()}


@pytest.mark.cuda
@pytest.mark.parametrize("arch", ["zamba2-2.7b", "qwen3-1.7b"])
def test_hybrid_and_dense_on_card_match_cpu(arch):
    """REDUCED float32 on the card: zamba2's prefill launches B2 once a
    Mamba2 layer (qwen3's none), logits and every cache tensor match the
    CPU run (plain scan, the same attention), one decode step matches, and
    the engine's greedy tokens equal the CPU engine's."""
    from repro_torch import configs
    from repro_torch.kernels import ssd_scan as ssd
    from repro_torch.models import api
    from repro_torch.serving import GenerationEngine, Request

    dev = _card()
    cfg = dataclasses.replace(configs.get_reduced(arch),
                              param_dtype="float32",
                              activation_dtype="float32")
    cpu_params = api.init(0, cfg, device="cpu")
    params = _to(cpu_params, dev)
    toks = torch.as_tensor(np.random.RandomState(0).randint(
        0, cfg.vocab_size, (3, 21)), dtype=torch.int32)
    before = ssd.launches
    logits, cache = api.prefill(params, cfg, {"tokens": toks.to(dev)}, 32,
                                cache_dtype=torch.float32)
    scans = cfg.num_layers if cfg.family == "hybrid" else 0
    assert ssd.launches == before + scans
    want, wcache = api.prefill(cpu_params, cfg, {"tokens": toks}, 32,
                               cache_dtype=torch.float32)
    _ssd_close(logits.cpu(), want)
    for f in cache._fields:
        if f != "length":
            _ssd_close(getattr(cache, f).cpu(), getattr(wcache, f))
    nxt = torch.argmax(want[:, -1:], dim=-1).to(torch.int32)
    step, _ = api.decode_step(params, cfg, nxt.to(dev), cache)
    wstep, _ = api.decode_step(cpu_params, cfg, nxt, wcache)
    _ssd_close(step.cpu(), wstep)
    prompts = [np.asarray(toks[i, :n]) for i, n in enumerate((21, 9, 14))]
    outs = []
    for p_, d in ((params, dev), (cpu_params, "cpu")):
        eng = GenerationEngine(p_, cfg, max_len=32, batch_size=3, device=d)
        outs.append([r.output for r in eng.generate(
            [Request(prompt=p, max_new_tokens=6) for p in prompts])])
    for a, b in zip(*outs):
        np.testing.assert_array_equal(a, b)


def _moe_oracle(p, cfg, x):
    """The dense top-k mixture in float64 on the CPU: every expert's
    SwiGLU on every token, each token keeping its top-k experts' outputs
    weighted by the router."""
    p = {k: v.detach().cpu().double() for k, v in p.items()}
    x2d = x.detach().cpu().double().reshape(-1, x.shape[-1])
    probs = torch.softmax(x2d @ p["router"], dim=-1)
    w, top = torch.topk(probs, cfg.experts_per_tok, dim=-1)
    w = w / w.sum(-1, keepdim=True)
    g = torch.einsum("nd,edf->enf", x2d, p["w_gate"])
    u = torch.einsum("nd,edf->enf", x2d, p["w_up"])
    out = torch.einsum("enf,efd->end", g * torch.sigmoid(g) * u,
                       p["w_down"])
    rows = torch.arange(len(x2d))
    y = sum(w[:, k, None] * out[top[:, k], rows]
            for k in range(cfg.experts_per_tok))
    return y.reshape(x.shape)


@pytest.mark.cuda
@pytest.mark.parametrize("arch", ["qwen3-moe-30b-a3b", "dbrx-132b"])
def test_moe_on_card_matches_dense_oracle_and_cpu(arch):
    """The MoE's capacity dispatch on the card, float32: at capacity
    factor E / K (nothing drops) `moe_block` within 1e-5 of max|ref| of
    the dense top-k oracle; at the config's own factor with the router
    biased to the last expert, which overflows (ROADMAP C5's case), the
    dispatch equals the CPU's bit for bit (slots, keep, order, buffer:
    only kept entries are written, so no write order can change it) and
    the output is within 1e-5 of the CPU's max."""
    from repro_torch import configs
    from repro_torch.models import moe

    dev = _card()
    base = dataclasses.replace(configs.get_reduced(arch),
                               param_dtype="float32",
                               activation_dtype="float32")
    E, K = base.num_experts, base.experts_per_tok
    p = moe.init_moe(torch.Generator().manual_seed(0), base)
    x = torch.randn((4, 16, base.d_model),
                    generator=torch.Generator().manual_seed(1))
    nodrop = dataclasses.replace(base, capacity_factor=E / K)
    got = moe.moe_block(_to(p, dev), nodrop, x.to(dev))[0].cpu().double()
    want = _moe_oracle(p, nodrop, x)
    assert float((got - want).abs().max()) <= 1e-5 * float(want.abs().max())

    x[..., 0] = 3.0
    p["router"][0] = 0.0
    p["router"][0, E - 1] = 2.0
    x2d = x.reshape(-1, base.d_model)
    idx, w, _ = moe.route(p, base, x2d)
    C = moe.capacity(len(x2d), base)
    assert int((idx == E - 1).sum()) > C
    on_cpu = moe.dispatch(base, x2d, idx, w, C)
    on_card = moe.dispatch(base, x2d.to(dev), idx.to(dev), w.to(dev), C)
    for a, b in zip(on_card, on_cpu):
        assert torch.equal(a.cpu(), b)
    y_card = moe.moe_block(_to(p, dev), base, x.to(dev))[0].cpu()
    y_cpu = moe.moe_block(p, base, x)[0]
    assert float((y_card - y_cpu).abs().max()) <= 1e-5 * float(
        y_cpu.abs().max())
