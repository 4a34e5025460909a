"""The port's sharded layer (`repro_torch.distributed.halo`) against the JAX
package's (`repro.distributed.halo`), on the CPU.

The reference's driver (`sharded_tb_propagate`, `shard_map`) does not run
under this container's JAX (ROADMAP C1), so its pieces that run without
`shard_map` are compared with their ports one for one on the same numpy
inputs — the exchange driven by the collective-free `shift_fns` simulator
of tests/test_distributed_properties.py, the per-pass tables (equal),
`_run_pass`'s jnp branch, `_split_first_step`, `_combine_pass`, the plan's
field depths and validation messages, `plan_hierarchy` and the plan-cache
key — and the port's whole driver is held to the single-device oracles:
the Listing-1 references (`repro.kernels.ref`) and the reference's
``_tb_propagate(executor="jnp")``, with the reference launcher's rule
``max|err| <= 5e-4 * scale + 1e-6`` and, per field and receiver channel,
`FIELD_RTOL` of its own scale.
"""
import types

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core import sources as JS
from repro.core.grid import Grid as JGrid
from repro.core.propagators import elastic as jel, tti as jtt
from repro.core import temporal_blocking as jtb
from repro.distributed import halo as JH
from repro.kernels import ops as jops, ref as jref, tb_physics as jphys
from repro.survey import plan_cache as jpc
from repro_torch.core import temporal_blocking as ttb
from repro_torch.core.grid import Grid
from repro_torch.distributed import halo as H
from repro_torch.kernels import stencil_tb as ker, tb_physics as tphys
from repro_torch.launch import mesh as mesh_lib, stencil_dist
from repro_torch.survey import PlanCache, Shot, SurveyEngine, \
    plan_cache as tpc
from repro_torch.telemetry import drift as tdrift
from repro.telemetry import drift as jdrift
from test_torch_case import FIELD_RTOL, acoustic_case, elastic_case, \
    field_err, port_sparse, tti_case

CPU = ("cpu",)
# the reference's own hardware constants, passed explicitly to both
REF_HW = dict(vmem_budget=96 * 2 ** 20, peak_flops=197e12, hbm_bw=819e9,
              link_bw=45e9, link_latency=1.5e-6)


def _fake_mesh(px, py):
    """What a reference `DistTBPlan` reads of its mesh (pgrid -> block)."""
    return types.SimpleNamespace(shape={"data": px, "model": py})


def _plans(physics, pgrid, shape, order=4, T=2, dt=1e-3, **kw):
    """(reference DistTBPlan over a fake mesh, inner "jnp"; the port's on
    a CPU ShardMesh, inner "torch"), same fields."""
    common = dict(grid_shape=shape, order=order, T=T, dt=dt,
                  spacing=(10.0,) * 3, **kw)
    jp = JH.DistTBPlan(mesh=_fake_mesh(*pgrid),
                       physics=jphys.PHYSICS[physics], inner="jnp", **common)
    tp = H.DistTBPlan(mesh=mesh_lib.ShardMesh(pgrid, devices=CPU),
                      physics=tphys.PHYSICS[physics], inner="torch", **common)
    return jp, tp


# ---------------------------------------------------------------------------
# Exchange
# ---------------------------------------------------------------------------

def _sim_shifts(nbrs):
    """The reference test's collective-free `(from_low, from_high)` pair
    for ONE shard, fed from its 3x3 neighbourhood `nbrs[(di, dj)]` (None
    at the domain edge); y strips come from the neighbour's x-padded
    block (tests/test_distributed_properties.py)."""
    def zeros(x, h, dim):
        shape = list(x.shape)
        shape[dim] = h
        return jnp.zeros(shape, x.dtype)

    def xpad(nb, col, hx):
        west, east = nbrs.get((-1, col)), nbrs.get((1, col))
        lo = west[-hx:] if west is not None else jnp.zeros(
            (hx,) + nb.shape[1:], nb.dtype)
        hi = east[:hx] if east is not None else jnp.zeros(
            (hx,) + nb.shape[1:], nb.dtype)
        return jnp.concatenate([lo, nb, hi], axis=0)

    def strip(x, h, dim, side):
        col = -1 if side == "low" else 1
        if dim == 0:
            nb = nbrs.get((col, 0))
            if nb is None:
                return zeros(x, h, 0)
            return nb[-h:] if side == "low" else nb[:h]
        nb = nbrs.get((0, col))
        if nb is None:
            return zeros(x, h, 1)
        hx = (x.shape[0] - nb.shape[0]) // 2
        nbp = xpad(nb, col, hx) if hx else nb
        return nbp[:, -h:] if side == "low" else nbp[:, :h]

    return (lambda x, h, axis_name, dim: strip(x, h, dim, "low"),
            lambda x, h, axis_name, dim: strip(x, h, dim, "high"))


@pytest.mark.parametrize("pgrid,block,h,depth", [
    ((3, 3), (4, 4, 2), 3, 3), ((3, 3), (6, 4, 3), 4, 2),
    ((2, 3), (8, 6, 2), 2, 0), ((1, 2), (4, 6, 2), 1, 1),
    ((3, 1), (5, 4, 3), 4, 1)])
def test_exchange_matches_reference(pgrid, block, h, depth):
    """`exchange_to_depth` and `halo_exchange_2d` on a whole shard grid
    equal, shard for shard, the reference's driven by the simulator."""
    px, py = pgrid
    rng = np.random.RandomState(px * 10 + py + h)
    grid = [[rng.randn(*block).astype(np.float32) for _ in range(py)]
            for _ in range(px)]
    tblocks = [[torch.as_tensor(b) for b in row] for row in grid]
    mesh = mesh_lib.ShardMesh(pgrid, devices=CPU)
    got = H.exchange_to_depth(tblocks, depth, h, mesh=mesh)
    full = H.halo_exchange_2d(tblocks, h)
    assert mesh.exchange_rounds == (1 if depth else 0)
    for i in range(px):
        for j in range(py):
            nbrs = {(di, dj): (jnp.asarray(grid[i + di][j + dj])
                               if 0 <= i + di < px and 0 <= j + dj < py
                               else None)
                    for di in (-1, 0, 1) for dj in (-1, 0, 1)
                    if (di, dj) != (0, 0)}
            shifts = _sim_shifts(nbrs)
            centre = jnp.asarray(grid[i][j])
            want = JH.exchange_to_depth(centre, depth, h, "x", "y",
                                        shift_fns=shifts)
            np.testing.assert_array_equal(got[i][j].numpy(),
                                          np.asarray(want))
            np.testing.assert_array_equal(
                full[i][j].numpy(),
                np.asarray(JH.halo_exchange_2d(centre, h, "x", "y",
                                               shift_fns=shifts)))


def test_exchange_takes_injected_shift_fns():
    """`shift_fns` stays injectable: a provider pair that returns ones
    fills every halo cell with ones, whatever the neighbours."""
    blocks = [[torch.zeros(2, 2, 1) for _ in range(2)] for _ in range(2)]

    def ones(bl, h, dim):
        return [[torch.ones(*(h if d == dim else s
                              for d, s in enumerate(b.shape))) for b in row]
                for row in bl]

    out = H.halo_exchange_2d(blocks, 1, shift_fns=(ones, ones))
    want = torch.ones(4, 4, 1)
    want[1:3, 1:3] = 0.0
    assert all(torch.equal(b, want) for row in out for b in row)


# ---------------------------------------------------------------------------
# Plan: field depths, validation, domain mask
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("physics", ["acoustic", "tti", "elastic"])
def test_field_depths_and_physics_data_match_reference(physics):
    tp, jp = tphys.PHYSICS[physics], jphys.PHYSICS[physics]
    assert tp.param_fills == jp.param_fills
    assert tp.halo_lags == jp.halo_lags
    for order in (2, 4, 8):
        for T in (1, 2, 3, 5):
            assert tp.field_halo_depths(T, order) == \
                jp.field_halo_depths(T, order)
            for per_field in (True, False):
                a, b = _plans(physics, (2, 2), (64, 64, 8), order=order,
                              T=T, per_field_halo=per_field)
                assert b.field_depths(T) == a.field_depths(T)
                assert b.halo == a.halo and b.block == a.block


@pytest.mark.parametrize("kw", [
    dict(grid_shape=(30, 32, 8)),                    # does not divide
    dict(T=5),                                       # halo above the block
    dict(inner_plan=ttb.TBPlan((3, 8), 1, 2)),       # tile does not divide
    dict(inner_plan=ttb.TBPlan((4, 8), 3, 2)),       # inner T above T
    dict(inner="x"),
])
def test_validate_messages_match_reference(kw):
    kw = dict(kw)
    shape = kw.pop("grid_shape", (32, 32, 8))
    inner = kw.pop("inner", None)
    jkw = dict(kw)
    if "inner_plan" in kw:
        p = kw["inner_plan"]
        jkw["inner_plan"] = jtb.TBPlan(p.tile, p.T, p.radius)
    jp, _ = _plans("acoustic", (4, 2), shape, **jkw)
    _, tp = _plans("acoustic", (4, 2), shape, **kw)
    if inner is not None:
        jp, tp = jp._replace(inner=inner), tp._replace(inner=inner)
    with pytest.raises(ValueError) as je:
        jp.validate()
    with pytest.raises(ValueError) as te:
        tp.validate()
    assert str(te.value) == str(je.value)


def test_cuda_inner_needs_a_card():
    _, tp = _plans("acoustic", (2, 2), (32, 32, 8))
    with pytest.raises(ValueError, match="inner='cuda'"):
        tp._replace(inner="cuda").validate()
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="cuda"):
            mesh_lib.ShardMesh((2, 2))
        with pytest.raises(RuntimeError, match="cuda"):
            mesh_lib.make_xy_mesh(4)


@pytest.mark.parametrize("n,want", [(1, (1, 1)), (2, (2, 1)), (4, (2, 2)),
                                    (8, (4, 2)), (16, (8, 2))])
def test_xy_mesh_heuristic_and_devices(n, want):
    mesh = mesh_lib.make_xy_mesh(n, devices=CPU)
    assert mesh.pgrid == want and mesh.shape == {"data": want[0],
                                                  "model": want[1]}
    # every shard on the one device: one group, one launch a pass
    assert [ks for _, ks in mesh.groups()] == [list(range(n))]
    assert all(mesh.device_of(k) == torch.device("cpu") for k in range(n))


@pytest.mark.parametrize("shard", [(0, 0), (1, 0), (3, 1)])
def test_local_domain_mask(shard):
    _, tp = _plans("acoustic", (4, 2), (32, 32, 8))
    h = 3
    dom = H._local_domain_mask(tp, h, shard, "cpu")
    bx, by = tp.block
    assert dom.shape == (bx + 2 * h, by + 2 * h, 1)
    gx = shard[0] * bx - h + np.arange(bx + 2 * h)
    gy = shard[1] * by - h + np.arange(by + 2 * h)
    want = ((gx >= 0) & (gx < 32))[:, None] & ((gy >= 0) & (gy < 32))
    np.testing.assert_array_equal(dom[..., 0].numpy(), want)


# ---------------------------------------------------------------------------
# Per-pass tables
# ---------------------------------------------------------------------------

def _sparse_pair(c):
    """(reference g, gr), (port g, gr) of one case."""
    grid = JGrid(shape=c.shape, spacing=c.spacing)
    jg = JS.precompute(JS.SparseOperator(c.src), grid, c.wav)
    jgr = JS.precompute_receivers(JS.SparseOperator(c.rec), grid)
    return (jg, jgr), port_sparse(c)


def _pass_geoms(block, tile, T_steps, inner_T, r):
    geoms = jtb.nested_pass_geometry(block, tile, T_steps, inner_T, r)
    h = T_steps * r
    og = jtb.TBPassGeom(T=1, t0=0, d_in=h, d_out=0, halo=h, grid=block,
                        tile=block, ntiles=(1, 1), include_halo=T_steps > 1)
    return geoms + [og]


@pytest.mark.parametrize("pgrid,tile,T_steps,inner_T,r", [
    ((4, 2), (4, 8), 4, 2, 2), ((4, 2), (8, 16), 2, 2, 2),
    ((2, 2), (8, 8), 3, 1, 1), ((2, 2), (16, 16), 2, 2, 4)])
def test_pass_tables_equal_reference(pgrid, tile, T_steps, inner_T, r):
    c = acoustic_case(shape=(32, 32, 16), nt=4, nsrc=5, nrec=6, seed=3)
    (jg, jgr), (tg, tgr) = _sparse_pair(c)
    jp, tp = _plans("acoustic", pgrid, c.shape)
    for geom in _pass_geoms(tp.block, tile, T_steps, inner_T, r):
        for got, want in ((H._pass_source_tables(tp, tg, geom),
                           JH._pass_source_tables(jp, jg, geom)),
                          (H._pass_receiver_tables(tp, tgr, geom),
                           JH._pass_receiver_tables(jp, jgr, geom)),
                          (H._pass_source_tables(tp, None, geom),
                           JH._pass_source_tables(jp, None, geom)),
                          (H._pass_receiver_tables(tp, None, geom),
                           JH._pass_receiver_tables(jp, None, geom))):
            for a, b in zip(got, want):
                assert a.dtype == np.asarray(b).dtype
                np.testing.assert_array_equal(a, np.asarray(b))


def test_pass_table_overflow_messages_equal_reference():
    c = acoustic_case(shape=(32, 32, 16), nt=4, nsrc=5, nrec=6, seed=3)
    (jg, jgr), (tg, tgr) = _sparse_pair(c)
    jp, tp = _plans("acoustic", (2, 2), c.shape)
    geom = jtb.nested_pass_geometry(tp.block, (8, 8), 2, 2, 2)[0]
    for fn_t, fn_j, a, b in (
            (H._pass_source_tables, JH._pass_source_tables, tg, jg),
            (H._pass_receiver_tables, JH._pass_receiver_tables, tgr, jgr)):
        with pytest.raises(ValueError) as te:
            fn_t(tp, a, geom, cap=1)
        with pytest.raises(ValueError) as je:
            fn_j(jp, b, geom, cap=1)
        assert str(te.value) == str(je.value)
        assert "shard" in str(te.value) and "requires cap=" in str(te.value)


def test_combine_pass_matches_reference():
    rng = np.random.RandomState(0)
    parts = rng.randn(2, 2, 3, 4, 5, 2).astype(np.float32)
    rid = rng.randint(-1, 6, size=(2, 2, 3, 5)).astype(np.int32)
    got = H._combine_pass(torch.as_tensor(parts), rid, 6)
    want = JH._combine_pass(jnp.asarray(parts), rid, 6)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-6,
                               atol=1e-6)


# ---------------------------------------------------------------------------
# One pass, and the split first step, on one shard's arrays
# ---------------------------------------------------------------------------

def _case(physics, shape, nt=4, seed=0):
    if physics == "acoustic":
        c = acoustic_case(shape=shape, nt=nt, seed=seed)
        return c, (c.u0, c.u1), (c.m, c.damp)
    c = (tti_case if physics == "tti" else
         lambda **k: elastic_case(si=True, **k))(shape=shape, nt=nt,
                                                 seed=seed)
    return c, c.state, c.params


def _shard_inputs(physics, tp, c, state, params, shard, h_full, d_in, rng):
    """One shard's padded state (depth d_in, random halo), padded params
    (depth h_full, `param_fills` outside the domain) and domain mask."""
    p = tphys.PHYSICS[physics]
    bx, by = tp.block
    i, j = shard
    dom = H._local_domain_mask(tp, h_full, shard, "cpu").numpy()
    state_pads = []
    for a in state:
        pad = np.pad(a, ((h_full,) * 2, (h_full,) * 2, (0, 0)))
        win = pad[i * bx:i * bx + bx + 2 * h_full,
                  j * by:j * by + by + 2 * h_full]
        crop = h_full - d_in
        win = win[crop:win.shape[0] - crop, crop:win.shape[1] - crop]
        state_pads.append(np.ascontiguousarray(win))
    fills = dict(p.param_fills)
    param_pads = []
    for f, a in zip(p.param_fields, params):
        pad = np.pad(a, ((h_full,) * 2, (h_full,) * 2, (0, 0)), mode="edge")
        win = pad[i * bx:i * bx + bx + 2 * h_full,
                  j * by:j * by + by + 2 * h_full]
        win = np.where(dom > 0, win, np.float32(fills.get(f, 0.0)))
        param_pads.append(np.ascontiguousarray(win, np.float32))
    return state_pads, param_pads, dom


@pytest.mark.parametrize("physics,pgrid,shape,tile,T_steps,inner_T,shard", [
    ("acoustic", (2, 2), (24, 24, 8), (8, 8), 3, 1, (1, 0)),  # garbage band
    ("acoustic", (2, 2), (32, 32, 8), (16, 16), 2, 2, (0, 1)),  # flat
    ("tti", (2, 2), (24, 24, 8), (8, 8), 2, 1, (0, 0)),
    ("elastic", (2, 2), (24, 24, 8), (8, 8), 2, 1, (1, 1)),
])
def test_run_pass_matches_reference_jnp(physics, pgrid, shape, tile,
                                        T_steps, inner_T, shard):
    """Every pass of a (time-nested) schedule on one shard: the port's
    `_run_pass` ("torch") equals the reference's jnp branch — including a
    pass whose grid is rounded up to the tile (a garbage band)."""
    c, state, params = _case(physics, shape)
    (jg, jgr), (tg, tgr) = _sparse_pair(c)
    jp, tp = _plans(physics, pgrid, shape, T=T_steps, dt=c.dt)
    r = tp.r_step
    h_full = T_steps * r
    rng = np.random.RandomState(1)
    geoms = jtb.nested_pass_geometry(tp.block, tile, T_steps, inner_T, r)
    # the 24-wide cases round a pass's grid up to the tile
    assert any(g.grid[0] > tp.block[0] + 2 * g.d_out for g in geoms) == \
        (shape[0] == 24)
    k = shard[0] * pgrid[1] + shard[1]
    for geom in geoms:
        spads, ppads, dom = _shard_inputs(physics, tp, c, state, params,
                                          shard, h_full, geom.d_in, rng)
        sc, sid, sm = H._pass_source_tables(tp, tg, geom)
        rc, rw, _ = H._pass_receiver_tables(tp, tgr, geom)
        sc, sid, sm, rc, rw = (a.reshape((-1,) + a.shape[2:])[k]
                               for a in (sc, sid, sm, rc, rw))
        wav = rng.randn(geom.T, tg.npts).astype(np.float32)
        sv = np.transpose(wav[:, np.maximum(sid, 0)] * sm, (1, 0, 2))
        sv = np.ascontiguousarray(sv, np.float32)
        jst, jrec = JH._run_pass(
            jp, geom, tuple(jnp.asarray(a) for a in spads),
            tuple(jnp.asarray(a) for a in ppads),
            jnp.asarray(np.broadcast_to(dom, dom.shape[:2] + (shape[2],))),
            h_full, jnp.asarray(sc), jnp.asarray(sv), jnp.asarray(rc),
            jnp.asarray(rw), True)
        T1 = lambda a: torch.as_tensor(a)[None]  # noqa: E731
        tst, trec = H._run_pass(tp, geom, tuple(T1(a) for a in spads),
                                tuple(T1(a) for a in ppads), T1(dom),
                                h_full, T1(sc), T1(sv), T1(rc), T1(rw))
        for f, a, b in zip(tphys.PHYSICS[physics].state_fields, tst, jst):
            assert a.shape[1:] == b.shape, f
            np.testing.assert_allclose(a[0].numpy(), np.asarray(b),
                                       rtol=2e-4, atol=1e-6, err_msg=f)
            assert field_err(a[0].numpy(), np.asarray(b)) <= FIELD_RTOL, f
        np.testing.assert_allclose(trec[0].numpy(), np.asarray(jrec),
                                   rtol=2e-4, atol=1e-6)


@pytest.mark.parametrize("physics,shard", [("acoustic", (0, 1)),
                                           ("tti", (1, 1)),
                                           ("elastic", (1, 0))])
def test_split_first_step_matches_reference(physics, shard):
    shape = (32, 32, 8)
    c, state, params = _case(physics, shape)
    (jg, jgr), (tg, tgr) = _sparse_pair(c)
    jp, tp = _plans(physics, (2, 2), shape, T=2, dt=c.dt)
    h = 2 * tp.r_step
    rng = np.random.RandomState(2)
    spads, ppads, dom = _shard_inputs(physics, tp, c, state, params, shard,
                                      h, h, rng)
    bx, by = tp.block
    blocks = [a[h:h + bx, h:h + by] for a in spads]
    og = _pass_geoms(tp.block, tp.block, 2, 2, tp.r_step)[-1]
    k = shard[0] * 2 + shard[1]
    sc, sid, sm = (a.reshape((-1,) + a.shape[2:])[k][0]
                   for a in H._pass_source_tables(tp, tg, og))
    rc, rw, _ = (a.reshape((-1,) + a.shape[2:])[k][0]
                 for a in H._pass_receiver_tables(tp, tgr, og))
    sv0 = (rng.randn(tg.npts)[np.maximum(sid, 0)] * sm).astype(np.float32)
    J = jnp.asarray
    jst, jrec = JH._split_first_step(
        jp, JH._StepSpec(c.dt, c.spacing, 4), h, tuple(J(a) for a in blocks),
        tuple(J(a) for a in spads), tuple(J(a) for a in ppads),
        J(np.broadcast_to(dom, dom.shape[:2] + (shape[2],))), J(sc), J(sv0),
        J(rc), J(rw))
    T_ = torch.as_tensor
    tst, trec = H._split_first_step(
        tp, H._StepSpec(c.dt, c.spacing, 4), h, tuple(T_(a) for a in blocks),
        tuple(T_(a) for a in spads), tuple(T_(a) for a in ppads), T_(dom),
        T_(sc), T_(sv0), T_(rc), T_(rw))
    for f, a, b in zip(tphys.PHYSICS[physics].state_fields, tst, jst):
        np.testing.assert_allclose(a.numpy(), np.asarray(b), rtol=2e-4,
                                   atol=1e-6, err_msg=f)
        assert field_err(a.numpy(), np.asarray(b)) <= FIELD_RTOL, f
    np.testing.assert_allclose(trec.numpy(), np.asarray(jrec), rtol=2e-4,
                               atol=1e-6)


@pytest.mark.parametrize("physics", ["acoustic", "elastic"])
def test_pass_inner_spec_matches_reference(physics):
    from repro.kernels import ops as jops_
    from repro_torch.kernels import ops as tops

    r = tphys.PHYSICS[physics].step_radius(4)
    for geom in jtb.nested_pass_geometry((24, 24), (12, 12), 3, 2, r):
        a = tops.pass_inner_spec(geom, 16, 4, 1e-3, (10.0,) * 3, 5, 7,
                                 torch.float32, tphys.PHYSICS[physics])
        b = jops_.pass_inner_spec(geom, 16, 4, 1e-3, (10.0,) * 3, 5, 7,
                                  jnp.float32, jphys.PHYSICS[physics])
        assert (a.nx, a.ny, a.nz, a.tile, a.T, a.halo, a.window, a.ntiles,
                a.src_cap, a.rec_cap, a.rec_channels) == \
            (b.nx, b.ny, b.nz, b.tile, b.T, b.halo, b.window, b.ntiles,
             b.src_cap, b.rec_cap, b.rec_channels)
    with pytest.raises(ValueError, match="must divide the shard block"):
        tops.make_inner_spec((24, 24), 16, (10, 12), 1, 4, 1e-3,
                             (10.0,) * 3, 1, 1, torch.float32,
                             tphys.PHYSICS[physics])


# ---------------------------------------------------------------------------
# The hierarchical plan and its cache
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("physics,nz,block,kw", [
    ("acoustic", 64, (32, 32), dict(tiles=(8, 16, 32), depths=(1, 2, 4))),
    ("elastic", 128, (64, 32), dict(tiles=(8, 16, 32), depths=(1, 2))),
    ("tti", 64, (32, 32), dict(tiles=(16, 32), depths=(1, 2),
                               outer_depths=(2, 4), sweep_overlap=False)),
])
def test_plan_hierarchy_matches_reference(physics, nz, block, kw):
    args = {**REF_HW, **kw}
    th, tlog = ttb.plan_hierarchy(physics, nz, 4, block, **args)
    jh, jlog = jtb.plan_hierarchy(physics, nz, 4, block, **args)
    assert th.to_dict() == jh.to_dict()
    assert tlog.best_key == jlog.best_key and tlog == jlog
    assert ttb.HierPlan.from_dict(th.to_dict()) == th
    assert (th.T, th.halo, th.outer.to_dict()) == \
        (jh.T, jh.halo, jh.outer.to_dict())
    assert th.vmem_bytes(nz, 5) == jh.vmem_bytes(nz, 5)
    assert th.exchange_bytes(nz) == jh.exchange_bytes(nz)
    assert th.exchange_bytes_uniform(nz) == jh.exchange_bytes_uniform(nz)


def test_cached_plan_hierarchy_key_and_entry_match_reference(tmp_path):
    import inspect
    kw = {k: p.default for k, p in
          inspect.signature(jtb.autotune_plan).parameters.items()
          if p.default is not inspect.Parameter.empty
          and k not in ("mesh_block", "outer_depths", "sweep_overlap")}
    kw.update(tiles=(8, 16), depths=(1, 2))
    cache = tpc.PlanCache(disk_dir=str(tmp_path / "plans"))
    hier, entry, info = tpc.cached_plan_hierarchy(
        "elastic", 32, 4, (16, 16), cache=cache,
        key_extra={"use": "x"}, **kw)
    jhier, jentry, jinfo = jpc.cached_plan_hierarchy(
        "elastic", 32, 4, (16, 16), cache=jpc.PlanCache(),
        key_extra={"use": "x"}, **kw)
    assert info.key == jinfo.key and not info.hit
    assert hier.to_dict() == jhier.to_dict() and entry == jentry
    again = tpc.PlanCache(disk_dir=str(tmp_path / "plans"))
    hier2, entry2, info2 = tpc.cached_plan_hierarchy(
        "elastic", 32, 4, (16, 16), cache=again, key_extra={"use": "x"},
        **kw)
    assert info2.hit and again.sweeps == 0 and hier2 == hier
    assert entry2 == entry


@pytest.mark.parametrize("overlap,outer_T", [(False, None), (True, 4)])
def test_drift_prediction_matches_reference(overlap, outer_T):
    hw = {k: REF_HW[k] for k in ("peak_flops", "hbm_bw", "link_bw",
                                 "link_latency")}
    got = tdrift.predict_plan_terms(
        "elastic", 64, 4, ttb.TBPlan((8, 8), 2, 4), outer_T=outer_T,
        block=(32, 32), overlap=overlap, **hw)
    want = jdrift.predict_plan_terms(
        "elastic", 64, 4, jtb.TBPlan((8, 8), 2, 4), outer_T=outer_T,
        block=(32, 32), overlap=overlap, **hw)
    assert got == want
    # defaults: the port's plan model's (the H100 data sheet's)
    assert tdrift.predict_plan_terms(
        "acoustic", 64, 4, ttb.TBPlan((8, 8), 2, 2))["hardware"][
            "hbm_bw"] == 3.35e12
    led, jled = tdrift.DriftLedger(), jdrift.DriftLedger()
    meas = {"total_s": 2e-9, "exchange_s": 1e-10, "kernel_s": 1.9e-9,
            "compute_s": 1.9e-9, "memory_s": 1.9e-9}
    assert led.record({"c": 1}, got, meas) == jled.record({"c": 1}, want,
                                                            meas)
    assert led.report() == jled.report()


# ---------------------------------------------------------------------------
# The whole sharded driver against the single-device oracles
# ---------------------------------------------------------------------------

JAX_TYPES = {"tti": (jtt.TTIState, jtt.TTIParams, jref.tti_reference),
             "elastic": (jel.ElasticState, jel.ElasticParams,
                         jref.elastic_reference)}


def _oracles(physics, c, state, params, jg, jgr, executor=None, plan=None):
    """The reference's single-device result on the case (numpy): its
    Listing-1 oracle, or `ops._tb_propagate(executor=...)` with `plan`."""
    J = jnp.asarray
    if executor is not None:
        p = jphys.PHYSICS[physics]
        st, rec = jops._tb_propagate(
            p, c.nt, tuple(J(a) for a in state),
            dict(zip(p.param_fields, (J(a) for a in params))), jg, jgr,
            plan, c.order, c.dt, c.spacing, executor=executor)
        return tuple(np.asarray(a) for a in st), np.asarray(rec)
    if physics == "acoustic":
        (r0, r1), rec = jref.acoustic_reference(
            c.nt, J(state[0]), J(state[1]), J(params[0]), J(params[1]),
            c.dt, c.spacing, c.order, g=jg, receivers=jgr)
        return (np.asarray(r0), np.asarray(r1)), (
            None if rec is None else np.asarray(rec)[..., None])
    st_t, par_t, fn = JAX_TYPES[physics]
    rst, rec = fn(c.nt, st_t(*(J(a) for a in state)),
                  par_t(*(J(a) for a in params)), c.dt, c.spacing, c.order,
                  g=jg, receivers=jgr)
    rec = None if rec is None else np.asarray(rec)
    if rec is not None and rec.ndim == 2:
        rec = rec[..., None]
    return tuple(np.asarray(a) for a in rst), rec


def _assert_match(names, got, want, rec, rec_want, what):
    for name, a, b in list(zip(names, got, want)) + [("rec", rec, rec_want)]:
        if b is None:
            assert a is None, what
            continue
        a, b = np.asarray(a), np.asarray(b)
        assert a.shape == b.shape, (what, name)
        scale = float(np.abs(b).max())
        err = float(np.abs(a - b).max())
        assert err <= 5e-4 * scale + 1e-6, (what, name, err, scale)
        chans = [(a[..., k], b[..., k]) for k in range(b.shape[-1])] \
            if name == "rec" else [(a, b)]
        for x, y in chans:
            assert field_err(x, y) <= FIELD_RTOL, (what, name,
                                                   field_err(x, y))


# physics, mesh, T (outer), inner tile, inner T, nt, extra plan fields
SHARDED_CASES = [
    ("acoustic", (4, 2), 1, None, None, 8, {}),      # SB baseline
    ("acoustic", (4, 2), 2, None, None, 8, {}),
    ("acoustic", (2, 2), 4, None, None, 7, {}),      # remainder tile
    ("acoustic", (4, 2), 2, (4, 8), 2, 5, {}),       # inner tile < block
    ("acoustic", (4, 2), 4, (4, 8), 2, 6, {}),       # time-nested
    ("acoustic", (4, 2), 4, (4, 8), 1, 6, {}),
    ("acoustic", (4, 2), 2, (4, 8), 2, 5, {"overlap": True}),
    ("acoustic", (4, 2), 4, (4, 8), 2, 7, {"overlap": True}),
    ("acoustic", (2, 2), 2, None, None, 5, {"per_field_halo": False}),
    ("tti", (4, 2), 1, None, None, 3, {}),
    ("tti", (4, 2), 2, None, None, 5, {}),
    ("tti", (4, 2), 2, (4, 8), 1, 5, {}),           # time-nested
    ("tti", (2, 2), 2, (8, 8), 2, 3, {"overlap": True}),
    ("elastic", (4, 2), 2, None, None, 5, {}),
    ("elastic", (4, 2), 2, None, None, 4, {"per_field_halo": False}),
    ("elastic", (4, 2), 2, (4, 8), 1, 5, {}),       # time-nested
    ("elastic", (2, 2), 2, (8, 8), 2, 5, {"overlap": True}),
]


@pytest.mark.parametrize("physics,pgrid,T,tile,inner_T,nt,extra",
                         SHARDED_CASES)
def test_sharded_matches_listing1_reference(physics, pgrid, T, tile,
                                            inner_T, nt, extra):
    shape = (32, 32, 16)
    c, state, params = _case(physics, shape, nt=nt, seed=4)
    (jg, jgr), (tg, tgr) = _sparse_pair(c)
    inner_plan = (ttb.TBPlan(tile, inner_T,
                             tphys.PHYSICS[physics].step_radius(4))
                  if tile is not None else None)
    _, tp = _plans(physics, pgrid, shape, T=T, dt=c.dt,
                   inner_plan=inner_plan, **extra)
    p = tphys.PHYSICS[physics]
    mesh = tp.mesh
    st, rec = H.sharded_tb_propagate(tp, nt, state,
                                     dict(zip(p.param_fields, params)),
                                     tg, tgr)
    rst, rrec = _oracles(physics, c, state, params, jg, jgr)
    _assert_match(p.state_fields, [a.numpy() for a in st], rst,
                  rec.numpy(), rrec, f"{physics} {pgrid} T={T}")
    # one deep exchange a tile per field of nonzero depth, params once
    n_main, rem = divmod(nt, T)
    rounds = len(p.param_fields) if n_main else 0
    rounds += n_main * sum(d > 0 for d in tp.field_depths(T))
    if rem:
        rounds += sum(d > 0 for d in tp.field_depths(rem))
        rounds += 0 if n_main else len(p.param_fields)
    assert mesh.exchange_rounds == rounds


@pytest.mark.parametrize("physics,pgrid,nt", [("acoustic", (4, 2), 5),
                                              ("tti", (2, 2), 3),
                                              ("elastic", (2, 2), 3)])
def test_sharded_matches_reference_tb_jnp(physics, pgrid, nt):
    """Against the reference's single-device TB driver (executor "jnp")."""
    shape = (32, 32, 16)
    c, state, params = _case(physics, shape, nt=nt, seed=5)
    (jg, jgr), (tg, tgr) = _sparse_pair(c)
    p = tphys.PHYSICS[physics]
    _, tp = _plans(physics, pgrid, shape, T=2, dt=c.dt)
    st, rec = H.sharded_tb_propagate(tp, nt, state,
                                     dict(zip(p.param_fields, params)),
                                     tg, tgr)
    jplan = jtb.TBPlan((16, 16), 2, p.step_radius(4))
    rst, rrec = _oracles(physics, c, state, params, jg, jgr,
                         executor="jnp", plan=jplan)
    if rrec.ndim == 2:
        rrec = rrec[..., None]
    _assert_match(p.state_fields, [a.numpy() for a in st], rst,
                  rec.numpy(), rrec, f"{physics} vs reference TB jnp")


def test_sharded_over_two_devices_launches_per_device():
    """Shard k on `devices[k % 2]`: two groups ({0, 2} and {1, 3}), one
    pass call each, their partials put back in shard order — the same
    result as one device.  ("cpu" and "cpu:0" are distinct devices to
    the mesh, both the host.)"""
    from repro_torch.kernels import ops

    shape = (32, 32, 16)
    c, state, params = _case("tti", shape, nt=3, seed=8)
    _, (tg, tgr) = _sparse_pair(c)
    p = tphys.PHYSICS["tti"]
    prm = dict(zip(p.param_fields, params))
    _, one = _plans("tti", (2, 2), shape, T=2, dt=c.dt)
    two = one._replace(mesh=mesh_lib.ShardMesh((2, 2),
                                               devices=("cpu", "cpu:0")))
    assert [ks for _, ks in two.mesh.groups()] == [[0, 2], [1, 3]]
    rows = []
    orig = ops.EXECUTORS["torch"]
    try:
        ops.EXECUTORS["torch"] = lambda *a, **k: (
            rows.append(a[2][0].shape[0]) or orig(*a, **k))
        st2, rec2 = H.sharded_tb_propagate(two, 3, state, prm, tg, tgr)
    finally:
        ops.EXECUTORS["torch"] = orig
    assert rows == [2, 2, 2, 2]          # 2 passes x 2 devices, 2 rows each
    st1, rec1 = H.sharded_tb_propagate(one, 3, state, prm, tg, tgr)
    assert torch.equal(rec1, rec2)
    assert all(torch.equal(a, b) for a, b in zip(st1, st2))


def test_sharded_without_sources_or_receivers():
    shape = (32, 32, 16)
    c, state, params = _case("acoustic", shape, nt=4, seed=6)
    _, tp = _plans("acoustic", (2, 2), shape, T=2, dt=c.dt)
    st, rec = H.sharded_tb_propagate(tp, 4, state,
                                     {"m": params[0], "damp": params[1]})
    rst, _ = _oracles("acoustic", c, state, params, None, None)
    assert rec is None
    _assert_match(("u_prev", "u"), [a.numpy() for a in st], rst, None, None,
                  "no sparse")


def test_remainder_setup_runs_no_param_exchange():
    """With the main tiles' pads handed over, the remainder's setup runs
    no exchange round (tests/test_halo_remainder.py asks it of the
    reference); without the handover it runs one a param."""
    shape = (16, 16, 8)
    c, state, params = _case("acoustic", shape, nt=5)
    _, (tg, tgr) = _sparse_pair(c)
    _, tp = _plans("acoustic", (1, 1), shape, T=2, dt=c.dt)
    blocks = {"m": [[torch.as_tensor(params[0])]],
              "damp": [[torch.as_tensor(params[1])]]}
    _, _, main_pads = H._depth_setup(tp, 2, tg, tgr, blocks)
    assert main_pads[2] == tp.halo
    assert tp.mesh.exchange_rounds == 2
    rplan = tp._replace(T=1)
    H._depth_setup(rplan, 1, tg, tgr, blocks, prepped=main_pads)
    assert tp.mesh.exchange_rounds == 2
    H._depth_setup(rplan, 1, tg, tgr, blocks)
    assert tp.mesh.exchange_rounds == 4


def test_remainder_tile_is_overlapped_too(monkeypatch):
    shape = (16, 16, 8)
    c, state, params = _case("acoustic", shape, nt=5)
    _, (tg, tgr) = _sparse_pair(c)
    _, tp = _plans("acoustic", (1, 1), shape, T=2, dt=c.dt, overlap=True)
    seen = []
    orig = H._split_first_step
    monkeypatch.setattr(H, "_split_first_step",
                        lambda p, sspec, h, *a: seen.append(h)
                        or orig(p, sspec, h, *a))
    H.sharded_tb_propagate(tp, 5, state, {"m": params[0], "damp": params[1]},
                           tg, tgr)
    r = tp.r_step
    assert sorted(set(seen)) == sorted({2 * r, 1 * r})


# ---------------------------------------------------------------------------
# The kernel's plain version with a domain mask, the survey and launcher
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("physics", ["acoustic", "tti", "elastic"])
def test_plain_tile_with_grid_mask_and_row_params(physics):
    """`tb_time_tile_plain` with `dom` the grid predicate's mask and params
    given one a row equals it without them, bit for bit."""
    from repro_torch.kernels import ops

    shape = (16, 16, 8)
    c, state, params = _case(physics, shape)
    p = tphys.PHYSICS[physics]
    g, gr = port_sparse(c)
    prm = dict(zip(p.param_fields, (torch.as_tensor(a) for a in params)))
    plan = ttb.TBPlan((8, 8), 2, p.step_radius(4))
    spec, st, rt, ppads = ops.prepare_tiles(
        plan, p, torch.as_tensor(state[0]), prm, g, gr, 4, c.dt, c.spacing)
    pads, sc, sv, rc, rw = ops.tile_operands(
        spec, tuple(torch.as_tensor(a)[None] for a in state),
        g.src_dcmp[None], st, rt, 1)
    h = spec.halo
    gx = torch.arange(-h, shape[0] + h)
    gy = torch.arange(-h, shape[1] + h)
    dom = (((gx >= 0) & (gx < shape[0]))[:, None]
           & ((gy >= 0) & (gy < shape[1]))).float()[None]
    a_st, a_rec = ker.tb_time_tile_plain(spec, p, pads, ppads, sc, sv, rc, rw)
    b_st, b_rec = ker.tb_time_tile_plain(
        spec, p, pads, tuple(q[None] for q in ppads), sc, sv, rc, rw,
        dom=dom)
    assert all(torch.equal(x, y) for x, y in zip(a_st, b_st))
    assert torch.equal(a_rec, b_rec)
    cost = ker.kernel_cost(spec, p, shots=2, shard_rows=True)
    pad_plane = (shape[0] + 2 * h) * (shape[1] + 2 * h)
    assert cost["min_bytes"] == 2 * 4 * (
        pad_plane * (p.num_windows * shape[2] + 1)
        + len(p.state_fields) * shape[0] * shape[1] * shape[2])


@pytest.mark.parametrize("physics", ["acoustic", "elastic"])
def test_run_sharded_matches_run(physics):
    from repro_torch.launch import stencil_survey

    shape = (16, 16, 8)
    grid = Grid(shape=shape, spacing=(10.0,) * 3)
    dt = grid.cfl_dt(3000.0, 4)
    nt = 5
    rng = np.random.RandomState(0)
    params = stencil_survey.build_model(physics, shape, grid, rng,
                                        device="cpu")
    shots = stencil_survey.build_survey(grid, dt, nt, 2, rng)
    p = tphys.PHYSICS[physics]
    plan = ttb.TBPlan((8, 8), 2, p.step_radius(4))
    engine = SurveyEngine(physics, grid, params, nt, dt, plan=plan,
                          plan_cache=PlanCache(), bucket_cap=2, device="cpu")
    res = engine.run(shots)
    dplan = H.DistTBPlan(mesh=mesh_lib.ShardMesh((2, 2), devices=CPU),
                         grid_shape=shape, physics=p, T=2, dt=dt,
                         spacing=grid.spacing, inner="torch",
                         inner_plan=ttb.TBPlan((4, 8), 1, p.step_radius(4)))
    sres = engine.run_sharded(shots, dplan)
    assert sres.stats["route"] == "sharded" and sres.stats["shots"] == 2
    assert sres.stats["mesh"] == {"data": 2, "model": 2}
    assert (sres.stats["outer_T"], sres.stats["inner"]) == (2, "torch")
    for a, b in zip(sres.traces, res.traces):
        assert a.shape == b.shape
        for k in range(a.shape[-1] if a.ndim == 3 else 1):
            x = a[..., k] if a.ndim == 3 else a
            y = b[..., k] if b.ndim == 3 else b
            assert field_err(x, y) <= FIELD_RTOL
    with pytest.raises(ValueError, match="dist_plan is for"):
        engine.run_sharded(shots, dplan._replace(
            physics=tphys.PHYSICS["tti" if physics != "tti"
                                  else "acoustic"]))
    assert isinstance(shots[0], Shot)


@pytest.mark.parametrize("flags", [
    [],
    ["--physics", "tti", "--nt", "5", "--mesh", "2x2"],
    ["--physics", "elastic", "--nt", "5", "--uniform-halo"],
    ["--inner-tile", "4,8", "--overlap", "--T", "2", "--outer-T", "4",
     "--nt", "7"],
    ["--auto-plan", "--mesh", "2x2"],
    ["--sweep-T", "1,2,4"],
])
def test_launcher_check_passes_on_the_cpu(flags, capsys):
    rc = stencil_dist.main(["--device", "cpu", "--mesh", "4x2", "--check",
                            "--n", "32", "--nt", "8", "--T", "2", *flags])
    out = capsys.readouterr().out
    assert rc == 0, out
    assert ("SWEEP PASS" if "--sweep-T" in flags else "CHECK PASS") in out


def test_launcher_needs_a_card_by_default():
    if torch.cuda.is_available():
        pytest.skip("a card is present")
    with pytest.raises(RuntimeError, match="cuda"):
        stencil_dist.main(["--n", "16", "--nt", "2"])


def test_launcher_telemetry_writes_drift_report(tmp_path, capsys):
    path = tmp_path / "trace.json"
    rc = stencil_dist.main(["--device", "cpu", "--mesh", "2x2", "--n", "16",
                            "--nt", "2", "--telemetry", str(path)])
    assert rc == 0
    rep = tdrift.last_drift(str(tmp_path / "trace_drift.json"))
    assert rep is not None and rep["n_records"] == 1
    assert path.is_file()
    from repro_torch import telemetry as tele
    tele.disable()
    assert "drift ratio" in capsys.readouterr().out

