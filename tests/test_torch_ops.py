"""The port's temporally-blocked driver against the reference package.

`repro_torch.kernels.ops.acoustic_tb_propagate(device="cpu")` is held
against `repro.kernels.ref.acoustic_reference` over the matrix of
`tests/test_kernel_stencil_tb.py` (T in {1,2,3,4}, tiles, orders 2/4/8,
shapes, remainder tile, no sources, SB == T=1, bf16 tracking f32), and
against the reference's own TB driver (`executor="jnp"`, and the Pallas
kernel in interpret mode for one short case).  Tolerances are that file's:
rtol 2e-4, atol 1e-6; 5e-4 for the random property cases.
"""
import functools

import numpy as np
import jax.numpy as jnp
import pytest
import torch

from repro.core import sources as JS
from repro.core.grid import Grid as JGrid
from repro.core.temporal_blocking import TBPlan as JPlan
from repro.kernels import ops as jops, ref as jref
from repro_torch import interop
from repro_torch.core.temporal_blocking import TBPlan
from repro_torch.kernels import ops, ref as tref, tb_physics as tphys
from test_torch_case import acoustic_case, port_sparse

RTOL, ATOL = 2e-4, 1e-6


def _close(a, b, rtol=RTOL):
    np.testing.assert_allclose(np.asarray(a), np.asarray(b), rtol=rtol,
                               atol=ATOL)


def _jax_sparse(c):
    grid = JGrid(shape=c.shape, spacing=c.spacing)
    return (JS.precompute(JS.SparseOperator(c.src), grid, c.wav),
            JS.precompute_receivers(JS.SparseOperator(c.rec), grid))


def _jax_fields(c):
    return tuple(jnp.asarray(a) for a in (c.u0, c.u1, c.m, c.damp))


@functools.lru_cache(maxsize=None)
def _case_and_reference(shape=(16, 16, 12), order=4, nt=8, nsrc=2, nrec=3,
                        seed=0, sources=True):
    """A case and the reference's Listing-1 result on it (numpy)."""
    c = acoustic_case(shape=shape, order=order, nt=nt, nsrc=nsrc, nrec=nrec,
                      seed=seed)
    g, gr = _jax_sparse(c) if sources else (None, None)
    (r0, r1), rrec = jref.acoustic_reference(
        nt, *_jax_fields(c), c.dt, c.spacing, order, g=g, receivers=gr)
    return c, (np.asarray(r0), np.asarray(r1),
               None if rrec is None else np.asarray(rrec))


def _port_tb(c, T, tile, sources=True, **kw):
    g, gr = port_sparse(c) if sources else (None, None)
    plan = TBPlan(tile=tile, T=T, radius=c.order // 2)
    (u0, u1), rec = ops.acoustic_tb_propagate(
        c.nt, c.u0, c.u1, c.m, c.damp, g, gr, plan, c.order, c.dt,
        c.spacing, device="cpu", **kw)
    return u0.numpy(), u1.numpy(), None if rec is None else rec.numpy()


@pytest.mark.parametrize("T,tile", [
    (1, (8, 8)),     # spatially-blocked baseline
    (2, (8, 8)),
    (4, (8, 8)),
    (2, (4, 8)),     # asymmetric tiles
    (4, (16, 16)),   # single tile in x/y
    (3, (8, 8)),     # nt % T != 0 -> remainder tile
])
def test_tb_matches_reference(T, tile):
    c, (r0, r1, rrec) = _case_and_reference()
    u0, u1, rec = _port_tb(c, T, tile)
    _close(u1, r1)
    _close(u0, r0)
    _close(rec, rrec)


@pytest.mark.parametrize("T,tile", [(2, (8, 8)), (3, (8, 8))])
def test_tb_matches_reference_tb_driver(T, tile):
    """Against the reference's own TB schedule (`executor="jnp"`)."""
    c, _ = _case_and_reference()
    g, gr = _jax_sparse(c)
    (j0, j1), jrec = jops.acoustic_tb_propagate(
        c.nt, *_jax_fields(c), g, gr, JPlan(tile=tile, T=T, radius=2), 4,
        c.dt, c.spacing, executor="jnp")
    u0, u1, rec = _port_tb(c, T, tile)
    _close(u1, j1)
    _close(u0, j0)
    _close(rec, jrec)


def test_tb_matches_pallas_interpret():
    c = acoustic_case(nt=3, nsrc=1, nrec=2)
    g, gr = _jax_sparse(c)
    (j0, j1), jrec = jops.acoustic_tb_propagate(
        c.nt, *_jax_fields(c), g, gr, JPlan(tile=(8, 8), T=2, radius=2), 4,
        c.dt, c.spacing, interpret=True)
    u0, u1, rec = _port_tb(c, 2, (8, 8))
    _close(u1, j1)
    _close(u0, j0)
    _close(rec, jrec)


@pytest.mark.parametrize("order", [2, 4, 8])
def test_space_order_sweep(order):
    c, (r0, r1, rrec) = _case_and_reference(shape=(16, 16, 10), order=order,
                                            nt=6)
    u0, u1, rec = _port_tb(c, 2, (8, 8))
    _close(u1, r1)
    _close(rec, rrec)


@pytest.mark.parametrize("shape", [(8, 8, 8), (16, 8, 12), (24, 16, 10)])
def test_shape_sweep(shape):
    c, (r0, r1, _) = _case_and_reference(shape=shape, nt=4)
    u0, u1, _ = _port_tb(c, 2, (8, 8))
    _close(u1, r1)
    _close(u0, r0)


def test_no_sources_no_receivers():
    c, (r0, r1, rrec) = _case_and_reference(nt=4, sources=False)
    u0, u1, rec = _port_tb(c, 2, (8, 8), sources=False)
    assert rec is None and rrec is None
    _close(u1, r1)


def test_bf16_runs_and_tracks_f32():
    """bf16 stays finite and loosely tracks the f32 field (the reference
    test's bound: bf16 keeps ~3 decimal digits)."""
    c = acoustic_case(nt=4)
    g, gr = port_sparse(c)
    plan = TBPlan(tile=(8, 8), T=2, radius=2)
    (_, f1), _ = ops.acoustic_tb_propagate(
        c.nt, c.u0, c.u1, c.m, c.damp, g, gr, plan, 4, c.dt, c.spacing,
        device="cpu")
    bf = [torch.from_numpy(a).to(torch.bfloat16)
          for a in (c.u0, c.u1, c.m, c.damp)]
    (_, b1), _ = ops.acoustic_tb_propagate(
        c.nt, *bf, g, gr, plan, 4, c.dt, c.spacing, device="cpu")
    assert b1.dtype == torch.bfloat16
    b = b1.float().numpy()
    f = f1.numpy()
    assert np.all(np.isfinite(b))
    assert np.abs(b - f).max() <= 0.1 * max(np.abs(f).max(), 1e-3) + 1e-2


# C2: the port's bf16 tile computes in float32 and rounds once a store; the
# reference's bf16 tile (`executor="jnp"`) computes op by op in bf16.  The
# gap between the two, as max|diff| / max|f32|, measured on this case
# (0.0018 / 0.107 / 0.039 at nt 4 / 16 / 40), is held under the next power
# of two above it.
@pytest.mark.parametrize("nt,bound", [(4, 2 ** -8), (16, 2 ** -3),
                                      (40, 2 ** -4)])
def test_bf16_gap_to_reference_bf16(nt, bound):
    c = acoustic_case(shape=(16, 16, 12), nt=nt)
    g, gr = port_sparse(c)
    plan = TBPlan(tile=(8, 8), T=2, radius=2)
    (_, f1), _ = ops.acoustic_tb_propagate(
        nt, c.u0, c.u1, c.m, c.damp, g, gr, plan, 4, c.dt, c.spacing,
        device="cpu")
    bf = [torch.from_numpy(a).to(torch.bfloat16)
          for a in (c.u0, c.u1, c.m, c.damp)]
    (_, b1), _ = ops.acoustic_tb_propagate(
        nt, *bf, g, gr, plan, 4, c.dt, c.spacing, device="cpu")
    jg, jgr = _jax_sparse(c)
    (_, j1), _ = jops.acoustic_tb_propagate(
        nt, *(a.astype(jnp.bfloat16) for a in _jax_fields(c)), jg, jgr,
        JPlan(tile=(8, 8), T=2, radius=2), 4, c.dt, c.spacing,
        executor="jnp")
    f = f1.numpy()
    port = b1.float().numpy()
    jref_bf16 = np.asarray(j1.astype(jnp.float32))
    scale = np.abs(f).max()
    assert np.all(np.isfinite(port))
    assert np.abs(port - jref_bf16).max() / scale <= bound
    # the port is no farther from float32 than the reference's bf16 tile
    assert np.abs(port - f).max() <= np.abs(jref_bf16 - f).max()


def test_sb_baseline_is_t1():
    c = acoustic_case(nt=4)
    g, gr = port_sparse(c)
    (s0, s1), srec = ops.acoustic_sb_propagate(
        c.nt, c.u0, c.u1, c.m, c.damp, g, gr, (8, 8), 4, c.dt, c.spacing,
        device="cpu")
    u0, u1, rec = _port_tb(c, 1, (8, 8))
    np.testing.assert_array_equal(s1.numpy(), u1)
    np.testing.assert_array_equal(srec.numpy(), rec)


@pytest.mark.parametrize("seed,T,nsrc", [(11, 1, 1), (2024, 2, 3),
                                         (65535, 4, 2)])
def test_property_tb_equals_reference(seed, T, nsrc):
    """Random models, sources and receivers (the reference property test's
    draws and tolerance)."""
    c, (r0, r1, rrec) = _case_and_reference(shape=(16, 8, 8), nt=4,
                                            nsrc=nsrc, seed=seed)
    u0, u1, rec = _port_tb(c, T, (8, 8))
    _close(u1, r1, rtol=5e-4)
    _close(rec, rrec, rtol=5e-4)


def test_port_reference_equals_tb():
    """The port's own Listing-1 oracle agrees with its TB driver."""
    c = acoustic_case(nt=5)
    g, gr = port_sparse(c)
    (r0, r1), rrec = tref.acoustic_reference(
        c.nt, c.u0, c.u1, c.m, c.damp, c.dt, c.spacing, 4, g=g,
        receivers=gr, device="cpu")
    u0, u1, rec = _port_tb(c, 2, (8, 8))
    _close(u1, r1.numpy())
    _close(rec, rrec.numpy())


def test_interop_precompute_feeds_the_port():
    """The reference's precompute, carried across by `interop`, gives the
    port the same run as its own precompute."""
    c = acoustic_case(nt=5)
    g, gr = _jax_sparse(c)
    tg = interop.gridded_sources_from_numpy(g.sm, g.sid, g.points,
                                            g.src_dcmp, device="cpu")
    tgr = interop.gridded_receivers_from_numpy(gr.indices, gr.weights,
                                               device="cpu")
    model = interop.acoustic_model_from_numpy(c.m, c.damp, device="cpu")
    plan = TBPlan(tile=(8, 8), T=2, radius=2)
    (_, a1), arec = ops.acoustic_tb_propagate(
        c.nt, c.u0, c.u1, model.m, model.damp, tg, tgr, plan, 4, c.dt,
        c.spacing, device="cpu")
    _, b1, brec = _port_tb(c, 2, (8, 8))
    np.testing.assert_array_equal(a1.numpy(), b1)
    np.testing.assert_array_equal(arec.numpy(), brec)


def test_prepared_core_on_reference_tables():
    """`tb_propagate_prepared` driven by the reference's own tables (main
    and remainder), carried across by `interop`."""
    c, (r0, r1, rrec) = _case_and_reference()
    g, gr = _jax_sparse(c)
    nt, T = c.nt, 3
    params = {"m": jnp.asarray(c.m), "damp": jnp.asarray(c.damp)}
    jspec = jops.make_spec(c.shape, JPlan((8, 8), T, 2), 4, c.dt, c.spacing,
                           1, 1)
    st, rt = jops.build_tables(jspec, g, gr, params)
    jrspec = jops.make_spec(c.shape, JPlan((8, 8), nt % T, 2), 4, c.dt,
                            c.spacing, 1, 1)
    rst, rrt = jops.build_tables(jrspec, g, gr, params)
    # one shot: a shot axis of 1 on the tables, the state and src_dcmp
    tst, trt, trst, trrt = (ops.stack_tables([t]) for t in
                            interop.tile_tables_from_numpy(st, rt, "cpu")
                            + interop.tile_tables_from_numpy(rst, rrt,
                                                             "cpu"))
    caps = (tst.cap, trt.coords.shape[2])
    spec = ops.make_spec(c.shape, TBPlan((8, 8), T, 2), 4, c.dt, c.spacing,
                         *caps)
    rspec = ops.make_spec(c.shape, TBPlan((8, 8), nt % T, 2), 4, c.dt,
                          c.spacing, *caps)
    m, damp = torch.from_numpy(c.m), torch.from_numpy(c.damp)
    pads = tuple(ops.pad_xy(p, spec.halo, "edge") for p in (m, damp))
    rpads = tuple(ops.pad_xy(p, rspec.halo, "edge") for p in (m, damp))
    (u0, u1), rec = ops.tb_propagate_prepared(
        tphys.ACOUSTIC, nt, spec, rspec,
        (torch.from_numpy(c.u0)[None], torch.from_numpy(c.u1)[None]), pads,
        rpads, torch.from_numpy(np.array(g.src_dcmp))[None], tst, trt, trst,
        trrt, gr.indices.shape[0], executor="torch")
    _close(u1[0].numpy(), r1)
    _close(rec[0, ..., 0].numpy(), rrec)


def test_executors_agree_and_validate():
    c = acoustic_case(nt=3)
    a = _port_tb(c, 2, (8, 8), executor="cuda")   # CPU tensors: plain path
    b = _port_tb(c, 2, (8, 8), executor="torch")
    for x, y in zip(a, b):
        np.testing.assert_array_equal(x, y)
    with pytest.raises(ValueError, match="executor"):
        _port_tb(c, 2, (8, 8), executor="pallas")
    e = np.zeros((8, 8, 4), np.float32)
    edge = ops.pad_xy(torch.arange(4.0).reshape(2, 2, 1), 1, "edge")
    np.testing.assert_array_equal(
        edge[..., 0].numpy(),
        np.pad(np.arange(4.0).reshape(2, 2), 1, mode="edge"))
    assert ops.pad_xy(torch.from_numpy(e), 2, "constant").shape == \
        (12, 12, 4)
    with pytest.raises(ValueError):
        ops.pad_xy(torch.from_numpy(e), 1, "reflect")


@pytest.mark.parametrize("tile,T,r", [((32, 32), 4, 2), ((8, 16), 3, 4),
                                      ((16, 16), 1, 1)])
def test_plan_matches_reference(tile, T, r):
    a, b = JPlan(tile, T, r), TBPlan(tile, T, r)
    assert (b.halo, b.window(64), b.overlap_factor(),
            b.hbm_bytes_per_point_step(64, 4, 2)) == \
        (a.halo, a.window(64), a.overlap_factor(),
         a.hbm_bytes_per_point_step(64, 4, 2))
    assert b.to_dict() == a.to_dict()
    assert TBPlan.from_dict(a.to_dict()) == b
