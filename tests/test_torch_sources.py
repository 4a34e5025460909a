"""The port's off-grid precompute (paper §II) against `repro.core`.

Everything host-side is the same numpy computation, so interpolation
coefficients, SM/SID/points/src_dcmp, receiver stencils and both per-tile
tables must be EQUAL to the reference's, for linear and sinc kernels, the
raise/clip edge policies and the cap-overflow message.  Injection and
interpolation on tensors are compared with the float32 tolerance of the
reference tests (rtol 2e-4, atol 1e-6).
"""
import numpy as np
import jax.numpy as jnp
import pytest
import torch

from repro.core import interp as JI, sources as JS, tables as JT
from repro.core.grid import Grid as JGrid
from repro_torch.core import interp as TI, sources as TS, tables as TT
from repro_torch.core.grid import Grid as TGrid

SHAPE = (12, 10, 14)
JGRID = JGrid(shape=SHAPE, spacing=(10.0, 10.0, 10.0))
TGRID = TGrid(shape=SHAPE, spacing=(10.0, 10.0, 10.0))
SPECS = [("linear", 1, "raise"), ("sinc", 2, "raise"), ("sinc", 4, "clip"),
         ("linear", 1, "clip")]


def _coords(n, seed=0, pad=5.0):
    rng = np.random.RandomState(seed)
    hi = np.asarray(JGRID.extent)
    return pad + rng.rand(n, 3) * (hi - 2 * pad)


def _specs(kernel, radius, edge):
    return (JI.InterpSpec(kernel, radius, edge),
            TI.InterpSpec(kernel, radius, edge))


def _eq(a, b):
    np.testing.assert_array_equal(TS.to_numpy(a), np.asarray(b))


@pytest.mark.parametrize("kernel,radius,edge", SPECS)
def test_interp_coeffs_equal(kernel, radius, edge):
    js, ts = _specs(kernel, radius, edge)
    pts = np.concatenate([_coords(6, seed=1),
                          [[0.0, 0.0, 0.0], [110.0, 90.0, 130.0]]])
    if edge == "clip":
        pts = np.concatenate([pts, [[-3.0, 50.0, 50.0], [112.0, 95.0, 1.0]]])
    a = JI.precompute_coeffs(pts, JGRID, js)
    b = TI.precompute_coeffs(pts, TGRID, ts)
    _eq(b.base, a.base)
    _eq(b.coeffs, a.coeffs)
    for x, y in zip(b.expand(), a.expand()):
        _eq(x, y)
    assert b.to_dict() == a.to_dict()
    assert TI.InterpCoeffs.from_dict(b.to_dict()).spec == ts


def test_out_of_domain_raises_same_message():
    pts = np.array([[50.0, 50.0, 50.0], [-3.0, 50.0, 50.0]])
    with pytest.raises(ValueError) as ej:
        JI.precompute_coeffs(pts, JGRID, JI.LINEAR)
    with pytest.raises(ValueError) as et:
        TI.precompute_coeffs(pts, TGRID, TI.LINEAR)
    assert str(et.value) == str(ej.value)
    with pytest.raises(ValueError):
        TS.precompute(TS.SparseOperator(pts), TGRID, np.ones((3, 2)),
                      device="cpu")


def test_spec_validation_matches():
    for kw in (dict(kernel="cubic"), dict(edge="wrap"),
               dict(kernel="linear", radius=2), dict(kernel="sinc", radius=9)):
        with pytest.raises(ValueError) as ej:
            JI.InterpSpec(**kw)
        with pytest.raises(ValueError) as et:
            TI.InterpSpec(**kw)
        assert str(et.value) == str(ej.value)
    assert TI.spec_for("sinc") == TI.InterpSpec("sinc", 4)


@pytest.mark.parametrize("by_injection", [False, True])
@pytest.mark.parametrize("kernel,radius,edge", SPECS[:3])
def test_precompute_equal(by_injection, kernel, radius, edge):
    js, ts = _specs(kernel, radius, edge)
    pts = _coords(5, seed=2)
    pts[1] = pts[0] + 0.3          # colliding footprints accumulate
    wav = JS.ricker_wavelet(9, 1e-3, 10.0, num=5) \
        + 0.05 * np.random.RandomState(0).randn(9, 5)
    a = JS.precompute(JS.SparseOperator(pts), JGRID, wav,
                      discover_by_injection=by_injection, interp=js)
    b = TS.precompute(TS.SparseOperator(pts), TGRID, wav,
                      discover_by_injection=by_injection, interp=ts,
                      device="cpu")
    _eq(b.sm, a.sm)
    _eq(b.sid, a.sid)
    _eq(b.points, a.points)
    _eq(b.src_dcmp, a.src_dcmp)
    assert b.points.dtype == torch.int32 and b.src_dcmp.dtype == torch.float32
    assert (b.npts, b.nt) == (a.npts, a.nt)


@pytest.mark.parametrize("kernel,radius,edge", SPECS[:3])
def test_receivers_equal_and_interpolate(kernel, radius, edge):
    js, ts = _specs(kernel, radius, edge)
    pts = _coords(4, seed=3)
    a = JS.precompute_receivers(JS.SparseOperator(pts), JGRID, interp=js)
    b = TS.precompute_receivers(TS.SparseOperator(pts), TGRID, interp=ts,
                                device="cpu")
    _eq(b.indices, a.indices)
    _eq(b.weights, a.weights)
    u = np.random.RandomState(4).randn(*SHAPE).astype(np.float32)
    np.testing.assert_allclose(
        TS.interpolate(torch.from_numpy(u), b).numpy(),
        np.asarray(JS.interpolate(jnp.asarray(u), a)), rtol=2e-4, atol=1e-6)


def test_inject_and_point_scale_match():
    pts = _coords(3, seed=5)
    wav = JS.ricker_wavelet(6, 1e-3, 12.0, num=3)
    a = JS.precompute(JS.SparseOperator(pts), JGRID, wav)
    b = TS.precompute(TS.SparseOperator(pts), TGRID, wav, device="cpu")
    u = np.random.RandomState(6).randn(*SHAPE).astype(np.float32)
    m = (1.0 + np.random.RandomState(7).rand(*SHAPE)).astype(np.float32)
    sa = JS.point_scale(jnp.asarray(m), a)
    sb = TS.point_scale(torch.from_numpy(m), b)
    _eq(sb, sa)
    for t in (0, 3, 5):
        ref = np.asarray(JS.inject(jnp.asarray(u), a, t, scale=sa))
        out = TS.inject(torch.from_numpy(u.copy()), b, t, scale=sb).numpy()
        np.testing.assert_allclose(out, ref, rtol=2e-4, atol=1e-6)


@pytest.mark.parametrize("tile,halo,include_halo", [
    ((4, 5), 0, False), ((4, 5), 2, False), ((4, 5), 2, True),
    ((6, 10), 4, True), ((12, 10), 3, True)])
@pytest.mark.parametrize("kernel,radius,edge", SPECS[:2])
def test_tile_tables_equal(tile, halo, include_halo, kernel, radius, edge):
    js, ts = _specs(kernel, radius, edge)
    pts = np.concatenate([_coords(4, seed=8), [[40.0, 50.0, 70.0]]])
    wav = JS.ricker_wavelet(4, 1e-3, 10.0, num=pts.shape[0])
    a = JS.precompute(JS.SparseOperator(pts), JGRID, wav, interp=js)
    b = TS.precompute(TS.SparseOperator(pts), TGRID, wav, interp=ts,
                      device="cpu")
    scale = np.linspace(0.5, 2.0, a.npts).astype(np.float32)
    ta = JS.tile_source_tables(a, SHAPE, tile, halo, scale=scale,
                               include_halo=include_halo)
    tb = TS.tile_source_tables(b, SHAPE, tile, halo, scale=scale,
                               include_halo=include_halo)
    for x, y in zip(tb, ta):
        _eq(x, y)
    assert tb.cap == ta.cap
    ra = JS.precompute_receivers(JS.SparseOperator(pts), JGRID, interp=js)
    rb = TS.precompute_receivers(TS.SparseOperator(pts), TGRID, interp=ts,
                                 device="cpu")
    for x, y in zip(TS.tile_receiver_tables(rb, SHAPE, tile, halo),
                    JS.tile_receiver_tables(ra, SHAPE, tile, halo)):
        _eq(x, y)


def test_tile_table_overflow_message_equal():
    pts = _coords(3, seed=9)
    wav = JS.ricker_wavelet(4, 1e-3, 10.0, num=3)
    a = JS.precompute(JS.SparseOperator(pts), JGRID, wav)
    b = TS.precompute(TS.SparseOperator(pts), TGRID, wav, device="cpu")
    with pytest.raises(ValueError) as ej:
        JS.tile_source_tables(a, SHAPE, (6, 5), 2, cap=2, include_halo=True)
    with pytest.raises(ValueError) as et:
        TS.tile_source_tables(b, SHAPE, (6, 5), 2, cap=2, include_halo=True)
    assert str(et.value) == str(ej.value)
    ra = JS.precompute_receivers(JS.SparseOperator(pts), JGRID)
    rb = TS.precompute_receivers(TS.SparseOperator(pts), TGRID, device="cpu")
    with pytest.raises(ValueError) as ej:
        JS.tile_receiver_tables(ra, SHAPE, (6, 5), 2, cap=1)
    with pytest.raises(ValueError) as et:
        TS.tile_receiver_tables(rb, SHAPE, (6, 5), 2, cap=1)
    assert str(et.value) == str(ej.value)
    assert TT.overflow_message("x", 3, 1, 4) == JT.overflow_message("x", 3, 1, 4)


def test_binning_core_equal():
    for v, lo0, pitch, span, n in [(5, -2, 4, 8, 4), (0, 0, 3, 3, 2),
                                   (13, -3, 4, 10, 4)]:
        assert TT.axis_tile_range(v, lo0, pitch, n, span) == \
            JT.axis_tile_range(v, lo0, pitch, n, span)
    wa = JT.WindowGrid(origin=(-2, -2), tile=(4, 5), ntiles=(3, 2), pad=2)
    wb = TT.WindowGrid(origin=(-2, -2), tile=(4, 5), ntiles=(3, 2), pad=2)
    xy = np.array([[0, 0], [4, 5], [11, 9], [3, 4]])
    for mode in ("window", "centre"):
        pa, pb = JT.bin_points(xy, wa, mode), TT.bin_points(xy, wb, mode)
        assert pa == pb
        for x, y in zip(TT.pack_slots(pb, wb.n_tiles, None, "t"),
                        JT.pack_slots(pa, wa.n_tiles, None, "t")):
            np.testing.assert_array_equal(x, y)


def test_ricker_equal():
    np.testing.assert_array_equal(TS.ricker_wavelet(50, 1.3e-3, 10.0, num=2),
                                  JS.ricker_wavelet(50, 1.3e-3, 10.0, num=2))
