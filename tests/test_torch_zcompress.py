"""The paper's Listing-5 z-compression (§II.A.5, Fig. 6) in the port
against the JAX package (`repro.core.sources`: `z_compress`,
`dense_increment`, `inject_zcompressed`) and against the port's scatter
injection, and a whole acoustic run with the z-compressed injection as
its `inject_fn` against the scatter run.  Tolerances: the reference
tests' (`tests/test_sources.py::TestZCompression`, atol 1e-6;
`tests/test_propagators.py::test_zcompressed_injection_equivalent_run`,
atol 1e-6).
"""
import numpy as np
import jax.numpy as jnp
import pytest
import torch

from repro.core import sources as JS
from repro.core.grid import Grid as JGrid
from repro.core.propagators import acoustic as jac
from repro_torch.core import boundary as tbd, sources as TS
from repro_torch.core.grid import Grid as TGrid
from repro_torch.core.propagators import acoustic as tac

SHAPE = (12, 10, 14)            # tests/test_sources.py's grid
JGRID = JGrid(shape=SHAPE, spacing=(10.0, 10.0, 10.0))
TGRID = TGrid(shape=SHAPE, spacing=(10.0, 10.0, 10.0))


def _coords(n, seed):
    """tests/test_sources.py's `_rand_sources` draw."""
    rng = np.random.RandomState(seed)
    hi = np.asarray(JGRID.extent)
    return 5.0 + rng.rand(n, 3) * (hi - 10.0)


def _both(n, seed, wav):
    src = _coords(n, seed)
    return (JS.precompute(JS.SparseOperator(src), JGRID, wav),
            TS.precompute(TS.SparseOperator(src), TGRID, wav, device="cpu"))


@pytest.mark.parametrize("n,seed", [(5, 5), (1, 0), (9, 11)])
def test_z_compress_equals_reference(n, seed):
    jg, tg = _both(n, seed, JS.ricker_wavelet(4, 0.001, 10.0, n))
    jz, tz = JS.z_compress(jg), TS.z_compress(tg)
    np.testing.assert_array_equal(tz.nnz_mask.numpy(), tg.sm.sum(axis=2))
    for a, b in zip(tz, jz):
        assert a.dtype == torch.int32
        np.testing.assert_array_equal(a.numpy(), np.asarray(b))
    assert tz.max_nnz == jz.max_nnz
    assert tz.nnz_mask.device == tg.src_dcmp.device


def test_z_compress_refuses_2d():
    g = TS.precompute(TS.SparseOperator(np.array([[15.3, 22.1]])),
                      TGrid(shape=(6, 5), spacing=(10.0, 10.0)),
                      np.ones((2, 1)), device="cpu")
    with pytest.raises(ValueError, match="3-D"):
        TS.z_compress(g)


@pytest.mark.parametrize("scaled", [False, True])
def test_injection_forms_equal_reference_and_scatter(scaled):
    """Listing-5 (z-compressed) == Listing-4 (dense) == scatter, each
    against the reference's."""
    wav = np.random.RandomState(3).randn(4, 5)
    jg, tg = _both(5, 6, wav)
    jz, tz = JS.z_compress(jg), TS.z_compress(tg)
    scale = (np.random.RandomState(7).rand(tg.npts) + 0.5).astype(np.float32)
    jscale = jnp.asarray(scale) if scaled else None
    tscale = torch.as_tensor(scale) if scaled else None
    for t in range(4):
        t_ = jnp.asarray(t)
        scatter = TS.inject(torch.zeros(SHAPE), tg, t, scale=tscale)
        dense = TS.dense_increment(tg, t, SHAPE)
        zc = TS.inject_zcompressed(torch.zeros(SHAPE), tg, tz, t,
                                   scale=tscale)
        np.testing.assert_allclose(zc.numpy(), scatter.numpy(), atol=1e-6)
        np.testing.assert_allclose(
            zc.numpy(), np.asarray(JS.inject_zcompressed(
                jnp.zeros(SHAPE), jg, jz, t_, scale=jscale)), atol=1e-6)
        np.testing.assert_allclose(
            dense.numpy(), np.asarray(JS.dense_increment(jg, t_, SHAPE)),
            atol=1e-6)
        if not scaled:
            np.testing.assert_allclose(dense.numpy(), scatter.numpy(),
                                       atol=1e-6)
        assert dense.dtype == torch.float32


def test_zcompressed_run_equals_scatter_run_and_reference():
    """A full acoustic run with `inject_fn` = the z-compressed injection
    equals the scatter run (tests/test_propagators.py:70-80), and the
    reference's z-compressed run."""
    shape, spacing, nt = (24, 20, 22), (10.0, 10.0, 10.0), 12
    vp = np.full(shape, 1500.0)
    vp[12:] = 2500.0
    m = (1.0 / vp ** 2).astype(np.float32)
    jgrid, tgrid = JGrid(shape, spacing), TGrid(shape, spacing)
    dt = jgrid.cfl_dt(2500.0, 4)
    src = np.array([[105.0, 95.0, 55.0]])
    wav = JS.ricker_wavelet(nt, dt, f0=15.0)
    tg = TS.precompute(TS.SparseOperator(src), tgrid, wav, device="cpu")
    tparams = tac.AcousticParams(
        m=torch.as_tensor(m),
        damp=tbd.damping_field(shape, nbl=4, spacing=spacing, device="cpu"))
    tz = TS.z_compress(tg)
    scale = tac.injection_scale(tparams.m, tg, dt)

    def inj_zc(u, t):
        return TS.inject_zcompressed(u, tg, tz, t, scale=scale)

    state = tac.init_state(shape, device="cpu")
    f_ref, _ = tac.propagate(nt, state, tparams, tg, dt, tgrid, 4)
    f_zc, _ = tac.propagate(nt, state, tparams, tg, dt, tgrid, 4,
                            inject_fn=inj_zc)
    np.testing.assert_allclose(f_ref.u.numpy(), f_zc.u.numpy(), atol=1e-6)
    assert float(f_zc.u.abs().max()) > 0

    jg = JS.precompute(JS.SparseOperator(src), jgrid, wav)
    jparams = jac.AcousticParams(m=jnp.asarray(m),
                                 damp=jnp.asarray(tparams.damp.numpy()))
    jz = JS.z_compress(jg)
    jscale = (dt * dt) / JS.point_scale(jparams.m, jg)
    jf, _ = jac.propagate(nt, jac.init_state(shape), jparams, jg, dt, jgrid,
                          4, inject_fn=lambda u, t: JS.inject_zcompressed(
                              u, jg, jz, t, scale=jscale))
    np.testing.assert_allclose(f_zc.u.numpy(), np.asarray(jf.u), rtol=2e-4,
                               atol=1e-6)
