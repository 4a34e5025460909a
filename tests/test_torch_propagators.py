"""The port's Listing-1 acoustic propagator against the reference's
`repro.kernels.ref.acoustic_reference` (tolerance of the reference kernel
tests: rtol 2e-4, atol 1e-6)."""
import numpy as np
import jax.numpy as jnp
import pytest
import torch

from repro.core import sources as JS
from repro.core.grid import Grid as JGrid
from repro.core.propagators import acoustic as JA
from repro.kernels import ref as jref
from repro_torch.core.propagators import acoustic as TA
from repro_torch.kernels import ref as tref
from test_torch_case import acoustic_case, port_sparse

RTOL, ATOL = 2e-4, 1e-6


def jax_sparse(c):
    grid = JGrid(shape=c.shape, spacing=c.spacing)
    return (JS.precompute(JS.SparseOperator(c.src), grid, c.wav),
            JS.precompute_receivers(JS.SparseOperator(c.rec), grid))


def _close(a, b):
    np.testing.assert_allclose(np.asarray(a), np.asarray(b), rtol=RTOL,
                               atol=ATOL)


@pytest.mark.parametrize("order,sources", [(2, True), (4, True), (8, True),
                                           (4, False)])
def test_listing1_matches_reference(order, sources):
    c = acoustic_case(shape=(14, 12, 10), order=order, nt=6)
    g, gr = jax_sparse(c) if sources else (None, None)
    tg, tgr = port_sparse(c) if sources else (None, None)
    (ja0, ja1), jrec = jref.acoustic_reference(
        c.nt, jnp.asarray(c.u0), jnp.asarray(c.u1), jnp.asarray(c.m),
        jnp.asarray(c.damp), c.dt, c.spacing, order, g=g, receivers=gr)
    (ta0, ta1), trec = tref.acoustic_reference(
        c.nt, c.u0, c.u1, c.m, c.damp, c.dt, c.spacing, order, g=tg,
        receivers=tgr, device="cpu")
    _close(ta0, ja0)
    _close(ta1, ja1)
    if sources:
        assert trec.shape == (c.nt, c.rec.shape[0])
        _close(trec, jrec)
    else:
        assert trec is None and jrec is None


def test_single_step_matches():
    c = acoustic_case(shape=(10, 9, 8), order=4, nt=2)
    g, _ = jax_sparse(c)
    tg, _ = port_sparse(c)
    js = JA.step(JA.AcousticState(jnp.asarray(c.u1), jnp.asarray(c.u0)), 1,
                 JA.AcousticParams(jnp.asarray(c.m), jnp.asarray(c.damp)), g,
                 c.dt, c.spacing, 4)
    ts = TA.step(TA.AcousticState(torch.from_numpy(c.u1),
                                  torch.from_numpy(c.u0)), 1,
                 TA.AcousticParams(torch.from_numpy(c.m),
                                   torch.from_numpy(c.damp)), tg,
                 c.dt, c.spacing, 4)
    _close(ts.u, js.u)
    np.testing.assert_array_equal(ts.u_prev.numpy(), np.asarray(js.u_prev))


def test_injection_scale_is_true_division():
    m = torch.tensor([3.0, 7.0, 1.1e-7], dtype=torch.float32)
    got = TA.divide_scalar(0.1, m)
    want = np.float32(0.1) / m.numpy()
    np.testing.assert_array_equal(got.numpy(), want)
