"""The port's Listing-1 propagators against the reference's: acoustic
against `repro.kernels.ref.acoustic_reference` (tolerance of the reference
kernel tests: rtol 2e-4, atol 1e-6), TTI and elastic against
`repro.core.propagators.{tti,elastic}` (tolerance of
tests/test_kernel_multiphysics.py: rtol 2e-4, atol 1e-5, and each field and
receiver channel within `FIELD_RTOL` of its own scale, on elastic inputs in
SI units, where every term of the update is visible)."""
import numpy as np
import jax.numpy as jnp
import pytest
import torch

from repro.core import sources as JS
from repro.core.grid import Grid as JGrid
from repro.core.propagators import acoustic as JA
from repro.core.propagators import elastic as JE, tti as JT
from repro.kernels import ref as jref
from repro_torch.core.grid import Grid as TGrid
from repro_torch.core.propagators import acoustic as TA
from repro_torch.core.propagators import elastic as TE, tti as TT
from repro_torch.kernels import ref as tref
from test_torch_case import FIELD_RTOL, MULTI_CASES, acoustic_case, \
    assert_fields_close, port_sparse, trace_channels

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


# ---------------------------------------------------------------------------
# TTI and elastic (tolerance of tests/test_kernel_multiphysics.py)
# ---------------------------------------------------------------------------

MP_RTOL, MP_ATOL = 2e-4, 1e-5
# physics -> (JAX module, port module)
MODULES = {"tti": (JT, TT), "elastic": (JE, TE)}


def _mp_close(a, b, what):
    np.testing.assert_allclose(np.asarray(a), np.asarray(b), rtol=MP_RTOL,
                               atol=MP_ATOL, err_msg=what)


def _both(c):
    """(JAX state, JAX params, port state, port params) of a case."""
    jm, tm = MODULES[c.physics]
    names = {"tti": ("TTIState", "TTIParams"),
             "elastic": ("ElasticState", "ElasticParams")}[c.physics]
    js = getattr(jm, names[0])(*(jnp.asarray(a) for a in c.state))
    jp = getattr(jm, names[1])(*(jnp.asarray(a) for a in c.params))
    ts = getattr(tm, names[0])(*(torch.from_numpy(a) for a in c.state))
    tp = getattr(tm, names[1])(*(torch.from_numpy(a) for a in c.params))
    return js, jp, ts, tp


@pytest.mark.parametrize("physics,order,sources", [
    ("tti", 2, True), ("tti", 4, True), ("tti", 8, True), ("tti", 4, False),
    ("elastic", 2, True), ("elastic", 4, True), ("elastic", 8, True),
    ("elastic", 4, False)])
def test_listing1_multiphysics_matches_reference(physics, order, sources):
    c = MULTI_CASES[physics](shape=(12, 10, 9), order=order, nt=5)
    js, jp, ts, tp = _both(c)
    g, gr = jax_sparse(c) if sources else (None, None)
    tg, tgr = port_sparse(c) if sources else (None, None)
    jm, tm = MODULES[physics]
    jst, jrec = jm.propagate(c.nt, js, jp, g, c.dt,
                             JGrid(shape=c.shape, spacing=c.spacing), order,
                             receivers=gr)
    tst, trec = tm.propagate(c.nt, ts, tp, tg, c.dt,
                             TGrid(shape=c.shape, spacing=c.spacing), order,
                             receivers=tgr)
    for name, a, b in zip(type(js)._fields, tst, jst):
        _mp_close(a, b, f"{physics} {name}")
    assert_fields_close(zip(type(js)._fields, tst, jst), FIELD_RTOL, physics)
    if sources:
        assert tuple(trec.shape) == np.asarray(jrec).shape
        _mp_close(trec, jrec, f"{physics} traces")
        assert_fields_close(trace_channels(trec, jrec), FIELD_RTOL, physics)
    else:
        assert trec is None and jrec is None


@pytest.mark.parametrize("physics", ["tti", "elastic"])
@pytest.mark.parametrize("masked", [False, True])
def test_stencil_update_mask_fn_matches_reference(physics, masked):
    """One update with and without the `mask_fn` hook the TB driver passes
    (a 0/1 field here, as the domain mask is)."""
    c = MULTI_CASES[physics](shape=(11, 10, 8), order=4)
    js, jp, ts, tp = _both(c)
    dom = (np.random.RandomState(7).rand(*c.shape) > 0.3).astype(np.float32)
    jdom, tdom = jnp.asarray(dom), torch.from_numpy(dom)
    jm, tm = MODULES[physics]
    jout = jm.stencil_update(js, jp, c.dt, c.spacing, 4,
                             mask_fn=(lambda a: a * jdom) if masked else None)
    tout = tm.stencil_update(ts, tp, c.dt, c.spacing, 4,
                             mask_fn=(lambda a: a * tdom) if masked else None)
    for i, (a, b) in enumerate(zip(tout, jout)):
        _mp_close(a, b, f"{physics} output {i} (masked={masked})")
    assert_fields_close(((f"output {i}", a, b)
                         for i, (a, b) in enumerate(zip(tout, jout))),
                        FIELD_RTOL, f"{physics} (masked={masked})")


def test_model_flops_match_reference():
    for order in (2, 4, 8):
        for jm, tm in MODULES.values():
            assert tm.model_flops_per_step((3, 4, 5), order) == \
                jm.model_flops_per_step((3, 4, 5), order)
