"""The port's TTI and elastic temporally-blocked paths against the JAX
package (mirrors tests/test_kernel_multiphysics.py).

`repro_torch.kernels.ops.{tti,elastic}_tb_propagate(device="cpu")` is held
against the reference's own TB driver (`ops.*_tb_propagate`: the Pallas
kernel in interpret mode for one case per physics, ``executor="jnp"`` for
the rest) and against its Listing-1 oracle (`ref.*_reference`), every
state field and every receiver channel, on the inputs of `_tti_setup` and
of `_elastic_setup` in SI units (`test_torch_case.elastic_case`).
Tolerance: that file's, rtol 2e-4, atol 1e-5, and each field and receiver
channel within `FIELD_RTOL` of its own scale.
"""
import functools

import numpy as np
import jax.numpy as jnp
import pytest

from repro.core import sources as JS
from repro.core.grid import Grid as JGrid
from repro.core.propagators import elastic as jel, tti as jtt
from repro.core.temporal_blocking import TBPlan as JPlan
from repro.kernels import ops as jops, ref as jref, stencil_tb as jker, \
    tb_physics as jphys
from repro_torch import interop
from repro_torch.core.temporal_blocking import TBPlan
from repro_torch.kernels import ops, ref as tref, stencil_tb as tker, \
    tb_physics as tphys
from test_torch_case import FIELD_RTOL, MULTI_CASES, \
    assert_fields_close, port_sparse, trace_channels

RTOL, ATOL = 2e-4, 1e-5

# physics -> (reference state type, params type, TB driver, Listing-1 oracle)
JAX = {"tti": (jtt.TTIState, jtt.TTIParams, jops.tti_tb_propagate,
               jref.tti_reference),
       "elastic": (jel.ElasticState, jel.ElasticParams,
                   jops.elastic_tb_propagate, jref.elastic_reference)}
PORT = {"tti": (ops.tti_tb_propagate, tref.tti_reference),
        "elastic": (ops.elastic_tb_propagate, tref.elastic_reference)}


def _close(a, b, what):
    np.testing.assert_allclose(np.asarray(a), np.asarray(b), rtol=RTOL,
                               atol=ATOL, err_msg=what)


def _all_close(names, got, want, rec, rec_want, what):
    """Every field and receiver channel: the reference test's tolerance,
    and each within `FIELD_RTOL` of its own scale."""
    for name, t, r in zip(names, got, want):
        _close(t, r, f"{what} {name}")
    assert_fields_close(zip(names, got, want), FIELD_RTOL, what)
    if rec_want is not None:
        assert np.shape(rec) == np.shape(rec_want)
        _close(rec, rec_want, f"{what} traces")
        assert_fields_close(trace_channels(rec, rec_want), FIELD_RTOL, what)


def _jax_inputs(c, sources):
    state_t, params_t, _, _ = JAX[c.physics]
    grid = JGrid(shape=c.shape, spacing=c.spacing)
    g = gr = None
    if sources:
        g = JS.precompute(JS.SparseOperator(c.src), grid, c.wav)
        gr = JS.precompute_receivers(JS.SparseOperator(c.rec), grid)
    return (state_t(*(jnp.asarray(a) for a in c.state)),
            params_t(*(jnp.asarray(a) for a in c.params)), g, gr)


@functools.lru_cache(maxsize=None)
def _case_and_reference(physics, nt, sources=True):
    """A case and the reference's Listing-1 result on it (numpy)."""
    c = MULTI_CASES[physics](nt=nt)
    state, params, g, gr = _jax_inputs(c, sources)
    rst, rrec = JAX[physics][3](nt, state, params, c.dt, c.spacing, c.order,
                                g=g, receivers=gr)
    return c, (tuple(np.asarray(a) for a in rst),
               None if rrec is None else np.asarray(rrec))


def _plan(physics, order, tile, T):
    return TBPlan(tile=tile, T=T,
                  radius=tphys.PHYSICS[physics].step_radius(order))


def _port_tb(c, T, tile, sources=True):
    g, gr = port_sparse(c) if sources else (None, None)
    st, rec = PORT[c.physics][0](c.nt, c.state, c.params, g, gr,
                                 _plan(c.physics, c.order, tile, T), c.order,
                                 c.dt, c.spacing, device="cpu")
    return tuple(a.numpy() for a in st), None if rec is None else rec.numpy()


@pytest.mark.parametrize("physics,T,tile,nt,route", [
    ("elastic", 2, (6, 6), 4, "jnp"),      # 2 time tiles
    ("elastic", 1, (6, 6), 2, "pallas"),   # spatially-blocked baseline
    ("elastic", 2, (6, 6), 5, "jnp"),      # nt % T != 0 -> remainder tile
    ("tti", 2, (6, 6), 4, "pallas"),       # 2 time tiles
    ("tti", 2, (12, 6), 4, "jnp"),         # asymmetric tile
    ("tti", 2, (6, 6), 5, "jnp"),          # remainder tile
])
def test_tb_matches_reference(physics, T, tile, nt, route):
    c, (rst, rrec) = _case_and_reference(physics, nt)
    state, params, g, gr = _jax_inputs(c, True)
    jst, jrec = JAX[physics][2](
        nt, state, params, g, gr,
        JPlan(tile=tile, T=T, radius=jphys.PHYSICS[physics].step_radius(4)),
        c.order, c.dt, c.spacing, executor=route)
    tst, trec = _port_tb(c, T, tile)
    names = JAX[physics][0]._fields
    _all_close(names, tst, jst, trec, jrec,
               f"{physics} vs the reference's {route} TB:")
    _all_close(names, tst, rst, trec, rrec,
               f"{physics} vs the Listing-1 reference:")


def test_elastic_no_sources_no_receivers():
    c, (rst, rrec) = _case_and_reference("elastic", 4, sources=False)
    tst, trec = _port_tb(c, 2, (6, 6), sources=False)
    assert trec is None and rrec is None
    _all_close(jel.ElasticState._fields, tst, rst, None, None, "elastic")


@pytest.mark.parametrize("physics", ["tti", "elastic"])
def test_port_reference_matches_reference(physics):
    """The port's own Listing-1 oracle, which `chip_smoke.py` holds the
    card's run against, on the same case."""
    c, (rst, rrec) = _case_and_reference(physics, 5)
    g, gr = port_sparse(c)
    st, rec = PORT[physics][1](c.nt, c.state, c.params, c.dt, c.spacing,
                               c.order, g=g, receivers=gr, device="cpu")
    _all_close(JAX[physics][0]._fields, [t.numpy() for t in st], rst,
               rec.numpy(), rrec, physics)


def test_step_radius_per_physics():
    """Elastic/TTI consume twice the acoustic halo per in-window step."""
    for order in (2, 4, 8):
        for name, p in tphys.PHYSICS.items():
            assert p.step_radius(order) == \
                jphys.PHYSICS[name].step_radius(order)
        assert tphys.ELASTIC.step_radius(order) == order
        assert tphys.TTI.step_radius(order) == order


@pytest.mark.parametrize("physics", ["acoustic", "tti", "elastic"])
def test_physics_specs_match_reference(physics):
    t, j = tphys.PHYSICS[physics], jphys.PHYSICS[physics]
    assert (t.state_fields, t.param_fields, t.evolved_fields,
            t.inject_fields, t.rec_channels, t.radius_mult,
            t.premasked_fields) == \
        (j.state_fields, j.param_fields, j.evolved_fields, j.inject_fields,
         j.rec_channels, j.radius_mult, j.premasked_fields)


@pytest.mark.parametrize("physics", ["tti", "elastic"])
def test_multiphysics_kernel_cost(physics):
    p = tphys.PHYSICS[physics]
    kw = dict(nx=24, ny=24, nz=16, tile=(12, 12), T=2, order=4, dt=1e-3,
              spacing=(10.0,) * 3, src_cap=4, rec_cap=4,
              step_radius=p.step_radius(4), rec_channels=p.rec_channels)
    spec, jspec = tker.TBKernelSpec(**kw), jker.TBKernelSpec(**kw)
    c = tker.kernel_cost(spec, p)
    jc = jker.kernel_cost(jspec, jphys.PHYSICS[physics])
    assert c["useful_flops"] == jc["useful_flops"]
    assert c["hbm_bytes"] == jc["hbm_bytes"]
    assert c["window_bytes"] == jspec.vmem_bytes(p.num_windows)
    nfields = p.num_windows + len(p.state_fields)     # 10 + 4, 13 + 9
    assert c["min_bytes"] == 24 * 24 * 16 * nfields * 4
    assert c["flops"] > c["useful_flops"] > 0
    # TTI's output needs 3 of the 6 rotated second derivatives priced
    per_g = 2 * 3 * (2 * 5 - 1 + 4)
    needed = {"tti": 24 * 24 * 16 * 2 * (3 * per_g + 40),
              "elastic": c["useful_flops"]}[physics]
    assert c["needed_flops"] == needed
    ca = tker.kernel_cost(spec, tphys.ACOUSTIC)
    assert c["hbm_bytes"] > ca["hbm_bytes"]  # more fields than acoustic


@pytest.mark.parametrize("physics", ["tti", "elastic"])
def test_interop_fields_feed_the_port(physics):
    """The reference's state and model cross through `interop` unchanged
    and give the same run as the case's arrays."""
    c, _ = _case_and_reference(physics, 4)
    state, params, _, _ = _jax_inputs(c, False)
    conv = {"tti": (interop.tti_state_from_numpy,
                    interop.tti_model_from_numpy),
            "elastic": (interop.elastic_state_from_numpy,
                        interop.elastic_model_from_numpy)}[physics]
    tstate = conv[0](*state, device="cpu")
    tparams = conv[1](*params, device="cpu")
    for x, y in zip(tuple(tstate) + tuple(tparams),
                    tuple(state) + tuple(params)):
        np.testing.assert_array_equal(x.numpy(), np.asarray(y))
    a, _ = PORT[physics][0](2, tstate, tparams, None, None,
                            _plan(physics, 4, (6, 6), 2), 4, c.dt,
                            c.spacing, device="cpu")
    b, _ = PORT[physics][0](2, c.state, c.params, None, None,
                            _plan(physics, 4, (6, 6), 2), 4, c.dt,
                            c.spacing, device="cpu")
    for x, y in zip(a, b):
        np.testing.assert_array_equal(x.numpy(), y.numpy())


@pytest.mark.parametrize("physics", ["acoustic", "tti", "elastic"])
@pytest.mark.parametrize("order", [2, 4, 8])
def test_kernel_coefs_round_as_the_reference(physics, order):
    """The CUDA kernels' FD coefficients (each axis' taps in order) are the
    reference stencils' ``w * h**-deriv`` rounded to float32."""
    from repro.core import stencil as jst

    weights, deriv = {
        "acoustic": (jst.second_derivative_weights(order), 2),
        "tti": (jst.first_derivative_weights(order), 1),
        "elastic": (jst.staggered_first_derivative_weights(order)[1], 1),
    }[physics]
    spacing = (10.0, 12.5, 7.0)
    spec = tker.TBKernelSpec(nx=8, ny=8, nz=4, tile=(8, 8), T=1, order=order,
                             dt=1e-3, spacing=spacing, src_cap=1, rec_cap=1)
    want = [np.float32(w * h ** -deriv) for h in spacing for w in weights]
    got = tker.kernel_coefs(spec, tphys.PHYSICS[physics])
    np.testing.assert_array_equal(np.asarray(got, np.float32), want)
