"""The port's FD operators, grid and sponge against `repro.core`.

Weights are the same float64 numpy computation, so they must be equal.
The operators are compared on one random field with the reference's
tolerance for float32 (rtol 2e-4, atol 1e-6); they apply the same terms
in the same order, so in practice they agree to a few ulps.
"""
import numpy as np
import jax.numpy as jnp
import pytest
import torch

from repro.core import boundary as JB, stencil as JS
from repro.core.grid import Grid as JGrid
from repro_torch.core import boundary as TB, stencil as TS
from repro_torch.core.grid import Grid as TGrid

RTOL, ATOL = 2e-4, 1e-6
SPACING = (10.0, 12.5, 7.5)


def _field(shape=(9, 8, 7), seed=0):
    return np.random.RandomState(seed).randn(*shape).astype(np.float32)


@pytest.mark.parametrize("order", [2, 4, 8, 12])
def test_weights_equal(order):
    np.testing.assert_array_equal(TS.second_derivative_weights(order),
                                  JS.second_derivative_weights(order))
    np.testing.assert_array_equal(TS.first_derivative_weights(order),
                                  JS.first_derivative_weights(order))
    for a, b in zip(TS.staggered_first_derivative_weights(order),
                    JS.staggered_first_derivative_weights(order)):
        np.testing.assert_array_equal(a, b)
    assert TS.stencil_flops_per_point(order) == \
        JS.stencil_flops_per_point(order)


def test_bad_order_raises():
    with pytest.raises(ValueError):
        TS.second_derivative_weights(3)
    with pytest.raises(ValueError):
        TS.fd_weights((0.0, 1.0), 2)


@pytest.mark.parametrize("order", [2, 4, 8])
def test_laplacian_matches(order):
    u = _field()
    ref = np.asarray(JS.laplacian(jnp.asarray(u), SPACING, order))
    out = TS.laplacian(torch.from_numpy(u), SPACING, order).numpy()
    np.testing.assert_allclose(out, ref, rtol=RTOL, atol=ATOL)


@pytest.mark.parametrize("axis", [0, 1, 2])
@pytest.mark.parametrize("order", [2, 4])
def test_first_and_staggered_derivatives_match(axis, order):
    u = _field(seed=axis)
    h = SPACING[axis]
    ref = np.asarray(JS.first_derivative(jnp.asarray(u), axis, h, order))
    out = TS.first_derivative(torch.from_numpy(u), axis, h, order).numpy()
    np.testing.assert_allclose(out, ref, rtol=RTOL, atol=ATOL)
    for shift in (1, -1):
        ref = np.asarray(JS.staggered_derivative(jnp.asarray(u), axis, h,
                                                 order, shift))
        out = TS.staggered_derivative(torch.from_numpy(u), axis, h, order,
                                      shift).numpy()
        np.testing.assert_allclose(out, ref, rtol=RTOL, atol=ATOL)


def test_shifted_zero_fill():
    u = _field()
    for shift in (-2, 0, 3):
        ref = np.asarray(JS.shifted(jnp.asarray(u), shift, 1, 3))
        out = TS.shifted(torch.from_numpy(u), shift, 1, 3).numpy()
        np.testing.assert_array_equal(out, ref)


def test_coefficients_rounded_to_field_dtype():
    """Each tap's coefficient is w * h**-2 rounded once to the dtype."""
    w = TS.second_derivative_weights(4)
    taps = TS.axis_taps(w, 10.0, 2, torch.float32)
    assert [o for o, _ in taps] == [-2, -1, 0, 1, 2]
    for (_, c), wk in zip(taps, w):
        assert c == float(np.float32(wk * 10.0 ** -2))
    bf = TS.axis_taps(w, 10.0, 2, torch.bfloat16)
    assert all(float(torch.tensor(c, dtype=torch.bfloat16)) == c
               for _, c in bf)


@pytest.mark.parametrize("kw", [
    dict(shape=(12, 10, 9), nbl=3, spacing=(10.0,) * 3),
    dict(shape=(12, 10, 9), nbl=4, spacing=(10.0, 5.0, 20.0), coeff=2.0,
         free_surface_axis=2),
    dict(shape=(6, 6, 6), nbl=0, spacing=(10.0,) * 3),
])
def test_damping_field_matches(kw):
    ref = np.asarray(JB.damping_field(**kw))
    out = TB.damping_field(**kw, device="cpu")
    assert out.dtype == torch.float32
    np.testing.assert_array_equal(out.numpy(), ref)


def test_pad_model_matches():
    v = _field((4, 5, 3))
    np.testing.assert_array_equal(TB.pad_model(v, 2), JB.pad_model(v, 2))


@pytest.mark.parametrize("order", [2, 4, 8])
def test_grid_matches(order):
    kw = dict(shape=(16, 12, 10), spacing=(10.0, 12.0, 8.0),
              origin=(1.0, -2.0, 0.5))
    a, b = JGrid(**kw), TGrid(**kw)
    assert a.cfl_dt(3500.0, order) == b.cfl_dt(3500.0, order)
    assert a.extent == b.extent and a.npoints == b.npoints
    pts = np.random.RandomState(order).rand(5, 3) * 100.0
    np.testing.assert_array_equal(a.physical_to_index(pts),
                                  b.physical_to_index(pts))
    np.testing.assert_array_equal(a.contains(pts), b.contains(pts))
