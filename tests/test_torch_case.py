"""Test cases built in numpy, fed to both packages.

`acoustic_case` draws as `tests/test_kernel_stencil_tb.py::_setup` does,
in order (velocity, source coordinates, wavelet noise, receiver
coordinates, u0, u1); `tti_case` and `elastic_case` as
`tests/test_kernel_multiphysics.py`'s `_tti_setup` / `_elastic_setup` do
(its `_geometry`, then the model and the state).  So a seed gives those
files' inputs (pinned by the tests below); `elastic_case(si=True)`, which
the port's elastic tests use, draws the same numbers and rescales them.  At
module level only numpy and the port are imported, so the CUDA-only tests
(which run where JAX is not installed) can build the same cases.
"""
from __future__ import annotations

import functools
from typing import NamedTuple, Tuple

import numpy as np
import pytest


class AcousticCase(NamedTuple):
    shape: Tuple[int, int, int]
    spacing: Tuple[float, float, float]
    order: int
    nt: int
    dt: float
    m: np.ndarray        # float32
    damp: np.ndarray     # float32
    src: np.ndarray      # (nsrc, 3) physical coordinates
    wav: np.ndarray      # (nt, nsrc) float64
    rec: np.ndarray      # (nrec, 3)
    u0: np.ndarray       # float32
    u1: np.ndarray


def acoustic_case(shape=(16, 16, 12), order=4, nt=8, nsrc=2, nrec=3,
                  seed=0, spacing=10.0, nbl=3) -> AcousticCase:
    from repro_torch.core import boundary
    from repro_torch.core.grid import Grid
    from repro_torch.core.sources import ricker_wavelet

    grid = Grid(shape=shape, spacing=(spacing,) * 3)
    rng = np.random.RandomState(seed)
    vp = 1500.0 + 1000.0 * rng.rand(*shape)
    m = (1.0 / vp ** 2).astype(np.float32)
    damp = boundary.damping_field(shape, nbl=nbl, spacing=grid.spacing,
                                  device="cpu").numpy()
    dt = grid.cfl_dt(2500.0, order)
    ext = np.asarray(grid.extent)
    src = 5.0 + rng.rand(nsrc, 3) * (ext - 10.0)
    wav = ricker_wavelet(nt, dt, f0=12.0, num=nsrc) + 0.1 * rng.randn(nt, nsrc)
    rec = 5.0 + rng.rand(nrec, 3) * (ext - 10.0)
    u0 = (0.01 * rng.randn(*shape)).astype(np.float32)
    u1 = (0.01 * rng.randn(*shape)).astype(np.float32)
    return AcousticCase(tuple(shape), grid.spacing, order, nt, dt, m, damp,
                        src, wav, rec, u0, u1)


class MultiCase(NamedTuple):
    physics: str         # "tti" | "elastic"
    shape: Tuple[int, int, int]
    spacing: Tuple[float, float, float]
    order: int
    nt: int
    dt: float
    state: Tuple[np.ndarray, ...]    # float32, the state NamedTuple's order
    params: Tuple[np.ndarray, ...]   # float32, the params NamedTuple's order
    src: np.ndarray
    wav: np.ndarray
    rec: np.ndarray


def _geometry(shape, order, nt, nsrc, nrec, seed):
    from repro_torch.core import boundary
    from repro_torch.core.grid import Grid
    from repro_torch.core.sources import ricker_wavelet

    grid = Grid(shape=shape, spacing=(10.0,) * 3)
    rng = np.random.RandomState(seed)
    vp = 2000.0 + 500.0 * rng.rand(*shape)
    damp = boundary.damping_field(shape, nbl=3, spacing=grid.spacing,
                                  device="cpu").numpy()
    dt = grid.cfl_dt(3000.0, order)
    ext = np.asarray(grid.extent)
    src = 5.0 + rng.rand(nsrc, 3) * (ext - 10.0)
    wav = ricker_wavelet(nt, dt, f0=12.0, num=nsrc) + 0.1 * rng.randn(nt, nsrc)
    rec = 5.0 + rng.rand(nrec, 3) * (ext - 10.0)
    return grid, rng, vp, damp, dt, src, wav, rec


def _f32(a):
    return np.asarray(a, np.float32)


def tti_case(shape=(12, 12, 8), order=4, nt=4, nsrc=2, nrec=3,
             seed=0) -> MultiCase:
    grid, rng, vp, damp, dt, src, wav, rec = _geometry(shape, order, nt,
                                                       nsrc, nrec, seed)
    params = (_f32(1.0 / vp ** 2), damp, _f32(0.2 * rng.rand(*shape)),
              _f32(0.1 * rng.rand(*shape)), _f32(0.3 * rng.randn(*shape)),
              _f32(0.3 * rng.randn(*shape)))
    state = tuple(_f32(0.01 * rng.randn(*shape)) for _ in range(4))
    return MultiCase("tti", tuple(shape), grid.spacing, order, nt, dt, state,
                     params, src, wav, rec)


def elastic_case(shape=(12, 12, 8), order=4, nt=4, nsrc=2, nrec=3,
                 seed=0, si=False) -> MultiCase:
    """The reference test's elastic inputs: moduli x1e-6, every state field
    0.01 randn.  There a velocity's stress term moves it by less than its
    float32 rounding, so no comparison can see it.  With `si` the moduli
    are in SI units and the velocities are divided by the impedance
    rho vp, so each term of the velocity and stress updates moves its field
    by a visible fraction of its scale."""
    grid, rng, vp, damp, dt, src, wav, rec = _geometry(shape, order, nt,
                                                       nsrc, nrec, seed)
    rho = 2000.0 + 100.0 * rng.rand(*shape)
    vs = vp / 1.9
    unit = 1.0 if si else 1e-6
    params = (_f32(rho * (vp ** 2 - 2 * vs ** 2) * unit),
              _f32(rho * vs ** 2 * unit), _f32(1.0 / rho), damp)
    vscale = 1.0 / (rho * vp) if si else 1.0
    state = tuple(_f32(0.01 * rng.randn(*shape) * (vscale if i < 3 else 1.0))
                  for i in range(9))
    return MultiCase("elastic", tuple(shape), grid.spacing, order, nt, dt,
                     state, params, src, wav, rec)


# the port's multiphysics cases: elastic in SI units (see `elastic_case`)
MULTI_CASES = {"tti": tti_case,
               "elastic": functools.partial(elastic_case, si=True)}


# max|diff| / max|ref| per field and per receiver channel: the port against
# the JAX package on the CPU, and a CUDA kernel against its plain version
# (both measure 1e-7 to 5e-7 on these cases)
FIELD_RTOL = 1e-5


def field_err(got, want) -> float:
    """max|got - want| / max|want|: the error against the field's own scale
    (an absolute tolerance cannot see a field whose values are 1e-9)."""
    got = np.asarray(got, np.float64)
    want = np.asarray(want, np.float64)
    if want.size == 0:
        return 0.0
    diff, scale = np.abs(got - want).max(), np.abs(want).max()
    return diff / scale if scale > 0 else (0.0 if diff == 0 else np.inf)


def assert_fields_close(named, rtol, what=""):
    """Each (name, got, want) within `rtol` of max|want|."""
    for name, got, want in named:
        assert np.shape(got) == np.shape(want), (what, name)
        err = field_err(got, want)
        assert err <= rtol, \
            f"{what} {name}: max|diff|/max|ref| {err:.3e} > {rtol:g}"


def trace_channels(got, want):
    """(name, got, want) per receiver channel of traces shaped (nt, nrec)
    or (nt, nrec, channels), so each channel is held to its own scale."""
    got, want = np.asarray(got), np.asarray(want)
    if want.ndim == 2:
        return [("traces", got, want)]
    return [(f"traces[{c}]", got[..., c], want[..., c])
            for c in range(want.shape[-1])]


def port_sparse(case, device="cpu", interp=None):
    """The port's (GriddedSources, GriddedReceivers) for `case` (an
    `AcousticCase` or a `MultiCase`)."""
    from repro_torch.core import sources as TS
    from repro_torch.core.grid import Grid
    from repro_torch.core.interp import LINEAR

    grid = Grid(shape=case.shape, spacing=case.spacing)
    spec = LINEAR if interp is None else interp
    g = TS.precompute(TS.SparseOperator(case.src), grid, case.wav,
                      interp=spec, device=device)
    gr = TS.precompute_receivers(TS.SparseOperator(case.rec), grid,
                                 interp=spec, device=device)
    return g, gr


def test_case_reproduces_reference_setup():
    """The helper draws exactly the reference kernel test's inputs."""
    import jax.numpy as jnp
    from test_kernel_stencil_tb import _setup

    c = acoustic_case(shape=(16, 8, 10), order=4, nt=6, seed=3)
    grid, m, damp, dt, g, gr, u0, u1 = _setup(shape=(16, 8, 10), order=4,
                                              nt=6, seed=3)
    np.testing.assert_array_equal(c.m, np.asarray(m))
    np.testing.assert_array_equal(c.damp, np.asarray(damp))
    np.testing.assert_array_equal(c.u0, np.asarray(u0))
    np.testing.assert_array_equal(c.u1, np.asarray(u1))
    assert c.dt == dt
    g2, gr2 = port_sparse(c)
    np.testing.assert_array_equal(g2.src_dcmp.numpy(), np.asarray(g.src_dcmp))
    np.testing.assert_array_equal(gr2.weights.numpy(),
                                  np.asarray(gr.weights.astype(jnp.float32)))


@pytest.mark.parametrize("physics", ["tti", "elastic"])
def test_multi_case_reproduces_reference_setup(physics):
    """`tti_case`/`elastic_case` draw exactly the reference multiphysics
    test's inputs."""
    from test_kernel_multiphysics import _elastic_setup, _tti_setup

    setup = {"tti": _tti_setup, "elastic": _elastic_setup}[physics]
    c = {"tti": tti_case, "elastic": elastic_case}[physics](
        shape=(12, 8, 10), nt=5, seed=4)
    grid, params, state, dt, g, gr = setup(shape=(12, 8, 10), nt=5, seed=4)
    for got, want in zip(c.params + c.state, tuple(params) + tuple(state)):
        np.testing.assert_array_equal(got, np.asarray(want))
    assert c.dt == dt and c.spacing == grid.spacing
    g2, gr2 = port_sparse(c)
    np.testing.assert_array_equal(g2.src_dcmp.numpy(), np.asarray(g.src_dcmp))
    np.testing.assert_array_equal(gr2.indices.numpy(), np.asarray(gr.indices))
