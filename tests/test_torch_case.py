"""One acoustic test case built in numpy, fed to both packages.

The random draws follow `tests/test_kernel_stencil_tb.py::_setup` in order
(velocity, source coordinates, wavelet noise, receiver coordinates, u0,
u1), so a seed gives that file's inputs (pinned by the test below).  At
module level only numpy and the port are imported, so the CUDA-only tests
(which run where JAX is not installed) can build the same cases.
"""
from __future__ import annotations

from typing import NamedTuple, Tuple

import numpy as np


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


def port_sparse(case: AcousticCase, device="cpu", interp=None):
    """The port's (GriddedSources, GriddedReceivers) for `case`."""
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
