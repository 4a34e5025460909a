"""The reference's bf16 TB against its own float32 run over a paper case's
depth, on a small grid: a script, not a test (it takes minutes).

    PYTHONPATH=src JAX_PLATFORMS=cpu python tests/_bf16_drift.py tti 512
    PYTHONPATH=src JAX_PLATFORMS=cpu python tests/_bf16_drift.py elastic 256

The case is `chip_smoke.full_case`'s (the paper's model, source, receivers
and time step) on a 64 x 64 x 48 grid, run for the given simulated ms by
`repro.kernels.ops.{tti,elastic}_tb_propagate` (``executor="jnp"``, tile
32, T = 4) with the fields and params in float32 and in bf16.  It prints
max|bf16 - float32| / max|float32| of every state field at the end: how
far bf16 alone carries the reference's own propagation, beside what
`chip_smoke.py`'s main-<physics>-bf16 prints for the port on the card.
"""
import sys
from pathlib import Path

import jax.numpy as jnp
import numpy as np
import torch

sys.path.insert(0, str(Path(__file__).resolve().parents[1]))

import chip_smoke as cs  # noqa: E402
from repro.core import sources as JS  # noqa: E402
from repro.core.grid import Grid as JGrid  # noqa: E402
from repro.core.propagators import elastic as jel, tti as jtt  # noqa: E402
from repro.core.temporal_blocking import TBPlan as JPlan  # noqa: E402
from repro.kernels import ops as jops, tb_physics as jphys  # noqa: E402

SHAPE = (64, 64, 48)
REFERENCE = {"tti": (jtt.TTIState, jtt.TTIParams, jops.tti_tb_propagate),
             "elastic": (jel.ElasticState, jel.ElasticParams,
                         jops.elastic_tb_propagate)}


def drift(name: str, ms: float):
    """{state field: max|bf16 - f32| / max|f32|} at the end of `ms`."""
    cs.SHAPE = SHAPE
    fc = cs.full_case(name, torch.device("cpu"), time_ms=ms)
    h = fc.spacing[0]
    grid = JGrid(shape=SHAPE, spacing=fc.spacing)
    src = cs.source_point(SHAPE, (SHAPE[0] - 1) / 2.0 + 0.37) * h
    g = JS.precompute(JS.SparseOperator(src), grid, np.asarray(
        cs.S.ricker_wavelet(fc.nt, fc.dt, fc.case.f0)))
    gr = JS.precompute_receivers(
        JS.SparseOperator(cs.receiver_line(SHAPE) * h), grid)
    state_t, params_t, propagate = REFERENCE[name]
    plan = JPlan(tile=(32, 32), T=4,
                 radius=jphys.PHYSICS[name].step_radius(fc.order))
    out = {}
    for dtype in (jnp.float32, jnp.bfloat16):
        state = state_t(*(jnp.asarray(f.numpy()).astype(dtype)
                          for f in fc.state))
        params = params_t(*(jnp.asarray(p.numpy()).astype(dtype)
                            for p in fc.params))
        final, _ = propagate(fc.nt, state, params, g, gr, plan, fc.order,
                             fc.dt, fc.spacing, executor="jnp")
        out[dtype] = [np.asarray(a.astype(jnp.float32), np.float64)
                      for a in final]
    return fc.nt, {f: float(np.abs(b - a).max() / np.abs(a).max())
                   for f, a, b in zip(state_t._fields, out[jnp.float32],
                                      out[jnp.bfloat16])}


if __name__ == "__main__":
    physics, ms = sys.argv[1], float(sys.argv[2])
    nt, errs = drift(physics, ms)
    print(f"reference {physics} bf16 vs float32 on {SHAPE}, {ms:g} ms (nt "
          f"{nt}): max|d| / max|f32| " + ", ".join(
              f"{f} {e:.3e}" for f, e in errs.items()))
