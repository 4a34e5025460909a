"""End-to-end check of the PyTorch/CUDA port on one NVIDIA card.

    python3 chip_smoke.py

Builds the port's CUDA kernels from `src/repro_torch/kernels/csrc/` (one
per physics: acoustic, TTI, elastic), holds each kernel against its plain
PyTorch version on small cases, then drives the port's three main paths —
temporally-blocked acoustic, TTI and elastic propagation with an
off-the-grid source and receivers, through `ops.acoustic_tb_propagate`,
`ops.tti_tb_propagate` and `ops.elastic_tb_propagate` — at the paper's full
size, checks each against the port's Listing-1 reference, times it beside
its spatially-blocked baseline (T = 1), and prints one JSON line listing
every kernel and a final JSON status line.  It needs a card: without one
it exits non-zero before printing any result.  It imports neither JAX nor
the JAX package.

Phases (one line each): environment, build, kernel vs plain on small
cases, then for each path: main path at full size, spatially-blocked
baseline, kernel timing; then the kernel line.  Any failed check raises,
and the script exits non-zero.
"""
import dataclasses
import json
import math
import statistics
import subprocess
import sys
import time
from pathlib import Path

import numpy as np
import torch

sys.path.insert(0, str(Path(__file__).resolve().parent / "src"))

from repro_torch.core import boundary, sources as S  # noqa: E402
from repro_torch.core.grid import Grid  # noqa: E402
from repro_torch.core.propagators import acoustic, elastic, tti  # noqa: E402
from repro_torch.core.temporal_blocking import TBPlan  # noqa: E402
from repro_torch.kernels import _build, ops, ref  # noqa: E402
from repro_torch.kernels import stencil_tb as ker  # noqa: E402
from repro_torch.kernels import tb_physics as phys  # noqa: E402

RTOL = 2e-4
# kernel vs plain: tests/test_kernel_stencil_tb.py:56 (acoustic),
# tests/test_kernel_multiphysics.py:23-24 (TTI, elastic)
ATOL = {"acoustic": 1e-6, "tti": 1e-5, "elastic": 1e-5}
# kernel vs plain, besides: max|diff| / max|plain| per field and per
# receiver channel, since an absolute tolerance cannot see a field whose
# values are 1e-9 (the elastic velocities in SI units)
FIELD_RTOL = 1e-5
MAIN_TOL = 1e-4                  # max|diff| / max|ref|, fields and traces
HBM_BW = 3.35e12                 # H100 SXM, bytes/s (data sheet)
F32_PEAK = 67e12                 # H100 SXM float32 outside the tensor cores

# The paper's own cases (repro.configs.paper_stencil.full_case(p, 4),
# values copied: the port imports nothing of the JAX package).
SHAPE = (512, 512, 512)
ORDER = 4
TIME_MS = 512.0
F0 = 10.0
NBL = 10
VMIN, VMAX = 1500.0, 3500.0
TILE = (32, 32)
T_TB = 4
NREC = 512
SMALL_SPACING = (10.0, 10.0, 10.0)


def say(phase, msg):
    print(f"[{phase}] {msg}", flush=True)


def cuda_ms(fn, reps=1):
    """Mean device time of fn() over `reps` runs, by CUDA events."""
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    torch.cuda.synchronize()
    start.record()
    for _ in range(reps):
        out = fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / reps, out


def max_rel(a, b):
    return float((a - b).abs().max()) / max(float(b.abs().max()), 1e-30)


def check_close(name, got, want, atol):
    """(max|diff|, max|diff| / max|want|) of a kernel's output `got` against
    its plain version's `want`; raises past rtol/atol or FIELD_RTOL."""
    err = float((got - want).abs().max()) if want.numel() else 0.0
    scale = float(want.abs().max()) if want.numel() else 0.0
    rel = err / scale if scale > 0 else (0.0 if err == 0 else math.inf)
    if not (torch.allclose(got, want, rtol=RTOL, atol=atol)
            and rel <= FIELD_RTOL):
        raise AssertionError(f"{name}: kernel disagrees with its plain "
                             f"version, max|diff| = {err:.3e}, max|diff| / "
                             f"max|plain| = {rel:.3e} (rtol {RTOL}, atol "
                             f"{atol}, field rtol {FIELD_RTOL})")
    return err, rel


def plan_for(physics, T):
    return TBPlan(TILE, T, physics.step_radius(ORDER))


# ---------------------------------------------------------------------------

def phase_environment():
    if not torch.cuda.is_available():
        print("chip_smoke: torch.cuda.is_available() is False; this check "
              "needs an NVIDIA card", file=sys.stderr)
        sys.exit(2)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True, timeout=60).stdout.strip().splitlines()[0]
    say("env", f"torch {torch.__version__} cuda {torch.version.cuda} "
        f"device {torch.cuda.get_device_name(0)} "
        f"count {torch.cuda.device_count()}")
    print(smi, flush=True)
    return smi


def phase_build():
    built = _build.build_all()
    for name, b in built.items():
        ptxas = [ln.strip() for ln in b.log.splitlines()
                 if "registers" in ln or "Compiling entry" in ln
                 or "spill" in ln]
        took = f"nvcc {b.seconds:.1f} s" if b.seconds else "reused build"
        say("build", f"{name}: {took} -> {b.path.name}; "
            + " | ".join(ptxas))


# ---------------------------------------------------------------------------
# Small cases: each kernel against its plain version
# ---------------------------------------------------------------------------

def small_case(name, shape, order, nsrc, nrec, seed, dev):
    """(state tuple, params dict, g, gr, dt) of a small random case.  The
    elastic moduli are in SI units and its velocities 0.01 randn / (rho vp),
    so every term of the velocity and stress updates moves its field by a
    visible fraction of the field's scale."""
    grid = Grid(shape=shape, spacing=SMALL_SPACING)
    rng = np.random.RandomState(seed)
    vp = 1500.0 + 1000.0 * rng.rand(*shape)
    damp = boundary.damping_field(shape, 3, SMALL_SPACING, device=dev)
    dt = grid.cfl_dt(2500.0, order)
    ext = np.asarray(grid.extent)
    g = gr = None
    if nsrc:
        wav = S.ricker_wavelet(8, dt, 12.0, nsrc) + 0.1 * rng.randn(8, nsrc)
        g = S.precompute(S.SparseOperator(5.0 + rng.rand(nsrc, 3)
                                          * (ext - 10.0)), grid, wav,
                         device=dev)
        gr = S.precompute_receivers(
            S.SparseOperator(5.0 + rng.rand(nrec, 3) * (ext - 10.0)), grid,
            device=dev)

    def f32(a):
        return torch.as_tensor(np.asarray(a, np.float32), device=dev)

    if name == "acoustic":
        params = {"m": f32(1.0 / vp ** 2), "damp": damp}
    elif name == "tti":
        params = {"m": f32(1.0 / vp ** 2), "damp": damp,
                  "epsilon": f32(0.2 * rng.rand(*shape)),
                  "delta": f32(0.1 * rng.rand(*shape)),
                  "theta": f32(0.3 * rng.randn(*shape)),
                  "phi": f32(0.3 * rng.randn(*shape))}
    else:
        rho = 2000.0 + 100.0 * rng.rand(*shape)
        vs = vp / 1.9
        params = {"lam": f32(rho * (vp ** 2 - 2 * vs ** 2)),
                  "mu": f32(rho * vs ** 2), "b": f32(1.0 / rho),
                  "damp": damp}
    fields = phys.PHYSICS[name].state_fields
    state = tuple(f32(0.01 * rng.randn(*shape)
                      / (rho * vp if f in ("vx", "vy", "vz") else 1.0))
                  for f in fields)
    return state, params, g, gr, dt


def kernel_inputs(physics, plan, state, params, g, gr, dt, t0, spacing,
                  order=ORDER):
    """(spec, kernel operands) of the time tile at t0, as the main path
    builds them."""
    spec, st, rt, ppads = ops.prepare_tiles(
        plan, physics, state[0], params, g, gr, order, dt, spacing)
    src_dcmp = g.src_dcmp if g is not None else None
    pads, sc, sv, rc, rw = ops.tile_operands(spec, state, src_dcmp, st, rt,
                                             t0)
    return spec, (pads, ppads, sc, sv, rc, rw)


def uncounted(fn):
    """fn() with the launch counter left as it was (launches made to time
    or compare a kernel are not main-path launches)."""
    saved = ker.launches
    out = fn()
    ker.launches = saved
    return out


def compare_kernel(spec, physics, args):
    """One kernel launch against the plain version on the same inputs:
    (max|diff|, max over fields and receiver channels of max|diff| /
    max|plain|)."""
    kst, krec = uncounted(lambda: ker.tb_time_tile(spec, physics, *args))
    pst, prec = ker.tb_time_tile_plain(spec, physics, *args)
    torch.cuda.synchronize()
    atol = ATOL[physics.name]
    pairs = [(f, k, p) for f, k, p in zip(physics.state_fields, kst, pst)]
    pairs += [(f"rec[{c}]", krec[..., c], prec[..., c])
              for c in range(prec.shape[-1])]
    errs = [check_close(f"{physics.name} {f}", k, p, atol)
            for f, k, p in pairs]
    return max(e for e, _ in errs), max(r for _, r in errs)


SMALL_CASES = [  # (T, tile, order, shape, sources)
    (1, (8, 8), 4, (16, 16, 40), True),
    (2, (16, 8), 2, (32, 16, 37), True),
    (3, (8, 8), 8, (16, 24, 33), True),
    (4, (16, 16), 4, (32, 32, 45), True),
    (4, (8, 8), 2, (24, 16, 64), True),
    (2, (16, 16), 8, (32, 32, 29), False),
]
# TTI and elastic (step radius = order): T in {1, 2, 4}, tiles (8, 8) and
# (16, 8), orders 2/4/8, nz not a multiple of 32, one case without sources
# or receivers
SMALL_MP_CASES = [
    (1, (8, 8), 4, (16, 16, 40), True),
    (2, (16, 8), 2, (32, 16, 37), True),
    (4, (8, 8), 4, (16, 24, 33), True),
    (2, (8, 8), 8, (16, 16, 20), True),
    (4, (16, 8), 2, (32, 16, 64), True),
    (2, (16, 8), 4, (32, 16, 29), False),
]


def phase_kernel_vs_plain(dev):
    for name, cases in (("acoustic", SMALL_CASES), ("tti", SMALL_MP_CASES),
                        ("elastic", SMALL_MP_CASES)):
        physics = phys.PHYSICS[name]
        worst = worst_rel = 0.0
        for i, (T, tile, order, shape, sources) in enumerate(cases):
            state, params, g, gr, dt = small_case(
                name, shape, order, 3 if sources else 0, 4, i, dev)
            plan = TBPlan(tile, T, physics.step_radius(order))
            spec, args = kernel_inputs(physics, plan, state, params, g,
                                       gr, dt, 1, SMALL_SPACING, order=order)
            err, rel = compare_kernel(spec, physics, args)
            worst, worst_rel = max(worst, err), max(worst_rel, rel)
            say("kernel-vs-plain", f"{name} T={T} tile={tile} order={order} "
                f"shape={shape} sources={sources}: max|diff| {err:.3e}, "
                f"max|diff|/max|plain| {rel:.3e}")
        say("kernel-vs-plain", f"{name}: {len(cases)} cases within rtol "
            f"{RTOL} atol {ATOL[name]} and field rtol {FIELD_RTOL}; worst "
            f"max|diff| {worst:.3e}, max|diff|/max|plain| {worst_rel:.3e}")


# ---------------------------------------------------------------------------
# The three main paths at full size
# ---------------------------------------------------------------------------

# physics -> (params type, TB entry point, Listing-1 oracle), each called
# as (nt, state, params, ...); acoustic's take their fields one by one
PATHS = {
    "acoustic": (
        acoustic.AcousticParams,
        lambda nt, s, p, *a, **k: ops.acoustic_tb_propagate(nt, *s, *p, *a,
                                                            **k),
        lambda nt, s, p, *a, **k: ref.acoustic_reference(nt, *s, *p, *a,
                                                         **k)),
    "tti": (tti.TTIParams, ops.tti_tb_propagate, ref.tti_reference),
    "elastic": (elastic.ElasticParams, ops.elastic_tb_propagate,
                ref.elastic_reference),
}


@dataclasses.dataclass
class FullCase:
    physics: phys.TBPhysics
    spacing: tuple
    nt: int
    dt: float
    state: tuple                  # in physics.state_fields order
    params: tuple                 # the physics' params NamedTuple
    g: S.GriddedSources
    gr: S.GriddedReceivers

    def run(self, plan):
        """The TB entry point: (final state tuple, traces)."""
        final, recs = PATHS[self.physics.name][1](
            self.nt, self.state, self.params, self.g, self.gr, plan, ORDER,
            self.dt, self.spacing, executor="cuda",
            device=self.state[0].device)
        return tuple(final), recs

    def reference(self):
        """The Listing-1 oracle: (final state tuple, traces)."""
        final, recs = PATHS[self.physics.name][2](
            self.nt, self.state, self.params, self.dt, self.spacing, ORDER,
            g=self.g, receivers=self.gr, device=self.state[0].device)
        return tuple(final), recs


def _layered(shape, top, bottom, dev):
    """A field of two layers in z (`top` above nz / 2), contiguous."""
    col = np.where(np.arange(shape[2]) < shape[2] // 2, top, bottom)
    return torch.as_tensor(col.astype(np.float32), device=dev) \
        .expand(shape).contiguous()


def _smooth_angle(shape, dev, fx, fy):
    """Between 0 and 0.5 rad, varying smoothly in x and y."""
    x = np.arange(shape[0])[:, None] / shape[0]
    y = np.arange(shape[1])[None, :] / shape[1]
    a = 0.25 * (1.0 + np.sin(2 * np.pi * fx * x) * np.cos(2 * np.pi * fy * y))
    return torch.as_tensor(a.astype(np.float32)[:, :, None], device=dev) \
        .expand(shape).contiguous()


def full_case(name, dev):
    """The paper's case for `name` (acoustic, tti or elastic): 512^3, space
    order 4, 512 ms, two-layer 1500/3500 m/s model with a `nbl=10` sponge,
    one off-the-grid 10 Hz Ricker source and 512 off-the-grid receivers on
    a line, placed in grid units so each spacing sees the same geometry."""
    physics = phys.PHYSICS[name]
    h = 20.0 if name == "tti" else 10.0          # paper: 20 m for TTI
    spacing = (h, h, h)
    grid = Grid(shape=SHAPE, spacing=spacing)
    # TTI's fastest speed is vmax sqrt(1 + 2 eps) with eps up to 0.2
    vfast = VMAX * math.sqrt(1.0 + 2.0 * 0.2) if name == "tti" else VMAX
    dt = grid.cfl_dt(vfast, ORDER)
    nt = max(int(math.ceil(TIME_MS / 1000.0 / dt)), 1)
    damp = boundary.damping_field(SHAPE, NBL, spacing, device=dev)
    c = (np.asarray(SHAPE) - 1) / 2.0
    src = S.SparseOperator(np.array([[c[0] + 0.37, c[1] - 0.41, 21.13]]) * h)
    g = S.precompute(src, grid, S.ricker_wavelet(nt, dt, F0), device=dev)
    rec = S.SparseOperator(np.stack(
        [np.linspace(0.53, SHAPE[0] - 1.53, NREC), np.full(NREC, c[1] + 0.19),
         np.full(NREC, 12.17)], axis=1) * h)
    gr = S.precompute_receivers(rec, grid, device=dev)
    state = tuple(torch.zeros(SHAPE, dtype=torch.float32, device=dev)
                  for _ in physics.state_fields)
    if name == "acoustic":
        params = {"m": _layered(SHAPE, 1 / VMIN ** 2, 1 / VMAX ** 2, dev),
                  "damp": damp}
    elif name == "tti":
        params = {"m": _layered(SHAPE, 1 / VMIN ** 2, 1 / VMAX ** 2, dev),
                  "damp": damp,
                  "epsilon": _layered(SHAPE, 0.10, 0.20, dev),
                  "delta": _layered(SHAPE, 0.05, 0.10, dev),
                  "theta": _smooth_angle(SHAPE, dev, 1.0, 1.0),
                  "phi": _smooth_angle(SHAPE, dev, 2.0, 0.5)}
    else:
        # SI units: lam = rho (vp^2 - 2 vs^2), mu = rho vs^2, b = 1 / rho
        rho = 2100.0
        vp = np.array([VMIN, VMAX])
        vs = vp / 1.9
        lam = rho * (vp ** 2 - 2 * vs ** 2)
        mu = rho * vs ** 2
        params = {"lam": _layered(SHAPE, lam[0], lam[1], dev),
                  "mu": _layered(SHAPE, mu[0], mu[1], dev),
                  "b": _layered(SHAPE, 1 / rho, 1 / rho, dev),
                  "damp": damp}
    return FullCase(physics, spacing, nt, dt, state,
                    PATHS[name][0](**params), g, gr)


def phase_main_path(fc, smi):
    name = fc.physics.name
    nt = fc.nt
    n_main, rem = divmod(nt, T_TB)
    expect = n_main + (1 if rem else 0)
    plan = plan_for(fc.physics, T_TB)

    ker.launches = 0
    final, recs = fc.run(plan)
    torch.cuda.synchronize()
    launches = ker.launches
    if launches != expect:
        raise AssertionError(f"{name} main path made {launches} kernel "
                             f"launches, expected {expect}")
    say(f"main-{name}", f"{SHAPE} spacing {fc.spacing[0]:g} m nt={nt} "
        f"dt={fc.dt:.6e} T={T_TB} tile={TILE}: {launches} kernel launches "
        f"({n_main} depth-{T_TB} tiles + "
        f"{'a depth-%d remainder' % rem if rem else 'no remainder'})")
    if not (all(torch.isfinite(f).all() for f in final)
            and torch.isfinite(recs).all()):
        raise AssertionError(f"{name} main path produced non-finite values")
    want = (nt, NREC) + ((2,) if fc.physics.rec_channels == 2 else ())
    if tuple(recs.shape) != want:
        raise AssertionError(f"{name} traces shaped {tuple(recs.shape)}, "
                             f"expected {want}")

    t0 = time.perf_counter()
    rfinal, rrec = fc.reference()
    torch.cuda.synchronize()
    ref_s = time.perf_counter() - t0
    errs = {f: max_rel(a, b)
            for f, a, b in zip(fc.physics.state_fields, final, rfinal)}
    err_f = max(errs.values())
    # each receiver channel against its own scale (elastic: vz, pressure)
    chans = [(recs[..., c], rrec[..., c]) for c in range(recs.shape[-1])] \
        if recs.dim() == 3 else [(recs, rrec)]
    err_ch = [max_rel(a, b) for a, b in chans]
    err_tr = max(err_ch)
    say(f"main-{name}", f"vs Listing-1 reference ({ref_s:.1f} s): "
        f"max over fields of max|dfield|/max|field_ref| {err_f:.3e} ("
        + ", ".join(f"{f} {e:.2e}" for f, e in errs.items())
        + "), max|dtrace|/max|trace_ref| per channel "
        + ", ".join(f"{e:.3e}" for e in err_ch)
        + f" (limit {MAIN_TOL:g}); max|trace_ref| per channel "
        + ", ".join(f"{float(b.abs().max()):.4e}" for _, b in chans))
    if not (err_f <= MAIN_TOL and err_tr <= MAIN_TOL):
        raise AssertionError(f"{name} main path disagrees with the "
                             f"reference: {err_f:.3e}, {err_tr:.3e} > "
                             f"{MAIN_TOL}")
    del rfinal, rrec, recs

    torch.cuda.reset_peak_memory_stats()
    ms, _ = cuda_ms(lambda: fc.run(plan))
    peak = torch.cuda.max_memory_allocated() / 2 ** 30
    mpts = SHAPE[0] * SHAPE[1] * SHAPE[2] * nt / (ms * 1e-3) / 1e6
    say(f"main-{name}", f"TB run {ms:.1f} ms = {ms / launches:.3f} ms per "
        f"time tile = {ms / nt:.3f} ms per step, {mpts:.1f} Mpt*steps/s, "
        f"peak {peak:.2f} GiB [{smi}]")
    return final, launches, ms


def time_tile_pieces(fc, plan, state, t0):
    """Device ms of the three pieces of one main-path time tile at t0: its
    operands (zero-padded state, source values), the kernel alone (after a
    warm-up, the median of 3 means of 5 launches; the least and the most of
    the 3 are returned too), and the receivers' segment sum.
    Returns (spec, kernel args, (ms, ms, ms), (min ms, max ms))."""
    physics = fc.physics
    spec, st, rt, ppads = ops.prepare_tiles(
        plan, physics, state[0], fc.params._asdict(), fc.g, fc.gr, ORDER,
        fc.dt, fc.spacing)
    op_ms, (pads, sc, sv, rc, rw) = cuda_ms(
        lambda: ops.tile_operands(spec, state, fc.g.src_dcmp, st, rt, t0),
        reps=3)
    args = (pads, ppads, sc, sv, rc, rw)
    launch = lambda: ker.tb_time_tile(spec, physics, *args)  # noqa: E731
    _, rec_part = uncounted(launch)                         # warm-up
    means = [uncounted(lambda: cuda_ms(launch, reps=5))[0]
             for _ in range(3)]
    rec_ms, _ = cuda_ms(lambda: ops.combine_rec_partials(rec_part, rt, NREC),
                        reps=3)
    return (spec, args, (op_ms, statistics.median(means), rec_ms),
            (min(means), max(means)))


def say_pieces(phase, what, pieces, measured_ms):
    op_ms, k_ms, rec_ms = pieces
    say(phase, f"{what}: operands (state zero-pad, source values) "
        f"{op_ms:.3f} ms + kernel {k_ms:.3f} ms + receiver sums "
        f"{rec_ms:.3f} ms = {sum(pieces):.3f} ms, against {measured_ms:.3f} "
        f"ms per tile in the run")


def phase_sb(fc, smi, tb_ms, state):
    name, nt = fc.physics.name, fc.nt
    plan = plan_for(fc.physics, 1)
    fc.run(plan)                                 # warm-up
    ms, _ = cuda_ms(lambda: fc.run(plan))
    mpts = SHAPE[0] * SHAPE[1] * SHAPE[2] * nt / (ms * 1e-3) / 1e6
    say(f"sb-{name}", f"SB (T=1) run {ms:.1f} ms = {ms / nt:.3f} ms per "
        f"step, {mpts:.1f} Mpt*steps/s; TB/SB time ratio {tb_ms / ms:.3f} "
        f"(no gain claimed) [{smi}]")
    _, _, pieces, (lo, hi) = time_tile_pieces(fc, plan, state, nt // 2)
    say(f"sb-{name}", f"SB kernel alone {pieces[1]:.3f} ms per launch "
        f"(median of 3 means of 5; least {lo:.3f}, most {hi:.3f}) = "
        f"{100 * pieces[1] * nt / ms:.1f}% of the SB run")
    say_pieces(f"sb-{name}", "one SB step", pieces, ms / nt)


KERNEL_FILES = {"acoustic": "stencil_tb", "tti": "stencil_tb_tti",
                "elastic": "stencil_tb_elastic"}


def kernel_entry(fc, state, launches, tb_ms, smi):
    """The kernels-line entry of this path's kernel, timed on a mid-run
    tile with live state."""
    name = fc.physics.name
    plan = plan_for(fc.physics, T_TB)
    t0 = (fc.nt // T_TB // 2) * T_TB
    spec, args, pieces, (lo, hi) = time_tile_pieces(fc, plan, state, t0)
    ms = pieces[1]
    err, rel = compare_kernel(spec, fc.physics, args)
    say_pieces(f"kernels-{name}", f"one depth-{T_TB} TB tile", pieces,
               tb_ms / launches)
    plain_ms, _ = cuda_ms(
        lambda: ker.tb_time_tile_plain(spec, fc.physics, *args))
    cost = ker.kernel_cost(spec, fc.physics)
    t_bytes = cost["min_bytes"] / HBM_BW * 1e3
    t_ops = cost["needed_flops"] / F32_PEAK * 1e3
    bound = max(t_bytes, t_ops)
    say(f"kernels-{name}", f"tb_{name} at {SHAPE} T={T_TB}: {ms:.3f} ms per "
        f"launch (median of 3 means of 5; least {lo:.3f}, most {hi:.3f}) "
        f"vs bound {bound:.3f} ms ({cost['min_bytes'] / 1e9:.2f} GB in "
        f"{t_bytes:.3f} ms; {cost['needed_flops'] / 1e9:.1f} GFLOP needed "
        f"in {t_ops:.3f} ms, of {cost['useful_flops'] / 1e9:.1f} GFLOP the "
        f"reference counts), plain {plain_ms:.1f} ms; kernel = "
        f"{100 * ms * launches / tb_ms:.1f}% of the TB run; max|diff| vs "
        f"plain {err:.3e}, max|diff|/max|plain| {rel:.3e} [{smi}]")
    return {
        "name": f"stencil_tb.tb_{name}",
        "route": "cuda",
        "source": f"src/repro_torch/kernels/csrc/{KERNEL_FILES[name]}.cu",
        "replaces": "src/repro/kernels/stencil_tb.py:129",
        "launches": launches,
        "max_abs_err": err,
        "ms": ms,
        "plain_ms": plain_ms,
        "bound_ms": bound,
        "bound_by": "bytes" if t_bytes >= t_ops else "operations",
        "library_ms": None,
    }


def run_path(name, smi, dev):
    fc = full_case(name, dev)
    state, launches, tb_ms = phase_main_path(fc, smi)
    phase_sb(fc, smi, tb_ms, state)
    entry = kernel_entry(fc, state, launches, tb_ms, smi)
    del fc, state
    torch.cuda.empty_cache()          # the next path's fields are larger
    return entry


def main():
    smi = phase_environment()
    dev = torch.device("cuda", 0)
    phase_build()
    phase_kernel_vs_plain(dev)
    entries = [run_path(name, smi, dev)
               for name in ("acoustic", "tti", "elastic")]
    print(json.dumps({"kernels": entries}), flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)


if __name__ == "__main__":
    main()
