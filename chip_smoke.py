"""End-to-end check of the PyTorch/CUDA port on one NVIDIA card.

    python3 chip_smoke.py

Builds the port's CUDA kernels from `src/repro_torch/kernels/csrc/`, holds
each kernel against its plain PyTorch version, drives the port's main path
(temporally-blocked acoustic propagation with an off-the-grid source and
receivers) at the paper's full size, checks it against the port's
Listing-1 reference, times it beside the spatially-blocked baseline, and
prints one JSON line per kernel and a final JSON status line.  It needs a
card: without one it exits non-zero before printing any result.  It
imports neither JAX nor the JAX package.

Phases (one line each): environment, build, kernel vs plain on small
cases, main path at full size, spatially-blocked baseline, kernel line.
Any failed check raises, and the script exits non-zero.
"""
import json
import math
import subprocess
import sys
import time
from pathlib import Path

import numpy as np
import torch

sys.path.insert(0, str(Path(__file__).resolve().parent / "src"))

from repro_torch.core import boundary, sources as S  # noqa: E402
from repro_torch.core.grid import Grid  # noqa: E402
from repro_torch.core.temporal_blocking import TBPlan  # noqa: E402
from repro_torch.kernels import _build, ops, ref  # noqa: E402
from repro_torch.kernels import stencil_tb as ker  # noqa: E402
from repro_torch.kernels import tb_physics as phys  # noqa: E402

RTOL, ATOL = 2e-4, 1e-6          # tests/test_kernel_stencil_tb.py:56
MAIN_TOL = 1e-4                  # max|diff| / max|ref|, fields and traces
HBM_BW = 3.35e12                 # H100 SXM, bytes/s (data sheet)
F32_PEAK = 67e12                 # H100 SXM float32 outside the tensor cores

# The paper's own case (repro.configs.paper_stencil.full_case("acoustic", 4),
# values copied: the port imports nothing of the JAX package).
SHAPE = (512, 512, 512)
SPACING = (10.0, 10.0, 10.0)
ORDER = 4
TIME_MS = 512.0
F0 = 10.0
NBL = 10
VMIN, VMAX = 1500.0, 3500.0
PLAN = TBPlan(tile=(32, 32), T=4, radius=ORDER // 2)
NREC = 512


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


def check_close(name, got, want):
    if not torch.allclose(got, want, rtol=RTOL, atol=ATOL):
        err = float((got - want).abs().max())
        raise AssertionError(f"{name}: kernel disagrees with its plain "
                             f"version, max|diff| = {err:.3e} (rtol {RTOL}, "
                             f"atol {ATOL})")
    return float((got - want).abs().max())


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


def _small_case(shape, order, nsrc, nrec, seed, dev):
    grid = Grid(shape=shape, spacing=SPACING)
    rng = np.random.RandomState(seed)
    vp = 1500.0 + 1000.0 * rng.rand(*shape)
    m = torch.as_tensor((1.0 / vp ** 2).astype(np.float32), device=dev)
    damp = boundary.damping_field(shape, 3, SPACING, device=dev)
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
    state = tuple(torch.as_tensor((0.01 * rng.randn(*shape))
                                  .astype(np.float32), device=dev)
                  for _ in range(2))
    return state, {"m": m, "damp": damp}, g, gr, dt


def kernel_inputs(plan, state, params, g, gr, dt, t0, order=ORDER):
    """The kernel's operands for the time tile at t0, as the main path
    builds them."""
    spec, st, rt, ppads = ops.prepare_tiles(
        plan, phys.ACOUSTIC, state[0], params, g, gr, order, dt, SPACING)
    src_dcmp = g.src_dcmp if g is not None else None
    pads, sc, sv, rc, rw = ops.tile_operands(spec, state, src_dcmp, st, rt,
                                             t0)
    return spec, (pads, ppads, sc, sv, rc, rw)


def kernel_alone_ms(spec, args, reps=5):
    """Device ms per launch of the kernel alone on `args` (not counted as
    main-path launches)."""
    saved = ker.launches
    ker.tb_time_tile(spec, phys.ACOUSTIC, *args)            # warm-up
    ms, _ = cuda_ms(lambda: ker.tb_time_tile(spec, phys.ACOUSTIC, *args),
                    reps)
    ker.launches = saved
    return ms


def time_tile_pieces(plan, fc, state, t0):
    """Device ms of the three pieces of one main-path time tile at t0: its
    operands (zero-padded state, source values), the kernel alone, and the
    receivers' segment sum.  Returns (spec, kernel args, (ms, ms, ms))."""
    spec, st, rt, ppads = ops.prepare_tiles(
        plan, phys.ACOUSTIC, state[0], {"m": fc["m"], "damp": fc["damp"]},
        fc["g"], fc["gr"], ORDER, fc["dt"], SPACING)
    op_ms, (pads, sc, sv, rc, rw) = cuda_ms(
        lambda: ops.tile_operands(spec, state, fc["g"].src_dcmp, st, rt, t0),
        reps=3)
    args = (pads, ppads, sc, sv, rc, rw)
    k_ms = kernel_alone_ms(spec, args)
    saved = ker.launches
    _, rec_part = ker.tb_time_tile(spec, phys.ACOUSTIC, *args)
    ker.launches = saved
    rec_ms, _ = cuda_ms(lambda: ops.combine_rec_partials(rec_part, rt, NREC),
                        reps=3)
    return spec, args, (op_ms, k_ms, rec_ms)


def say_pieces(phase, what, pieces, measured_ms):
    op_ms, k_ms, rec_ms = pieces
    say(phase, f"{what}: operands (state zero-pad, source values) "
        f"{op_ms:.3f} ms + kernel {k_ms:.3f} ms + receiver sums "
        f"{rec_ms:.3f} ms = {sum(pieces):.3f} ms, against {measured_ms:.3f} "
        f"ms per tile in the run")


def compare_kernel(spec, args):
    """One kernel launch against the plain version on the same inputs."""
    (k0, k1), krec = ker.tb_time_tile(spec, phys.ACOUSTIC, *args)
    (p0, p1), prec = ker.tb_time_tile_plain(spec, phys.ACOUSTIC, *args)
    torch.cuda.synchronize()
    return max(check_close("u_prev", k0, p0), check_close("u", k1, p1),
               check_close("rec", krec, prec))


def phase_kernel_vs_plain(dev):
    cases = [  # (T, tile, order, shape, sources)
        (1, (8, 8), 4, (16, 16, 40), True),
        (2, (16, 8), 2, (32, 16, 37), True),
        (3, (8, 8), 8, (16, 24, 33), True),
        (4, (16, 16), 4, (32, 32, 45), True),
        (4, (8, 8), 2, (24, 16, 64), True),
        (2, (16, 16), 8, (32, 32, 29), False),
    ]
    worst = 0.0
    for i, (T, tile, order, shape, sources) in enumerate(cases):
        state, params, g, gr, dt = _small_case(
            shape, order, 3 if sources else 0, 4, i, dev)
        spec, args = kernel_inputs(TBPlan(tile, T, order // 2), state,
                                   params, g, gr, dt, 1, order=order)
        err = compare_kernel(spec, args)
        worst = max(worst, err)
        say("kernel-vs-plain", f"T={T} tile={tile} order={order} "
            f"shape={shape} sources={sources}: max|diff| {err:.3e}")
    say("kernel-vs-plain", f"{len(cases)} cases within rtol {RTOL} atol "
        f"{ATOL}; worst max|diff| {worst:.3e}")


def full_case(dev):
    grid = Grid(shape=SHAPE, spacing=SPACING)
    dt = grid.cfl_dt(VMAX, ORDER)
    nt = max(int(math.ceil(TIME_MS / 1000.0 / dt)), 1)
    nz = SHAPE[2]
    vp = np.where(np.arange(nz) < nz // 2, VMIN, VMAX)   # two layers in z
    m_col = torch.as_tensor((1.0 / vp ** 2).astype(np.float32), device=dev)
    m = m_col.expand(SHAPE).contiguous()
    damp = boundary.damping_field(SHAPE, NBL, SPACING, device=dev)
    ext = np.asarray(grid.extent)
    src = S.SparseOperator(np.array([[ext[0] / 2 + 3.7, ext[1] / 2 - 4.1,
                                      211.3]]))
    wav = S.ricker_wavelet(nt, dt, F0)
    g = S.precompute(src, grid, wav, device=dev)
    rec = S.SparseOperator(np.stack([np.linspace(5.3, ext[0] - 5.3, NREC),
                                     np.full(NREC, ext[1] / 2 + 1.9),
                                     np.full(NREC, 121.7)], axis=1))
    gr = S.precompute_receivers(rec, grid, device=dev)
    zeros = torch.zeros(SHAPE, dtype=torch.float32, device=dev)
    return dict(nt=nt, dt=dt, m=m, damp=damp, g=g, gr=gr, u0=zeros,
                u1=zeros.clone())


def phase_main_path(fc, smi, dev):
    nt, dt = fc["nt"], fc["dt"]
    n_main, rem = divmod(nt, PLAN.T)
    expect = n_main + (1 if rem else 0)

    def run():
        return ops.acoustic_tb_propagate(
            nt, fc["u0"], fc["u1"], fc["m"], fc["damp"], fc["g"], fc["gr"],
            PLAN, ORDER, dt, SPACING, executor="cuda", device=dev)

    ker.launches = 0
    (u0, u1), recs = run()
    torch.cuda.synchronize()
    launches = ker.launches
    if launches != expect:
        raise AssertionError(f"main path made {launches} kernel launches, "
                             f"expected {expect}")
    say("main", f"{SHAPE} nt={nt} dt={dt:.6e} T={PLAN.T} tile={PLAN.tile}: "
        f"{launches} kernel launches ({n_main} depth-{PLAN.T} tiles + "
        f"{'a depth-%d remainder' % rem if rem else 'no remainder'})")
    if not (torch.isfinite(u1).all() and torch.isfinite(recs).all()):
        raise AssertionError("main path produced non-finite values")
    if tuple(recs.shape) != (nt, NREC):
        raise AssertionError(f"traces shaped {tuple(recs.shape)}")

    t0 = time.perf_counter()
    (r0, r1), rrec = ref.acoustic_reference(
        nt, fc["u0"], fc["u1"], fc["m"], fc["damp"], dt, SPACING, ORDER,
        g=fc["g"], receivers=fc["gr"], device=dev)
    torch.cuda.synchronize()
    ref_s = time.perf_counter() - t0
    err_u = max(max_rel(u1, r1), max_rel(u0, r0))
    err_tr = max_rel(recs, rrec)
    say("main", f"vs Listing-1 reference ({ref_s:.1f} s): "
        f"max|du|/max|u_ref| {err_u:.3e}, max|dtrace|/max|trace_ref| "
        f"{err_tr:.3e} (limit {MAIN_TOL:g}); max|u_ref| "
        f"{float(r1.abs().max()):.4e}, max|trace_ref| "
        f"{float(rrec.abs().max()):.4e}")
    if not (err_u <= MAIN_TOL and err_tr <= MAIN_TOL):
        raise AssertionError(f"main path disagrees with the reference: "
                             f"{err_u:.3e}, {err_tr:.3e} > {MAIN_TOL}")
    del r0, r1, rrec

    torch.cuda.reset_peak_memory_stats()
    ms, _ = cuda_ms(run)
    peak = torch.cuda.max_memory_allocated() / 2 ** 30
    mpts = SHAPE[0] * SHAPE[1] * SHAPE[2] * nt / (ms * 1e-3) / 1e6
    say("main", f"TB run {ms:.1f} ms = {ms / launches:.3f} ms per time tile "
        f"= {ms / nt:.3f} ms per step, {mpts:.1f} Mpt*steps/s, peak "
        f"{peak:.2f} GiB [{smi}]")
    return (u0, u1), launches, ms


def phase_sb(fc, smi, tb_ms, dev, state):
    nt, dt = fc["nt"], fc["dt"]

    def run():
        return ops.acoustic_sb_propagate(
            nt, fc["u0"], fc["u1"], fc["m"], fc["damp"], fc["g"], fc["gr"],
            PLAN.tile, ORDER, dt, SPACING, executor="cuda", device=dev)

    run()                                      # warm-up
    ms, _ = cuda_ms(run)
    mpts = SHAPE[0] * SHAPE[1] * SHAPE[2] * nt / (ms * 1e-3) / 1e6
    say("sb", f"SB (T=1) run {ms:.1f} ms = {ms / nt:.3f} ms per step, "
        f"{mpts:.1f} Mpt*steps/s; TB/SB time ratio {tb_ms / ms:.3f} "
        f"(no gain claimed) [{smi}]")
    _, _, pieces = time_tile_pieces(TBPlan(PLAN.tile, 1, ORDER // 2), fc,
                                    state, nt // 2)
    say("sb", f"SB kernel alone {pieces[1]:.3f} ms per launch = "
        f"{100 * pieces[1] * nt / ms:.1f}% of the SB run")
    say_pieces("sb", "one SB step", pieces, ms / nt)


def phase_kernel_line(fc, state, launches, tb_ms):
    t0 = (fc["nt"] // PLAN.T // 2) * PLAN.T     # a mid-run tile, live state
    spec, args, pieces = time_tile_pieces(PLAN, fc, state, t0)
    ms = pieces[1]
    saved = ker.launches
    err = compare_kernel(spec, args)
    ker.launches = saved
    say_pieces("kernels", f"one depth-{PLAN.T} TB tile", pieces,
               tb_ms / launches)
    plain_ms, _ = cuda_ms(
        lambda: ker.tb_time_tile_plain(spec, phys.ACOUSTIC, *args))
    cost = ker.kernel_cost(spec)
    t_bytes = cost["min_bytes"] / HBM_BW * 1e3
    t_ops = cost["useful_flops"] / F32_PEAK * 1e3
    line = {"kernels": [{
        "name": "stencil_tb.tb_acoustic",
        "route": "cuda",
        "source": "src/repro_torch/kernels/csrc/stencil_tb.cu",
        "replaces": "src/repro/kernels/stencil_tb.py:129",
        "launches": launches,
        "max_abs_err": err,
        "ms": ms,
        "plain_ms": plain_ms,
        "bound_ms": max(t_bytes, t_ops),
        "bound_by": "bytes" if t_bytes >= t_ops else "operations",
        "library_ms": None,
    }]}
    say("kernels", f"tb_acoustic at {SHAPE} T={PLAN.T}: {ms:.3f} ms per "
        f"launch vs bound {max(t_bytes, t_ops):.3f} ms "
        f"({cost['min_bytes'] / 1e9:.2f} GB, "
        f"{cost['useful_flops'] / 1e9:.1f} GFLOP), plain {plain_ms:.1f} ms; "
        f"kernel = {100 * ms * launches / tb_ms:.1f}% of the TB run")
    print(json.dumps(line), flush=True)


def main():
    smi = phase_environment()
    dev = torch.device("cuda", 0)
    phase_build()
    phase_kernel_vs_plain(dev)
    fc = full_case(dev)
    state, launches, tb_ms = phase_main_path(fc, smi, dev)
    phase_sb(fc, smi, tb_ms, dev, state)
    phase_kernel_line(fc, state, launches, tb_ms)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)


if __name__ == "__main__":
    main()
