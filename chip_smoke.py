"""End-to-end check of the PyTorch/CUDA port on one NVIDIA card.

    python3 chip_smoke.py

Builds the port's CUDA kernels from `src/repro_torch/kernels/csrc/` (one
per physics: acoustic, TTI, elastic; and the SSD scan), holds each kernel
against its plain PyTorch version on small cases, one shot and a batch of
shots (the shot axis in the kernel's grid), then drives the port's three
main paths — temporally-blocked acoustic, TTI and elastic propagation with
an off-the-grid source and receivers, through `ops.acoustic_tb_propagate`,
`ops.tti_tb_propagate` and `ops.elastic_tb_propagate` — at the paper's full
size, checks each against the port's Listing-1 reference, and times it
beside its spatially-blocked baseline (T = 1).  Then it drives the
multi-shot survey engine (`survey.SurveyEngine.run`): 8 shots of the
512^3 acoustic paper case in 2 batches of 4, 3 shots of the 512^3 TTI
case in one batch at the bucket_cap the memory budget gives, and small
surveys of every physics through the plan cache's sweep, each checked
shot held against a sequential call.  Then the sharded path
(`distributed.halo`, kernel B1c): each kernel on sharded passes against
its plain version, the 512^3 acoustic case as a 2x2 mesh of shards on the
card against the single-device run, TTI and elastic at 256^3 and acoustic
schedules (time-nested, overlapped, uniform halo, autotuned) at 128^3, and
the survey engine's sharded route.  Then the language models: kernel B2
(the SSD chunked scan) against its plain version on both of its schedules
(tensor cores for bf16 inputs at mamba2-130m's head shape, float32 cores
for the rest, zamba2-2.7b's (N, P, Q) = (64, 64, 128) among them; each
line names the one that ran), and six models at their published widths
and depth, each serving 16 requests with random bf16 parameters from a
seed: through `serving.GenerationEngine` mamba2-130m (B2 counted, 24
launches a prefill), zamba2-2.7b (Mamba2 plus a shared attention block;
54 B2 launches a prefill), and with no TPU kernel on their paths the
dense qwen3-1.7b and qwen3-moe-30b-a3b (128 experts, top 8, the
sort-based capacity dispatch, its dropped entries counted); through
`launch.steps`, with their stub embeddings in the batch, whisper-medium
(24 + 24 layers over 1500 frames) and llava-next-mistral-7b (2880 image
positions before the text).  Each has a float32 batch: its prefill held
against the plain scan where the model scans, the MoE's layer against a
dense top-k oracle, and decode against the teacher-forced forward.  Then
the bf16 acoustic tile (B1a-bf16).  It prints one JSON line listing every
kernel and a final JSON status line.  It needs a card: without one it
exits non-zero before printing any result.  It imports neither JAX nor
the JAX package.

Phases (one line each): environment, build, kernel vs plain on small
cases (kernel-vs-plain, kernel-vs-plain-edges: a source on a trapezoid
boundary and a receiver on four tiles' corner, kernels-batched,
kernel-vs-plain-dom, kernel-vs-plain-bf16, kernel-vs-plain-ssd with
kernels-ssd, kernels-ssd-zamba2), serve-mamba2, serve-zamba2, serve-qwen3,
serve-qwen3moe, serve-whisper, serve-llava, then for each path: main path
at full size, spatially-blocked baseline, kernel timing (with its design:
the schedule the launch takes, registers, shared memory, blocks an SM,
achieved GB/s), the batched kernel at the main path's shapes (after
acoustic: sharded-acoustic and main-acoustic-bf16); then survey-acoustic,
survey-tti, survey-small, sharded-small-*, survey-sharded and the kernel
line.  Any failed check raises, and the script exits non-zero.
"""
import contextlib
import dataclasses
import json
import math
import re
import statistics
import subprocess
import sys
import time
from pathlib import Path

import numpy as np
import torch

sys.path.insert(0, str(Path(__file__).resolve().parent / "src"))

from repro_torch import configs  # noqa: E402
from repro_torch.configs import paper_stencil  # noqa: E402
from repro_torch.core import boundary, sources as S  # noqa: E402
from repro_torch.core.grid import Grid  # noqa: E402
from repro_torch.core.propagators import acoustic, elastic, tti  # noqa: E402
from repro_torch.core.temporal_blocking import (  # noqa: E402
    TBPlan, nested_pass_geometry, plan_for_physics)
from repro_torch.distributed import halo as H  # noqa: E402
from repro_torch.kernels import _build, ops, ref  # noqa: E402
from repro_torch.kernels import ssd_scan as ssd  # noqa: E402
from repro_torch.kernels import stencil_tb as ker  # noqa: E402
from repro_torch.kernels import tb_physics as phys  # noqa: E402
from repro_torch.launch import stencil_survey  # noqa: E402
from repro_torch.launch.mesh import ShardMesh  # noqa: E402
from repro_torch.launch.steps import (  # noqa: E402
    make_decode_step, make_prefill_step)
from repro_torch.models import api, moe  # noqa: E402
from repro_torch.models import layers as L  # noqa: E402
from repro_torch.serving import GenerationEngine, Request  # noqa: E402
from repro_torch.survey import (PlanCache, Shot,  # noqa: E402
                                SurveyEngine, bucket_shots,
                                cached_plan_hierarchy)

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
BF16_TC_PEAK = 989e12            # H100 SXM bf16 on the tensor cores, dense

# The paper's cases come from configs/paper_stencil.py (`full_case`): they
# share one grid, SHAPE, which a CPU rehearsal shrinks.  ORDER is the space
# order of the main-*, survey, sharded and small phases: the paper's lowest.
SHAPE = paper_stencil.PAPER_CASES[0].shape
ORDER = min(c.space_order for c in paper_stencil.PAPER_CASES)
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
        out = None                    # the last outputs go before the next
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

def small_case(name, shape, order, nsrc, nrec, seed, dev, points=None):
    """(state tuple, params dict, g, gr, dt) of a small random case.  The
    elastic moduli are in SI units and its velocities 0.01 randn / (rho vp),
    so every term of the velocity and stress updates moves its field by a
    visible fraction of the field's scale.  `points` = (sources,
    receivers), each (n, 3) in grid units, places them instead of the
    random draw."""
    grid = Grid(shape=shape, spacing=SMALL_SPACING)
    rng = np.random.RandomState(seed)
    vp = 1500.0 + 1000.0 * rng.rand(*shape)
    damp = boundary.damping_field(shape, 3, SMALL_SPACING, device=dev)
    dt = grid.cfl_dt(2500.0, order)
    ext = np.asarray(grid.extent)
    g = gr = None
    if nsrc:
        wav = S.ricker_wavelet(8, dt, 12.0, nsrc) + 0.1 * rng.randn(8, nsrc)
        src = 5.0 + rng.rand(nsrc, 3) * (ext - 10.0)
        rec = 5.0 + rng.rand(nrec, 3) * (ext - 10.0)
        if points is not None:
            src, rec = (np.asarray(q, float) * SMALL_SPACING[0]
                        for q in points)
        g = S.precompute(S.SparseOperator(src), grid, wav, device=dev)
        gr = S.precompute_receivers(S.SparseOperator(rec), grid,
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
    builds them (one shot: a shot axis of 1)."""
    spec, st, rt, ppads = ops.prepare_tiles(
        plan, physics, state[0], params, g, gr, order, dt, spacing)
    src_dcmp = g.src_dcmp[None] if g is not None else None
    pads, sc, sv, rc, rw = ops.tile_operands(
        spec, tuple(f[None] for f in state), src_dcmp, st, rt, t0)
    return spec, (pads, ppads, sc, sv, rc, rw)


def uncounted(fn):
    """fn() with the launch counters left as they were (launches made to
    time or compare a kernel are not main-path launches)."""
    saved = ker.launches, ssd.launches
    out = fn()
    ker.launches, ssd.launches = saved
    return out


# launches held against the plain version, by schedule (`schedules`)
COMPARED = {"first": 0, "z-streamed": 0}


# grids up to this many points hold every schedule against the plain
# version; larger ones (the 512^3 launches, whose two schedules' outputs
# and scratch would not fit the card together) only the one picked, which
# the main paths also hold to the Listing-1 reference end to end
EVERY_SCHEDULE_POINTS = 256 ** 3


def schedules(spec, physics):
    """The schedules the physics' kernel can run at `spec`, the one
    `stencil_tb.launch_plan` picks first: None for the first schedule,
    else a z-streamed (bx, by, shared bytes)."""
    chosen = ker.launch_plan(spec, physics)
    if spec.nx * spec.ny * spec.nz > EVERY_SCHEDULE_POINTS:
        return [chosen]
    if chosen is not None:
        return [chosen, None]
    try:
        return [None, ker.stream_plan(spec, physics)]
    except ValueError:                  # no sub-tile fits a block
        return [None]


@contextlib.contextmanager
def on_schedule(plan):
    """Launches made inside take schedule `plan`, whatever `launch_plan`
    would pick, so each schedule is held against the plain version."""
    chosen = ker.launch_plan
    ker.launch_plan = lambda spec, physics: plan
    try:
        yield
    finally:
        ker.launch_plan = chosen


def schedule_name(plan):
    return "first" if plan is None else "z-streamed"


def schedule_of(spec, physics):
    """The schedule a launch of `spec` takes, for the kernels line."""
    plan = ker.launch_plan(spec, physics)
    return ("first" if plan is None
            else f"z-streamed, sub-tile ({plan[0]}, {plan[1]})")


def compare_kernel(spec, physics, args, dom=None):
    """The kernel against the plain version on the same inputs, once on
    every schedule it has at this shape (`schedules`): (max|diff|, max
    over fields and receiver channels of max|diff| / max|plain|, each the
    worst over the schedules, the kernel's (fields, partials) on the
    schedule `launch_plan` picks, the plain version's ms: one call, by
    CUDA events).  The picked schedule launches before the plain version
    runs, so its scratch meets an unfragmented cache."""
    plans = schedules(spec, physics)
    atol = ATOL[physics.name]
    torch.cuda.empty_cache()        # a 512^3 launch's scratch is tens of GB

    def launch(plan):
        with on_schedule(plan):
            return uncounted(lambda: ker.tb_time_tile(spec, physics, *args,
                                                      dom=dom))

    picked = launch(plans[0])
    plain_ms, (pst, prec) = cuda_ms(lambda: ker.tb_time_tile_plain(
        spec, physics, *args, dom=dom))
    worst = worst_rel = 0.0
    for plan in plans:
        kst, krec = picked if plan is plans[0] else launch(plan)
        torch.cuda.synchronize()
        name = schedule_name(plan)
        pairs = [(f, k, q) for f, k, q in zip(physics.state_fields, kst,
                                              pst)]
        pairs += [(f"rec[{c}]", krec[..., c], prec[..., c])
                  for c in range(prec.shape[-1])]
        errs = [check_close(f"{physics.name} {f} ({name} schedule)", k, q,
                            atol) for f, k, q in pairs]
        worst = max(worst, max(e for e, _ in errs))
        worst_rel = max(worst_rel, max(r for _, r in errs))
        COMPARED[name] += 1
        del kst, krec, pairs
    return worst, worst_rel, picked, plain_ms


SMALL_CASES = [  # (T, tile, order, shape, sources)
    (1, (8, 8), 4, (16, 16, 40), True),
    (2, (16, 8), 2, (32, 16, 37), True),
    (3, (8, 8), 8, (16, 24, 33), True),
    (4, (16, 16), 4, (32, 32, 45), True),
    (4, (8, 8), 2, (24, 16, 64), True),
    (2, (16, 16), 8, (32, 32, 29), False),
    # the z-streamed schedule's edges (csrc/tb_stream.cuh): nz below the z
    # ring (order 8: 9 planes), the largest radius (order 16), H above the
    # tile (and a sub-tile), nz not a multiple of the 8-plane output
    # staging, T = 1 with it
    (2, (8, 8), 8, (16, 16, 3), True),
    (2, (8, 8), 16, (16, 16, 13), True),
    (4, (8, 8), 8, (16, 16, 20), True),
    (1, (16, 8), 4, (32, 16, 13), True),
]
# TTI and elastic (step radius = order): T in {1, 2, 4}, tiles (8, 8) and
# (16, 8), orders 2/4/8/16, nz not a multiple of 32, nz below the z taps'
# reach, H above the tile, one case without sources or receivers
SMALL_MP_CASES = [
    (1, (8, 8), 4, (16, 16, 40), True),
    (2, (16, 8), 2, (32, 16, 37), True),
    (4, (8, 8), 4, (16, 24, 33), True),
    (2, (8, 8), 8, (16, 16, 20), True),
    (4, (16, 8), 2, (32, 16, 64), True),
    (2, (16, 8), 4, (32, 16, 29), False),
    (2, (8, 8), 8, (16, 16, 3), True),
    (1, (8, 8), 16, (16, 16, 13), True),
]
EDGE_TILE = (8, 8)
EDGE_SHAPE = (24, 16, 13)


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
            err, rel, _, _ = compare_kernel(spec, physics, args)
            worst, worst_rel = max(worst, err), max(worst_rel, rel)
            say("kernel-vs-plain", f"{name} T={T} tile={tile} order={order} "
                f"shape={shape} sources={sources}: max|diff| {err:.3e}, "
                f"max|diff|/max|plain| {rel:.3e}")
        say("kernel-vs-plain", f"{name}: {len(cases)} cases within rtol "
            f"{RTOL} atol {ATOL[name]} and field rtol {FIELD_RTOL}; worst "
            f"max|diff| {worst:.3e}, max|diff|/max|plain| {worst_rel:.3e}")


def edge_points(physics, T, tile=EDGE_TILE):
    """(sources, receivers) in grid units: one source between two grid
    points in tile 0's halo, the inner one on the boundary of the region
    the first injection covers and the outer one just past it (skipped by
    the trapezoid: it cannot reach the centre), and a receiver whose
    footprint is the corner of four tiles' centres."""
    edge = tile[0] - 1 + (T - 1) * physics.step_radius(ORDER) + 0.5
    return ([[edge, 4.3, 6.4]],
            [[tile[0] - 0.5, tile[1] - 0.5, 5.2], [3.2, 9.7, 7.6]])


def phase_kernel_vs_plain_edges(dev):
    """The trapezoid's edges: the boundary source and the corner receiver
    for T = 2 and 3, each kernel against its plain version."""
    for name in ("acoustic", "tti", "elastic"):
        physics = phys.PHYSICS[name]
        for T in (2, 3):
            state, params, g, gr, dt = small_case(
                name, EDGE_SHAPE, ORDER, 1, 2, 50 + T, dev,
                points=edge_points(physics, T))
            plan = TBPlan(EDGE_TILE, T, physics.step_radius(ORDER))
            spec, args = kernel_inputs(physics, plan, state, params, g, gr,
                                       dt, 1, SMALL_SPACING)
            err, rel, (_, krec), _ = compare_kernel(spec, physics, args)
            if not float(krec.abs().max()) > 0:
                raise AssertionError(f"{name} T={T}: no receiver signal")
            say("kernel-vs-plain-edges", f"{name} T={T} tile={EDGE_TILE} "
                f"shape={EDGE_SHAPE}: source on the boundary of the first "
                f"injection's region (its neighbour point just outside), "
                f"receiver on four tiles' corner: max|diff| {err:.3e}, "
                f"max|diff|/max|plain| {rel:.3e}")


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
    case: paper_stencil.StencilCase
    physics: phys.TBPhysics
    order: int
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
            self.nt, self.state, self.params, self.g, self.gr, plan,
            self.order, self.dt, self.spacing, executor="cuda",
            device=self.state[0].device)
        return tuple(final), recs

    def reference(self):
        """The Listing-1 oracle: (final state tuple, traces)."""
        final, recs = PATHS[self.physics.name][2](
            self.nt, self.state, self.params, self.dt, self.spacing,
            self.order, g=self.g, receivers=self.gr,
            device=self.state[0].device)
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


def source_point(shape, x):
    """One off-the-grid source at x near the surface, in grid units:
    (1, 3)."""
    return np.array([[x, (shape[1] - 1) / 2.0 - 0.41, 21.13]])


def receiver_line(shape):
    """NREC off-the-grid receivers along x near the surface, in grid
    units: (NREC, 3)."""
    return np.stack([np.linspace(0.53, shape[0] - 1.53, NREC),
                     np.full(NREC, (shape[1] - 1) / 2.0 + 0.19),
                     np.full(NREC, 12.17)], axis=1)


def full_case(name, dev, shape=None, order=ORDER, time_ms=None):
    """The paper's case for `name` (acoustic, tti or elastic) at space
    order `order` (`paper_stencil.full_case`: 10 m spacing, 20 m for TTI,
    512 ms, a 10 Hz Ricker source, an `nbl=10` sponge) on SHAPE (or
    `shape`, and `time_ms` for a reduction): a two-layer vmin/vmax model,
    the CFL time step at that order (so nt grows with the order), one
    off-the-grid source and 512 off-the-grid receivers on a line, placed
    in grid units so each spacing sees the same geometry."""
    case = paper_stencil.full_case(name, order)
    if time_ms is not None:
        case = dataclasses.replace(case, time_ms=time_ms)
    physics = phys.PHYSICS[name]
    shape = SHAPE if shape is None else shape
    spacing = case.spacing
    h = spacing[0]
    grid = Grid(shape=shape, spacing=spacing)
    # TTI's fastest speed is vmax sqrt(1 + 2 eps) with eps up to 0.2
    vmin, vmax = case.vmin, case.vmax
    vfast = vmax * math.sqrt(1.0 + 2.0 * 0.2) if name == "tti" else vmax
    dt = grid.cfl_dt(vfast, order)
    nt = case.nt(dt)
    damp = boundary.damping_field(shape, case.nbl, spacing, device=dev)
    src = S.SparseOperator(source_point(shape, (shape[0] - 1) / 2.0 + 0.37)
                           * h)
    g = S.precompute(src, grid, S.ricker_wavelet(nt, dt, case.f0),
                     device=dev)
    gr = S.precompute_receivers(S.SparseOperator(receiver_line(shape) * h),
                                grid, device=dev)
    state = tuple(torch.zeros(shape, dtype=torch.float32, device=dev)
                  for _ in physics.state_fields)
    if name == "acoustic":
        params = {"m": _layered(shape, 1 / vmin ** 2, 1 / vmax ** 2, dev),
                  "damp": damp}
    elif name == "tti":
        params = {"m": _layered(shape, 1 / vmin ** 2, 1 / vmax ** 2, dev),
                  "damp": damp,
                  "epsilon": _layered(shape, 0.10, 0.20, dev),
                  "delta": _layered(shape, 0.05, 0.10, dev),
                  "theta": _smooth_angle(shape, dev, 1.0, 1.0),
                  "phi": _smooth_angle(shape, dev, 2.0, 0.5)}
    else:
        # SI units: lam = rho (vp^2 - 2 vs^2), mu = rho vs^2, b = 1 / rho
        rho = 2100.0
        vp = np.array([vmin, vmax])
        vs = vp / 1.9
        lam = rho * (vp ** 2 - 2 * vs ** 2)
        mu = rho * vs ** 2
        params = {"lam": _layered(shape, lam[0], lam[1], dev),
                  "mu": _layered(shape, mu[0], mu[1], dev),
                  "b": _layered(shape, 1 / rho, 1 / rho, dev),
                  "damp": damp}
    return FullCase(case, physics, order, spacing, nt, dt, state,
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
    # acoustic's run and reference stay for the sharded run to meet
    kept = (recs, rfinal, rrec) if name == "acoustic" else None
    del rfinal, rrec, recs

    torch.cuda.reset_peak_memory_stats()
    ms, _ = cuda_ms(lambda: fc.run(plan))
    peak = torch.cuda.max_memory_allocated() / 2 ** 30
    mpts = SHAPE[0] * SHAPE[1] * SHAPE[2] * nt / (ms * 1e-3) / 1e6
    say(f"main-{name}", f"TB run {ms:.1f} ms = {ms / launches:.3f} ms per "
        f"time tile = {ms / nt:.3f} ms per step, {mpts:.1f} Mpt*steps/s, "
        f"peak {peak:.2f} GiB [{smi}]")
    return final, launches, ms, kept, peak


def time_tile_pieces(fc, plan, state, t0):
    """Device ms of the three pieces of one main-path time tile at t0: its
    operands (zero-padded state, source values), the kernel alone (after a
    warm-up, the median of 3 means of 5 launches; the least and the most of
    the 3 are returned too), and the receivers' segment sum.
    Returns (spec, kernel args, (ms, ms, ms), (min ms, max ms))."""
    physics = fc.physics
    spec, st, rt, ppads = ops.prepare_tiles(
        plan, physics, state[0], fc.params._asdict(), fc.g, fc.gr, fc.order,
        fc.dt, fc.spacing)
    state = tuple(f[None] for f in state)               # one shot
    op_ms, (pads, sc, sv, rc, rw) = cuda_ms(
        lambda: ops.tile_operands(spec, state, fc.g.src_dcmp[None], st, rt,
                                  t0), reps=3)
    args = (pads, ppads, sc, sv, rc, rw)
    k_ms, lo, hi, rec_part = time_kernel(spec, physics, args)
    rec_ms, _ = cuda_ms(lambda: ops.combine_rec_partials(rec_part, rt, NREC),
                        reps=3)
    return spec, args, (op_ms, k_ms, rec_ms), (lo, hi)


def time_kernel(spec, physics, args, dom=None):
    """The kernel alone on `args`: after a warm-up, the median of 3 means of
    5 launches, the least and the most of the 3, and the launch's receiver
    partials.  The params' copies are made once beforehand
    (`stencil_tb.param_copies`), as every path makes them once a run."""
    copies = ker.param_copies(spec, physics, args[1])
    launch = lambda: ker.tb_time_tile(  # noqa: E731
        spec, physics, *args, dom=dom, param_copies=copies)
    rec_part = uncounted(launch)[1]                         # warm-up
    means = [uncounted(lambda: cuda_ms(launch, reps=5))[0]
             for _ in range(3)]
    return statistics.median(means), min(means), max(means), rec_part


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
    return ms


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
    err, rel, _, plain_ms = compare_kernel(spec, fc.physics, args)
    say_pieces(f"kernels-{name}", f"one depth-{T_TB} TB tile", pieces,
               tb_ms / launches)
    cost = ker.kernel_cost(spec, fc.physics)
    t_bytes = cost["min_bytes"] / HBM_BW * 1e3
    t_ops = cost["needed_flops"] / F32_PEAK * 1e3
    bound = max(t_bytes, t_ops)
    say(f"kernels-{name}", f"tb_{name} at {SHAPE} T={T_TB}: {ms:.3f} ms per "
        f"launch (median of 3 means of 5; least {lo:.3f}, most {hi:.3f}) "
        f"vs bound {bound:.3f} ms ({cost['min_bytes'] / 1e9:.2f} GB in "
        f"{t_bytes:.3f} ms; {cost['needed_flops'] / 1e9:.1f} GFLOP needed "
        f"in {t_ops:.3f} ms, of {cost['useful_flops'] / 1e9:.1f} GFLOP the "
        f"reference counts), {schedule_of(spec, fc.physics)} schedule, "
        f"plain {plain_ms:.1f} ms; kernel = "
        f"{100 * ms * launches / tb_ms:.1f}% of the TB run; max|diff| vs "
        f"plain {err:.3e}, max|diff|/max|plain| {rel:.3e} [{smi}]")
    say_design(f"kernels-{name}", fc.physics, spec, ms, cost)
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
        "schedule": schedule_of(spec, fc.physics),
    }


def ptxas_usage(log):
    """{mangled entry: (registers, static shared bytes, spill store bytes)}
    from nvcc's -Xptxas -v output."""
    out, cur, spill = {}, None, 0
    for ln in log.splitlines():
        if "Compiling entry function" in ln:
            cur, spill = ln.split("'")[1], 0
        elif "spill stores" in ln:
            spill = int(ln.split("bytes spill stores")[0].split(",")[-1])
        elif "Used" in ln and "registers" in ln and cur:
            regs = int(ln.split("Used")[1].split("registers")[0])
            smem = (int(ln.split("bytes smem")[0].split(",")[-1])
                    if "bytes smem" in ln else 0)
            out[cur] = (regs, smem, spill)
    return out


def say_design(phase, physics, spec, ms, cost):
    """The kernel's design at this launch's shape: the schedule
    `stencil_tb.launch_plan` picks, each instantiation of it at this
    radius (ptxas registers, static shared memory, spill stores; the
    plan's dynamic shared memory), blocks an SM, and the launch's
    achieved GB/s: the least bytes (`kernel_cost`) and the bytes its
    schedule moves by design (`stencil_tb.design_bytes`) over its time."""
    lib = KERNEL_FILES[physics.name]
    usage = ptxas_usage(_build.build_all([lib])[lib].log)
    plan = ker.launch_plan(spec, physics)
    bx, by, dyn = plan if plan is not None else (*spec.tile, 0)
    props = torch.cuda.get_device_properties(0)
    sm_smem = getattr(props, "shared_memory_per_multiprocessor", 233472)
    sm_regs = getattr(props, "regs_per_multiprocessor", 65536)
    sm_threads = getattr(props, "max_threads_per_multi_processor", 2048)
    threads = ker._STREAM_THREADS
    parts = []
    for entry, (regs, static, spill) in sorted(usage.items()):
        if (f"_kernelILi{spec.radius}E" not in entry
                or ("StreamArgs" in entry) != (plan is not None)):
            continue
        blocks = min(sm_smem // (dyn + static + 1024),
                     sm_regs // (regs * threads), sm_threads // threads)
        m = re.search(r"(tb_\w+?_kernel)ILi(\d+)ELb([01])E(\w*?)Ev", entry)
        kind = "bf16" if "bfloat16" in m.group(4) else "f32"
        parts.append(f"{m.group(1)}<R={m.group(2)}, DOM={m.group(3)}, "
                     f"{kind}>: {regs} registers, {spill} B spill stores, "
                     f"{dyn} + {static} B shared a block, {blocks} block(s) "
                     "an SM")
    design = ker.design_bytes(spec, physics)
    nblocks = (spec.nx // bx) * (spec.ny // by)
    what = ("first schedule, one block a tile" if plan is None else
            f"z-streamed schedule, sub-tile ({bx}, {by}) of tile "
            f"{spec.tile}")
    say(phase, f"design: {what}, {nblocks} blocks of {threads} threads; "
        + "; ".join(parts)
        + f"; achieved {cost['min_bytes'] / ms / 1e6:.0f} GB/s of least "
        f"bytes ({100 * cost['min_bytes'] / ms / 1e-3 / HBM_BW:.1f}% of "
        f"{HBM_BW / 1e12:.2f} TB/s), {design / ms / 1e6:.0f} GB/s of the "
        f"{design / 1e9:.2f} GB its schedule moves")


# ---------------------------------------------------------------------------
# The paper's other cases: every physics at space orders 8 and 12
# ---------------------------------------------------------------------------

# the TB plans tried in order (tile, T): the first whose propagation fits
# the card.  A smaller tile does not make a launch smaller here (each
# tile's window overhangs it by the same halo), so (16, 16) comes last.
PAPER_PLANS = (((32, 32), 4), ((32, 32), 2), ((16, 16), 2))
# device bytes a propagation may count on beyond `ops.propagation_bytes`
# (its tables, receiver partials and traces, the allocator's rounding)
PAPER_RESERVE = 2 * 2 ** 30


def paper_plan(fc):
    """(plan, [(tile, T, GiB) of the plans tried]): the first of
    PAPER_PLANS whose propagation (`ops.propagation_bytes`) fits this
    card's free memory less PAPER_RESERVE; raises if none does."""
    from repro_torch.survey.engine import free_device_bytes

    torch.cuda.empty_cache()
    free = free_device_bytes(fc.state[0].device)
    shape = tuple(fc.state[0].shape)
    # the case's state and params, already made, count in each `need`
    made = sum(f.numel() * f.element_size() for f in (*fc.state, *fc.params))
    tried = []
    for tile, T in PAPER_PLANS:
        plan = TBPlan(tile, T, fc.physics.step_radius(fc.order))
        need = ops.propagation_bytes(fc.physics, shape, fc.nt, plan,
                                     fc.order)
        tried.append((tile, T, need / 2 ** 30))
        if need + PAPER_RESERVE <= free + made:
            return plan, tried
    raise AssertionError(f"{fc.case.name}: no plan of {PAPER_PLANS} fits "
                         f"the card's {free / 2 ** 30:.2f} GiB free: " +
                         ", ".join(f"tile {t} T={d} {g:.2f} GiB"
                                   for t, d, g in tried))


def counted_run(fc, plan):
    """fc.run(plan) with the launch counter set to 0 just before and read
    just after, CUDA events around the run and around each launch: (final,
    recs, launches, run ms, ms of each full-depth launch, peak GiB)."""
    events = []

    def launch(spec, p, *args, **kw):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        out = ker.tb_time_tile(spec, p, *args, **kw)
        end.record()
        if spec.T == plan.T:
            events.append((start, end))
        return out

    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    ker.launches = 0
    ops.EXECUTORS["cuda"] = launch
    try:
        ms, (final, recs) = cuda_ms(lambda: fc.run(plan))
    finally:
        ops.EXECUTORS["cuda"] = ker.tb_time_tile
    launches = ker.launches
    peak = torch.cuda.max_memory_allocated() / 2 ** 30
    expect = -(-fc.nt // plan.T)
    if launches != expect:
        raise AssertionError(f"{fc.case.name} T={plan.T}: {launches} kernel "
                             f"launches, expected {expect}")
    per_launch = [a.elapsed_time(b) for a, b in events]
    return final, recs, launches, ms, per_launch, peak


def phase_paper_case(name, order, smi, dev):
    """One of the paper's cases beyond order 4 at its full width and depth:
    the Listing-1 reference once (kept on the host), then the TB run on
    the first plan of PAPER_PLANS that fits and the SB run (T = 1), once
    each through the entry point with the kernel counted, each held to
    the reference within MAIN_TOL on every field and receiver channel.
    Returns the case's record for the nine-case summary."""
    phase = f"paper-{name}-O{order}"
    fc = full_case(name, dev, order=order)
    plan, tried = paper_plan(fc)
    model = plan_for_physics(name, SHAPE[2], order,
                             tiles=(4, 8, 16, 32, 64, 128),
                             depths=(1, 2, 4, 8))[0]
    spec = ops.make_spec(SHAPE, plan, order, fc.dt, fc.spacing, 1, 1,
                         physics=fc.physics)
    say(phase, f"{fc.case.name}: {SHAPE} spacing {fc.spacing[0]:g} m "
        f"nt={fc.nt} dt={fc.dt:.6e}; plan tile {plan.tile} T={plan.T} "
        f"(halo {spec.halo}; propagation bytes by plan tried: "
        + ", ".join(f"tile {t} T={d} {g:.2f} GiB" for t, d, g in tried)
        + f"), {schedule_of(spec, fc.physics)} schedule; the plan model "
        f"(plan_for_physics, H100 figures) would pick tile {model.tile} "
        f"T={model.T}, not run")
    t0 = time.perf_counter()
    rfinal, rrec = fc.reference()
    rfinal = tuple(f.cpu() for f in rfinal)
    ref_s = time.perf_counter() - t0
    out = {"case": fc.case.name, "physics": name, "order": order,
           "nt": fc.nt, "tile": list(plan.tile), "T": plan.T,
           "schedule": schedule_of(spec, fc.physics),
           "model_plan": {"tile": list(model.tile), "T": model.T}}
    sb = TBPlan(TILE, 1, fc.physics.step_radius(order))
    for what, p in (("TB", plan), ("SB", sb)):
        final, recs, launches, ms, per_launch, peak = counted_run(fc, p)
        if not (all(torch.isfinite(f).all() for f in final)
                and torch.isfinite(recs).all()):
            raise AssertionError(f"{phase}: {what} non-finite values")
        errs, same = field_errors(fc.physics, (final, recs), (
            tuple(f.to(dev) for f in rfinal), rrec))
        del final, recs
        worst = check_errors(phase, errs, MAIN_TOL,
                             f"{what} vs the Listing-1 reference")
        pspec = ops.make_spec(SHAPE, p, order, fc.dt, fc.spacing, 1, 1,
                              physics=fc.physics)
        k_ms = statistics.median(per_launch)
        bound, by = bound_of(ker.kernel_cost(pspec, fc.physics))
        say(phase, f"{what} tile {p.tile} T={p.T} "
            f"({schedule_of(pspec, fc.physics)} schedule): {launches} "
            f"kernel launches, run {ms:.1f} ms = {ms / fc.nt:.3f} ms per "
            f"step (one run, after the reference); kernel {k_ms:.3f} ms per "
            f"depth-{p.T} launch (median of {len(per_launch)} in the run; "
            f"least {min(per_launch):.3f}, most {max(per_launch):.3f}) vs "
            f"bound {bound:.3f} ms by {by}; peak {peak:.2f} GiB; vs the "
            f"Listing-1 reference ({ref_s:.1f} s): " + ", ".join(
                f"{k} {v:.2e}" for k, v in errs.items())
            + f" (max {worst:.3e}, limit {MAIN_TOL:g}), bit-equal: {same} "
            f"[{smi}]")
        out[what] = {"ms": ms, "launches": launches, "kernel_ms": k_ms,
                     "bound_ms": bound, "bound_by": by, "peak_gib": peak,
                     "max_rel_err": worst, "bit_equal": same}
    out["TB/SB"] = out["TB"]["ms"] / out["SB"]["ms"]
    say(phase, f"TB/SB {out['TB/SB']:.3f} (no gain claimed) [{smi}]")
    del fc, rfinal, rrec
    torch.cuda.empty_cache()
    return out


PAPER_EXTRA = [(c.propagator, c.space_order) for c in
               paper_stencil.PAPER_CASES if c.space_order != ORDER]


# ---------------------------------------------------------------------------
# The batched kernel: B shots in one launch (the shot axis in the grid)
# ---------------------------------------------------------------------------

def batch_operands(physics, plan, order, dt, spacing, states, params,
                   sparse, t0):
    """(spec, kernel operands) of one batched time tile: shot b has state
    `states[b]` and (g, gr) `sparse[b]`, or None for a null shot (the
    previous shot's tables with zero source values, as the survey engine
    pads a batch); the params are shared.  The table caps are the most any
    shot needs, as the engine sizes them from its bucket key."""
    real = [sp for sp in sparse if sp is not None]
    src_cap = max(g.npts for g, _ in real)
    rec_cap = max(gr.indices.shape[0] * gr.indices.shape[1]
                  for _, gr in real)
    shape = tuple(states[0][0].shape)
    spec = ops.make_spec(shape, plan, order, dt, spacing, src_cap, rec_cap,
                         physics=physics)
    tabs, dcmps = [], []
    for sp in sparse:
        if sp is None:
            tabs.append(tabs[-1])
            dcmps.append(torch.zeros_like(dcmps[-1]))
            continue
        g, gr = sp
        tabs.append(ops.build_tables(spec, g, gr, params, physics,
                                     src_cap=src_cap, rec_cap=rec_cap))
        d = torch.zeros((g.nt, src_cap), dtype=g.src_dcmp.dtype,
                        device=g.src_dcmp.device)
        d[:, :g.npts] = g.src_dcmp
        dcmps.append(d)
    st = ops.stack_tables([t[0] for t in tabs])
    rt = ops.stack_tables([t[1] for t in tabs])
    pads, sc, sv, rc, rw = ops.tile_operands(
        spec, tuple(torch.stack(f) for f in zip(*states)),
        torch.stack(dcmps), st, rt, t0)
    ppads = tuple(ops.pad_xy(params[f], spec.halo, "edge")
                  for f in physics.param_fields)
    return spec, (pads, ppads, sc, sv, rc, rw)


def compare_batched(spec, physics, args):
    """The batched launch against the plain version (as `compare_kernel`)
    and against B single-shot launches of the same kernel: (max|diff|,
    max|diff|/max|plain|, whether every shot's fields and partials equal
    its single launch's bit for bit)."""
    err, rel, (kst, krec), _ = compare_kernel(spec, physics, args)
    pads, ppads, sc, sv, rc, rw = args
    same = True
    for b in range(krec.shape[0]):
        one = (tuple(p[b:b + 1] for p in pads), ppads, sc[b:b + 1],
               sv[b:b + 1], rc[b:b + 1], rw[b:b + 1])
        ost, orec = uncounted(lambda: ker.tb_time_tile(spec, physics, *one))
        same = same and torch.equal(orec, krec[b:b + 1]) and all(
            torch.equal(a, k[b:b + 1]) for a, k in zip(ost, kst))
        del ost, orec
    return err, rel, same


BATCHED_CASES = [  # (T, tile, order, shape, sources of each shot; 0: null)
    (2, (16, 8), 4, (32, 16, 37), (1, 2, 3)),
    (4, (8, 8), 2, (16, 24, 33), (3, 1, 0)),
]


def phase_kernels_batched(dev):
    for name in ("acoustic", "tti", "elastic"):
        physics = phys.PHYSICS[name]
        for i, (T, tile, order, shape, nsrcs) in enumerate(BATCHED_CASES):
            states, sparse, params = [], [], None
            for b, ns in enumerate(nsrcs):
                st, prm, g, gr, dt = small_case(name, shape, order,
                                                max(ns, 1), 4, 10 * i + b,
                                                dev)
                params = params or prm           # one model for the batch
                states.append(st)
                sparse.append((g, gr) if ns else None)
            plan = TBPlan(tile, T, physics.step_radius(order))
            spec, args = batch_operands(physics, plan, order, dt,
                                        SMALL_SPACING, states, params,
                                        sparse, 1)
            err, rel, same = compare_batched(spec, physics, args)
            say("kernels-batched", f"{name} B={len(nsrcs)} T={T} "
                f"tile={tile} order={order} shape={shape} sources per shot "
                f"{nsrcs} (0: null shot): max|diff| vs plain {err:.3e}, "
                f"max|diff|/max|plain| {rel:.3e} (field rtol {FIELD_RTOL});"
                f" equal to {len(nsrcs)} single-shot launches bit for bit: "
                f"{same}")


def phase_batched_main(fc, spec, args, smi):
    """The batched kernel on one mid-run tile at the main path's shapes."""
    name = fc.physics.name
    B = args[0][0].shape[0]
    ms, lo, hi, _ = time_kernel(spec, fc.physics, args)
    err, rel, same = compare_batched(spec, fc.physics, args)
    cost = ker.kernel_cost(spec, fc.physics, shots=B)
    say(f"kernels-batched-{name}", f"B={B} at {SHAPE} T={spec.T} "
        f"tile={spec.tile} (live state, and a shifted copy as a null shot):"
        f" {ms:.3f} ms per launch (median of 3 means of 5; least {lo:.3f}, "
        f"most {hi:.3f}), bound {bound_of(cost)[0]:.3f} ms, "
        f"{schedule_of(spec, fc.physics)} schedule; max|diff| vs "
        f"plain {err:.3e}, max|diff|/max|plain| {rel:.3e}; equal to {B} "
        f"single-shot launches bit for bit: {same} [{smi}]")


def bound_of(cost):
    """(bound ms, "bytes" | "operations") of a `kernel_cost`."""
    t_bytes = cost["min_bytes"] / HBM_BW * 1e3
    t_ops = cost["needed_flops"] / F32_PEAK * 1e3
    return max(t_bytes, t_ops), ("bytes" if t_bytes >= t_ops
                                 else "operations")


# ---------------------------------------------------------------------------
# The survey engine
# ---------------------------------------------------------------------------

SURVEY_SHOTS = 8
SURVEY_CAP = 4
SMALL_SURVEY_SHAPE = (128, 128, 128)     # a reduction of the paper's 512^3
# the reductions' depth (survey-small-*, sharded-small-*, survey-sharded):
# about half the paper's 512 ms, so the script with the nine paper cases
# keeps inside its time limit; 255 ms keeps a depth-3 remainder tile at
# order 4 and T = 4 (acoustic and elastic nt 199, TTI 118)
REDUCED_TIME_MS = 255.0
SMALL_SURVEY_SHOTS = 6
SMALL_SURVEY_CAP = 2
# candidate tiles of the small surveys' sweep: with no window cap the
# model's pick on a 128-wide grid would be one 128 x 128 tile per shot,
# too few blocks for the card
SMALL_SURVEY_TILES = (16, 32)


def batched_entry(engine, bucket, wavefields, smi, phase):
    """The kernels-line entry of the batched kernel, timed on one batch of
    `bucket` (a `ShotBucket` of the survey, padded with null shots as the
    engine pads it) at a mid-run tile; its state is the shots' final
    wavefields."""
    physics, B = engine.physics, engine.bucket_cap
    ex = engine._executable(bucket.key)
    spec = ex.spec
    preps = [engine._prep_shot(s, bucket.key, spec, ex.rspec)
             for s in bucket.shots[:B]]
    batch = engine._stack_batch(preps, B)
    fields = [wavefields[i] for i in bucket.indices[:B]]
    fields += [tuple(torch.zeros_like(f) for f in fields[0])] * (
        B - len(fields))
    t0 = (engine.nt // spec.T // 2) * spec.T
    pads, sc, sv, rc, rw = ops.tile_operands(
        spec, tuple(torch.stack(f) for f in zip(*fields)), batch.src_dcmp,
        batch.src_tab, batch.rec_tab, t0)
    del fields
    args = (pads, ex.param_pads, sc, sv, rc, rw)
    ms, lo, hi, _ = time_kernel(spec, physics, args)
    err, rel, _, plain_ms = compare_kernel(spec, physics, args)
    cost = ker.kernel_cost(spec, physics, shots=B)
    bound, by = bound_of(cost)
    single, _ = bound_of(ker.kernel_cost(spec, physics))
    say(phase, f"batched tb_{physics.name}, B={B} at {engine.shape} "
        f"T={spec.T} tile={spec.tile} ({schedule_of(spec, physics)} "
        f"schedule) caps ({spec.src_cap}, "
        f"{spec.rec_cap}): {ms:.3f} ms per launch (median of 3 means of 5; "
        f"least {lo:.3f}, most {hi:.3f}) vs bound {bound:.3f} ms by {by} "
        f"({cost['min_bytes'] / 1e9:.2f} GB, params read once; B x the "
        f"single-shot bound {B * single:.3f} ms), plain {plain_ms:.1f} ms; "
        f"max|diff| vs plain {err:.3e}, max|diff|/max|plain| {rel:.3e} "
        f"[{smi}]")
    return {
        "name": f"stencil_tb.tb_{physics.name} (shot-batched, B={B})",
        "route": "cuda",
        "source": f"src/repro_torch/kernels/csrc/"
                  f"{KERNEL_FILES[physics.name]}.cu",
        "replaces": "src/repro/kernels/stencil_tb.py:129",
        "launches": None,            # set from the survey's counted run
        "max_abs_err": err,
        "ms": ms,
        "plain_ms": plain_ms,
        "bound_ms": bound,
        "bound_by": by,
        "library_ms": None,
        "schedule": schedule_of(spec, physics),
    }


def survey_run(engine, shots, expect, phase, **kw):
    """`engine.run(shots)` with the launch counter set to 0 just before
    and read just after; raises unless it made `expect` launches."""
    ker.launches = 0
    res = engine.run(shots, **kw)
    torch.cuda.synchronize()
    launches = ker.launches
    if launches != expect:
        raise AssertionError(f"{phase}: the survey made {launches} kernel "
                             f"launches, expected {expect}")
    if not all(np.isfinite(t).all() for t in res.traces):
        raise AssertionError(f"{phase}: non-finite traces")
    return res, launches


def say_memory_budget(phase):
    """Per physics at the main paths' shapes and plans: the device bytes a
    survey batch needs (`survey.engine.batch_bytes`), and the largest
    bucket_cap this card holds beside the model and the zero state;
    returns those caps by physics."""
    from repro_torch.survey.engine import batch_bytes

    caps = {}
    total = torch.cuda.get_device_properties(0).total_memory
    for name, nt in (("acoustic", 399), ("tti", 236), ("elastic", 399)):
        physics = phys.PHYSICS[name]
        spec, rspec = (
            ops.make_spec(SHAPE, TBPlan(TILE, T, physics.step_radius(ORDER)),
                          ORDER, 1e-3, (10.0,) * 3, 1, 1, physics=physics)
            for T in (T_TB, nt % T_TB or T_TB))
        shared, per_shot = batch_bytes(physics, spec,
                                       rspec if nt % T_TB else None)
        model = (len(physics.param_fields) + len(physics.state_fields)) \
            * spec.nx * spec.ny * spec.nz * 4
        cap = caps[name] = (total - model - shared) // per_shot
        say(phase, f"memory budget, {name} {SHAPE} tile {TILE} T={T_TB}: "
            f"{per_shot / 1e9:.2f} GB a shot + {shared / 1e9:.2f} GB of "
            f"padded params + {model / 1e9:.2f} GB of model and zero state; "
            f"bucket_cap up to {cap} on this card's "
            f"{total / 1e9:.2f} GB")
    return caps


def say_plan_picks(phase):
    """What the plan model picks at the paper's depth with the H100's
    figures (its defaults), without a window cap and under the
    reference's 96 MiB one: it prices each window as read once per tile,
    which the port's kernels do not do, so its pick is not timed here."""
    for name in ("acoustic", "tti", "elastic"):
        picks = [plan_for_physics(name, SHAPE[2], ORDER,
                                  tiles=(4, 8, 16, 32, 64, 128),
                                  depths=(1, 2, 4, 8), vmem_budget=cap)[0]
                 for cap in (None, 96 * 2 ** 20)]
        say(phase, f"plan model, {name} nz={SHAPE[2]}: picks tile "
            f"{picks[0].tile} T={picks[0].T} with no window cap, tile "
            f"{picks[1].tile} T={picks[1].T} under 96 MiB")


def phase_survey_acoustic(smi, dev, tb_ms):
    """8 shots of the 512^3 acoustic paper case (a source stepping along x
    near the surface, the same 512 receivers) in 2 batches of 4."""
    fc = full_case("acoustic", dev)
    fc.state = None
    h = fc.spacing[0]
    grid = Grid(shape=SHAPE, spacing=fc.spacing)
    wav = S.ricker_wavelet(fc.nt, fc.dt, fc.case.f0)
    rec = receiver_line(SHAPE) * h
    shots = [Shot(src_coords=source_point(SHAPE, x) * h, wavelet=wav,
                  rec_coords=rec, shot_id=i)
             for i, x in enumerate(np.linspace(32.37, SHAPE[0] - 32.63,
                                               SURVEY_SHOTS))]
    plan = plan_for(fc.physics, T_TB)
    engine = SurveyEngine("acoustic", grid, fc.params._asdict(), fc.nt,
                          fc.dt, order=ORDER, plan=plan,
                          plan_cache=PlanCache(), bucket_cap=SURVEY_CAP,
                          device=dev)
    per_batch = -(-fc.nt // T_TB)
    expect = -(-SURVEY_SHOTS // SURVEY_CAP) * per_batch
    phase = "survey-acoustic"
    say_memory_budget(phase)
    say_plan_picks(phase)

    cold, launches = survey_run(engine, shots, expect, phase,
                                return_wavefields=True)
    s = cold.stats
    say(phase, f"cold run: {SURVEY_SHOTS} shots {SHAPE} nt={fc.nt} "
        f"plan {plan.to_dict()}: {s['buckets']} bucket(s) "
        f"{s['bucket_keys']}, {s['batches']} batches of {SURVEY_CAP}, "
        f"{launches} kernel launches; {s['seconds']:.3f} s, cold "
        f"{s['cold_seconds']:.3f} s (plan {s['plan_seconds']:.3f} s, first "
        f"dispatch {s['compile_seconds']:.3f} s), warm "
        f"{s['warm_seconds']:.3f} s")
    # shots 0 and 7 (one from each batch) against sequential calls
    worst = 0.0
    for i in (0, SURVEY_SHOTS - 1):
        final, rec = stencil_survey.sequential_shot(
            "acoustic", shots[i], grid, fc.params._asdict(), plan, ORDER,
            fc.dt, fc.nt, device=dev)
        errs = stencil_survey.channel_errors(cold.traces[i], rec.cpu().numpy())
        worst = max(worst, max(errs))
        same = all(torch.equal(a, b) for a, b in zip(cold.wavefields[i],
                                                     final))
        say(phase, f"shot {i} vs a sequential ops.acoustic_tb_propagate: "
            f"max|dtrace|/max|trace| {max(errs):.3e} (limit {FIELD_RTOL:g}),"
            f" final fields equal bit for bit: {same}")
        del final, rec
    if worst > FIELD_RTOL:
        raise AssertionError(f"{phase}: batched traces differ from the "
                             f"sequential ones by {worst:.3e}")
    entry = batched_entry(engine, next(iter(bucket_shots(shots).values())),
                          cold.wavefields, smi, "kernels-" + phase)
    cold_traces = cold.traces
    del cold
    torch.cuda.empty_cache()

    torch.cuda.reset_peak_memory_stats()
    warm, launches = survey_run(engine, shots, expect, phase)
    peak = torch.cuda.max_memory_allocated() / 2 ** 30
    s = warm.stats
    entry["launches"] = launches
    if set(s["traces_per_bucket"].values()) != {1} or \
            s["compile_seconds"] != 0.0:
        raise AssertionError(f"{phase}: rerun rebuilt a bucket: "
                             f"{s['traces_per_bucket']}, compile "
                             f"{s['compile_seconds']}")
    worst = max(max(stencil_survey.channel_errors(a, b))
                for a, b in zip(warm.traces, cold_traces))
    if worst > FIELD_RTOL:
        raise AssertionError(f"{phase}: warm traces differ from cold by "
                             f"{worst:.3e}")
    batch_ms = [b for b, _ in engine.batch_times]
    gaps = [g for _, g in engine.batch_times[1:]]
    per_launch = [b / per_batch for b in batch_ms]
    cost = ker.kernel_cost(engine._execs[(1, NREC)].spec, fc.physics,
                           shots=SURVEY_CAP)
    single, _ = bound_of(ker.kernel_cost(engine._execs[(1, NREC)].spec,
                                         fc.physics))
    say(phase, f"warm run: {launches} kernel launches, "
        f"{s['shots_per_s']:.4f} shots/s, {s['mpoints_per_s']:.1f} "
        f"Mpt*steps/s, {1e3 * s['warm_seconds'] / SURVEY_SHOTS:.1f} ms per "
        f"shot (main-acoustic TB run: {tb_ms:.1f} ms); {s['seconds']:.3f} "
        f"s, warm {s['warm_seconds']:.3f} s, compile "
        f"{s['compile_seconds']:.3f} s; traces_per_bucket "
        f"{s['traces_per_bucket']}; peak {peak:.2f} GiB [{smi}]")
    say(phase, "per batch (CUDA events): "
        + ", ".join(f"{b:.1f} ms = {p:.3f} ms per launch"
                    for b, p in zip(batch_ms, per_launch))
        + f" (bound {bound_of(cost)[0]:.3f} ms for {SURVEY_CAP} shots with "
        f"the params read once, {SURVEY_CAP} x the single-shot bound "
        f"{SURVEY_CAP * single:.3f} ms); device idle between batches "
        + ", ".join(f"{g:.3f} ms" for g in gaps) + f" [{smi}]")
    del warm, engine
    torch.cuda.empty_cache()
    return entry


SURVEY_TTI_SHOTS = 3


def phase_survey_tti(smi, dev, tb_ms):
    """3 shots of the 512^3 TTI paper case (a source stepping along x near
    the surface, the same 512 receivers) at the bucket_cap the memory
    budget gives (3 on an 80 GB card: one batch, 59 launches), after
    every phase that fragments the allocator's cache: a batch the engine
    admits must run.  Shot 0 against a sequential ops.tti_tb_propagate."""
    phase = "survey-tti"
    cap = say_memory_budget(phase)["tti"]
    fc = full_case("tti", dev)
    fc.state = None
    h = fc.spacing[0]
    grid = Grid(shape=SHAPE, spacing=fc.spacing)
    wav = S.ricker_wavelet(fc.nt, fc.dt, fc.case.f0)
    rec = receiver_line(SHAPE) * h
    shots = [Shot(src_coords=source_point(SHAPE, x) * h, wavelet=wav,
                  rec_coords=rec, shot_id=i)
             for i, x in enumerate(np.linspace(32.37, SHAPE[0] - 32.63,
                                               SURVEY_TTI_SHOTS))]
    plan = plan_for(fc.physics, T_TB)
    params = fc.params._asdict()
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    engine = SurveyEngine("tti", grid, params, fc.nt, fc.dt, order=ORDER,
                          plan=plan, plan_cache=PlanCache(), bucket_cap=cap,
                          device=dev)
    setup_s = time.perf_counter() - t0
    per_batch = -(-fc.nt // T_TB)
    expect = -(-SURVEY_TTI_SHOTS // cap) * per_batch
    res, launches = survey_run(engine, shots, expect, phase,
                               return_wavefields=True)
    peak = torch.cuda.max_memory_allocated() / 2 ** 30
    s = res.stats
    batch_ms = [b for b, _ in engine.batch_times]
    spec = engine._execs[(1, NREC)].spec
    bound, by = bound_of(ker.kernel_cost(spec, fc.physics, shots=cap))
    scratch_gib = engine._scratch.numel() / 2 ** 30
    kept = tuple(f.clone() for f in res.wavefields[0])
    trace = res.traces[0]
    del res, engine
    torch.cuda.empty_cache()
    final, rec_seq = stencil_survey.sequential_shot(
        "tti", shots[0], grid, params, plan, ORDER, fc.dt, fc.nt, device=dev)
    errs = stencil_survey.channel_errors(trace, rec_seq.cpu().numpy())
    ferr = max(max_rel(a, b) for a, b in zip(kept, final))
    same = all(torch.equal(a, b) for a, b in zip(kept, final))
    del final, rec_seq, kept
    if max(errs) > FIELD_RTOL or ferr > FIELD_RTOL:
        raise AssertionError(f"{phase}: shot 0 differs from a sequential "
                             f"call: traces {max(errs):.3e}, fields "
                             f"{ferr:.3e}")
    ms = sum(batch_ms)
    say(phase, f"{SURVEY_TTI_SHOTS} shots {SHAPE} nt={fc.nt} plan "
        f"{plan.to_dict()} at bucket_cap {cap} (the budget's): "
        f"{s['batches']} batch(es), {launches} kernel launches; engine "
        f"set-up {setup_s:.3f} s (scratch {scratch_gib:.2f} GiB made "
        f"once); {s['seconds']:.3f} s, {SURVEY_TTI_SHOTS / s['seconds']:.4f}"
        f" shots/s; device {ms:.1f} ms (CUDA events) = "
        f"{ms / SURVEY_TTI_SHOTS:.1f} ms a shot (main-tti TB run: "
        f"{tb_ms:.1f} ms), {ms / launches:.3f} ms per "
        f"batched launch vs bound {bound:.3f} ms by {by}; peak "
        f"{peak:.2f} GiB [{smi}]")
    say(phase, f"shot 0 vs a sequential ops.tti_tb_propagate: "
        f"max|dtrace|/max|trace| {max(errs):.3e}, max|dfield|/max|field| "
        f"{ferr:.3e} (limit {FIELD_RTOL:g}), final fields equal bit for "
        f"bit: {same}")
    del fc, params
    torch.cuda.empty_cache()


def phase_survey_small(smi, dev):
    """6 shots of mixed (nsrc, nrec) per physics at 128^3, bucket_cap 2,
    the plan from the plan cache's sweep; every shot against a sequential
    call.  Returns the TTI and elastic batched kernels' entries."""
    entries = []
    for name in ("acoustic", "tti", "elastic"):
        phase = f"survey-small-{name}"
        fc = full_case(name, dev, shape=SMALL_SURVEY_SHAPE,
                       time_ms=REDUCED_TIME_MS)
        fc.state = None
        grid = Grid(shape=SMALL_SURVEY_SHAPE, spacing=fc.spacing)
        shots = stencil_survey.build_survey(grid, fc.dt, fc.nt,
                                            SMALL_SURVEY_SHOTS,
                                            np.random.RandomState(0))
        cache = PlanCache()
        params = fc.params._asdict()
        engine = SurveyEngine(name, grid, params, fc.nt, fc.dt, order=ORDER,
                              plan_cache=cache, bucket_cap=SMALL_SURVEY_CAP,
                              plan_kwargs={"tiles": SMALL_SURVEY_TILES},
                              device=dev)
        buckets = bucket_shots(shots)
        ragged = sum(len(b) % SMALL_SURVEY_CAP != 0 for b in
                     buckets.values())
        nbatch = sum(-(-len(b) // SMALL_SURVEY_CAP) for b in buckets.values())
        expect = nbatch * -(-fc.nt // engine.plan.T)
        res, launches = survey_run(engine, shots, expect, phase,
                                   return_wavefields=True)
        s = res.stats
        if cache.sweeps != 1 or len(buckets) < 2 or not ragged or \
                set(s["traces_per_bucket"].values()) != {1}:
            raise AssertionError(f"{phase}: sweeps {cache.sweeps}, "
                                 f"{len(buckets)} buckets, {ragged} ragged "
                                 f"batches, {s['traces_per_bucket']}")
        worst = 0.0
        for i, shot in enumerate(shots):
            _, rec = stencil_survey.sequential_shot(
                name, shot, grid, params, engine.plan, ORDER, fc.dt, fc.nt,
                device=dev)
            worst = max(worst, max(stencil_survey.channel_errors(res.traces[i],
                                                rec.cpu().numpy())))
        if worst > FIELD_RTOL:
            raise AssertionError(f"{phase}: batched traces differ from the "
                                 f"sequential ones by {worst:.3e}")
        say(phase, f"{SMALL_SURVEY_SHOTS} shots {SMALL_SURVEY_SHAPE} "
            f"spacing {fc.spacing[0]:g} m nt={fc.nt}: plan "
            f"{engine.plan.to_dict()} from the sweep (sweeps "
            f"{cache.sweeps}, candidate tiles {SMALL_SURVEY_TILES}), "
            f"{len(buckets)} buckets {s['bucket_keys']}, {s['batches']} "
            f"batches of {SMALL_SURVEY_CAP} ({ragged} with a null shot), "
            f"{launches} kernel launches, traces_per_bucket "
            f"{s['traces_per_bucket']}; every shot vs a sequential call: "
            f"max|dtrace|/max|trace| {worst:.3e} (limit {FIELD_RTOL:g}); "
            f"warm {s['warm_seconds']:.3f} s, {s['shots_per_s']:.3f} "
            f"shots/s [{smi}]")
        if name != "acoustic":
            entry = batched_entry(engine, next(iter(buckets.values())),
                                  res.wavefields, smi, "kernels-" + phase)
            entry["launches"] = launches
            entries.append(entry)
        del res, engine, fc
        torch.cuda.empty_cache()
    return entries


# ---------------------------------------------------------------------------
# The sharded path (kernel B1c): a ShardMesh of shards on this card
# ---------------------------------------------------------------------------

MESH = (2, 2)
SHARDED_SMALL_SHAPE = (256, 256, 256)   # TTI, elastic: a reduction of 512^3
NESTED_SHAPE = (128, 128, 128)          # acoustic schedules: a reduction
DOM_SHAPE = (48, 48, 37)                # 24-point shard blocks
SHARDED_SURVEY_SHOTS = 2


def dist_plan(physics, shape, dt, spacing, dev, T=T_TB, tile=TILE,
              inner_T=None, order=ORDER, **kw):
    """A `DistTBPlan` of the 2x2 mesh on `dev` with the CUDA inner
    executor: exchange depth T, inner tile `tile`, inner depth `inner_T`
    (default T: the flat schedule)."""
    r = physics.step_radius(order)
    return H.DistTBPlan(
        mesh=ShardMesh(MESH, devices=(dev,)), grid_shape=tuple(shape),
        physics=physics, order=order, T=T, dt=dt, spacing=spacing,
        inner="cuda", inner_plan=TBPlan(tile, inner_T or T, r), **kw)


def expected_launches(plan, nt):
    """One launch a pass a time tile (all shards on one card), the
    remainder's passes included."""
    n_main, rem = divmod(nt, plan.T)
    r, tile = plan.r_step, plan.inner_tile

    def passes(T_depth):
        rest = T_depth - 1 if plan.overlap else T_depth
        return len(nested_pass_geometry(plan.block, tile, rest,
                                        min(plan.inner_T, T_depth,
                                            max(rest, 1)), r))
    return n_main * passes(plan.T) + (passes(rem) if rem else 0)


def expected_rounds(plan, nt):
    """Exchange rounds: the params once, then one a tile for every state
    field of nonzero depth (none for the remainder's params)."""
    n_main, rem = divmod(nt, plan.T)
    rounds = len(plan.physics.param_fields)
    rounds += n_main * sum(d > 0 for d in plan.field_depths(plan.T))
    if rem:
        rounds += sum(d > 0 for d in plan.field_depths(rem))
    return rounds


def sharded_run(plan, nt, state, params, g, gr, phase):
    """`sharded_tb_propagate` with the launch and exchange counters set to
    0 just before and read just after; raises unless they are what the
    plan needs."""
    ker.launches = 0
    plan.mesh.exchange_rounds = 0
    out = H.sharded_tb_propagate(plan, nt, state, params, g, gr)
    torch.cuda.synchronize()
    launches, rounds = ker.launches, plan.mesh.exchange_rounds
    want = (expected_launches(plan, nt), expected_rounds(plan, nt))
    if (launches, rounds) != want:
        raise AssertionError(f"{phase}: {launches} launches and {rounds} "
                             f"exchange rounds, expected {want}")
    return out, launches, rounds


def field_errors(physics, got, want):
    """max|diff| / max|want| per state field and per receiver channel,
    and whether everything is equal bit for bit."""
    (st, rec), (wst, wrec) = got, want
    rec, wrec = (r if r.dim() == 3 else r[..., None] for r in (rec, wrec))
    errs = {f: max_rel(a, b) for f, a, b in
            zip(physics.state_fields, st, wst)}
    errs.update({f"rec[{c}]": max_rel(rec[..., c], wrec[..., c])
                 for c in range(rec.shape[-1])})
    same = torch.equal(rec, wrec) and all(torch.equal(a, b)
                                          for a, b in zip(st, wst))
    return errs, same


def check_errors(phase, errs, limit, what):
    worst = max(errs.values())
    if not worst <= limit:
        raise AssertionError(f"{phase}: {what}: " + ", ".join(
            f"{k} {v:.3e}" for k, v in errs.items()) + f" > {limit:g}")
    return worst


def phase_kernel_vs_plain_dom(dev):
    """Kernel B1c on small sharded passes of a 2x2 mesh (4 shard rows a
    launch, each its own params and mask), every launch against the plain
    version: flat passes, time-nested passes (the first with d_out > 0
    on a grid rounded up to the tile, 24 + 2 * 4 to 36 for tile 12), the
    remainder depth.  Then the grid's own mask as `dom` against the
    single-device launch, bit for bit."""
    for name in ("acoustic", "tti", "elastic"):
        physics = phys.PHYSICS[name]
        T = 4 if name == "acoustic" else 2
        nt = 2 * T - 1              # a tile and a depth T - 1 remainder
        for i, nested in enumerate((False, True)):
            state, params, g, gr, dt = small_case(name, DOM_SHAPE, ORDER, 3,
                                                  4, 20 + i, dev)
            plan = dist_plan(physics, DOM_SHAPE, dt, SMALL_SPACING, dev, T=T,
                             tile=(12, 12) if nested else (24, 24),
                             inner_T=T // 2 if nested else T)
            seen = []

            def check(spec, p, *args, dom=None, param_copies=None):
                err, rel, out, _ = compare_kernel(spec, p, args, dom=dom)
                seen.append((spec.nx, spec.T, spec.ntiles, err, rel))
                return out

            ops.EXECUTORS["cuda"] = check
            try:
                H.sharded_tb_propagate(plan, nt, state, params, g, gr)
            finally:
                ops.EXECUTORS["cuda"] = ker.tb_time_tile
            if len(seen) != expected_launches(plan, nt):
                raise AssertionError(f"{name}: {len(seen)} passes")
            say("kernel-vs-plain-dom", f"{name} mesh {MESH} block (24, 24) "
                f"T={T} nt={nt} tile {plan.inner_tile} inner T "
                f"{plan.inner_T}: {len(seen)} launches of 4 shard rows, (grid,"
                " depth): " + ", ".join(f"({nx}, {t})" for nx, t, *_ in seen)
                + f"; worst max|diff| {max(e for *_, e, _ in seen):.3e}, "
                f"max|diff|/max|plain| {max(r for *_, r in seen):.3e} "
                f"(field rtol {FIELD_RTOL})")
        state, params, g, gr, dt = small_case(name, (32, 16, 29), ORDER, 3, 4,
                                              30, dev)
        plan = TBPlan((16, 8), 2, physics.step_radius(ORDER))
        spec, args = kernel_inputs(physics, plan, state, params, g, gr, dt,
                                   1, SMALL_SPACING)
        pads, ppads, sc, sv, rc, rw = args
        h = spec.halo
        gx = torch.arange(-h, spec.nx + h, device=dev)
        gy = torch.arange(-h, spec.ny + h, device=dev)
        dom = (((gx >= 0) & (gx < spec.nx))[:, None]
               & ((gy >= 0) & (gy < spec.ny))).float()[None].contiguous()
        a = uncounted(lambda: ker.tb_time_tile(spec, physics, *args))
        b = uncounted(lambda: ker.tb_time_tile(
            spec, physics, pads, tuple(q[None].contiguous() for q in ppads),
            sc, sv, rc, rw, dom=dom))
        torch.cuda.synchronize()
        same = torch.equal(a[1], b[1]) and all(
            torch.equal(x, y) for x, y in zip(a[0], b[0]))
        if not same:
            raise AssertionError(f"{name}: the grid's mask as dom differs "
                                 "from the grid predicate")
        say("kernel-vs-plain-dom", f"{name}: dom = the grid's mask, params "
            f"one a row: equal to the single-device launch bit for bit: "
            f"{same}")
        # B = 3 rows with dom: against the batched launch without it (bit
        # for bit) and the plain version
        T, tile, order, shape, nsrcs = BATCHED_CASES[0]
        states, sparse, params = [], [], None
        for i, ns in enumerate(nsrcs):
            st, prm, g, gr, dt = small_case(name, shape, order, ns, 4,
                                            60 + i, dev)
            params = params or prm
            states.append(st)
            sparse.append((g, gr))
        spec, args = batch_operands(
            physics, TBPlan(tile, T, physics.step_radius(order)), order, dt,
            SMALL_SPACING, states, params, sparse, 1)
        pads, ppads, sc, sv, rc, rw = args
        B, h = len(nsrcs), spec.halo
        gx = torch.arange(-h, spec.nx + h, device=dev)
        gy = torch.arange(-h, spec.ny + h, device=dev)
        dom = (((gx >= 0) & (gx < spec.nx))[:, None]
               & ((gy >= 0) & (gy < spec.ny))).float()
        dom = dom[None].expand(B, -1, -1).contiguous()
        rows = tuple(q[None].expand(B, *q.shape).contiguous() for q in ppads)
        a = uncounted(lambda: ker.tb_time_tile(spec, physics, *args))
        err, rel, b, _ = compare_kernel(
            spec, physics, (pads, rows, sc, sv, rc, rw), dom=dom)
        same = torch.equal(a[1], b[1]) and all(
            torch.equal(x, y) for x, y in zip(a[0], b[0]))
        if not same:
            raise AssertionError(f"{name}: B={B} with dom differs from the "
                                 "batched launch without it")
        say("kernel-vs-plain-dom", f"{name}: B={B} rows with dom (the grid's "
            f"mask) and params one a row: max|diff| vs plain {err:.3e}, "
            f"max|diff|/max|plain| {rel:.3e}; equal to the batched launch "
            f"without dom bit for bit: {same}")


def phase_sharded_acoustic(fc, smi, kept, tb_ms):
    """The 512^3 acoustic paper case as a 2x2 mesh of shards on this card,
    T=4, inner tile 32 (flat): against main-acoustic's single-device run
    (kept) and its Listing-1 reference; times, launches, exchange rounds,
    and kernel B1c on a mid-run pass.  Returns B1c's kernels-line entry."""
    phase = "sharded-acoustic"
    final, recs, rfinal, rrec = kept
    physics = fc.physics
    plan = dist_plan(physics, SHAPE, fc.dt, fc.spacing, fc.state[0].device)
    mid = (fc.nt // plan.T) // 2
    captured = []

    def capture(spec, p, *args, dom=None, param_copies=None):
        if len(captured) == mid:
            captured.append((spec, args, dom))
        else:
            captured.append(None)
        return ker.tb_time_tile(spec, p, *args, dom=dom,
                                param_copies=param_copies)

    ops.EXECUTORS["cuda"] = capture
    try:
        (st, rec), launches, rounds = sharded_run(
            plan, fc.nt, fc.state, fc.params._asdict(), fc.g, fc.gr, phase)
    finally:
        ops.EXECUTORS["cuda"] = ker.tb_time_tile
    errs, same = field_errors(physics, (st, rec), (final, recs))
    worst = check_errors(phase, errs, FIELD_RTOL, "vs the single-device run")
    rerrs, _ = field_errors(physics, (st, rec), (rfinal, rrec))
    rworst = check_errors(phase, rerrs, MAIN_TOL, "vs the Listing-1 "
                          "reference")
    if not all(torch.isfinite(f).all() for f in st):
        raise AssertionError(f"{phase}: non-finite fields")
    say(phase, f"{SHAPE} nt={fc.nt} on a {MESH} mesh of {plan.block} blocks "
        f"(one card), T={plan.T} tile {plan.inner_tile} flat, field depths "
        f"{plan.field_depths(plan.T)}: {launches} kernel launches (4 shard "
        f"rows each), {rounds} exchange rounds; vs the single-device TB run: "
        + ", ".join(f"{k} {v:.2e}" for k, v in errs.items())
        + f" (max {worst:.3e}, limit {FIELD_RTOL:g}), bit-equal: {same}; vs "
        f"the Listing-1 reference max {rworst:.3e} (limit {MAIN_TOL:g})")
    del st, rec, final, recs, rfinal, rrec, kept
    torch.cuda.empty_cache()

    torch.cuda.reset_peak_memory_stats()

    def run():
        return H.sharded_tb_propagate(plan, fc.nt, fc.state,
                                      fc.params._asdict(), fc.g, fc.gr)

    # cold: right after emptying the cache, so the allocator's cudaMalloc
    # calls fall inside it; then warm, as the main-* runs are timed
    cold_ms, out = cuda_ms(run)
    del out
    say(phase, f"cold run {cold_ms:.1f} ms (right after emptying the "
        f"allocator's cache: its device allocations inside) [{smi}]")
    ms, out = cuda_ms(run)
    peak = torch.cuda.max_memory_allocated() / 2 ** 30
    state = out[0]
    del out
    # one deep exchange of the state's fields, as a tile starts it
    blocks = [H._split_blocks(f, plan) for f in state]
    depths = plan.field_depths(plan.T)
    ex_ms, _ = cuda_ms(lambda: [H.exchange_to_depth(b, d, plan.halo)
                                for b, d in zip(blocks, depths)], reps=5)
    del blocks, state
    spec, args, dom = next(c for c in captured if c is not None)
    del captured
    k_ms, lo, hi, _ = time_kernel(spec, physics, args, dom=dom)
    err, rel, _, plain_ms = compare_kernel(spec, physics, args, dom=dom)
    rows = args[0][0].shape[0]
    seq_ms = 0.0
    for k in range(rows):
        one = (tuple(f[k:k + 1] for f in args[0]),
               tuple(f[k:k + 1] for f in args[1]),
               *(a[k:k + 1] for a in args[2:]))
        seq_ms += time_kernel(spec, physics, one, dom=dom[k:k + 1])[0]
    cost = ker.kernel_cost(spec, physics, shots=rows, shard_rows=True)
    bound, by = bound_of(cost)
    say(phase, f"warm run {ms:.1f} ms = {ms / launches:.3f} ms per time "
        f"tile (single-device TB run {tb_ms:.1f} ms), peak {peak:.2f} GiB; "
        f"one deep exchange (CUDA events, mean of 5) {ex_ms:.3f} ms a tile, "
        f"a device-local copy [{smi}]")
    say(phase, f"kernel B1c, {rows} shard rows at grid ({spec.nx}, "
        f"{spec.ny}, {spec.nz}) + halo {spec.halo}, tile {spec.tile}: "
        f"{k_ms:.3f} ms per launch (median of 3 means of 5; least {lo:.3f}, "
        f"most {hi:.3f}) vs bound {bound:.3f} ms by {by} "
        f"({cost['min_bytes'] / 1e9:.2f} GB); the {rows} rows as {rows} "
        f"sequential launches {seq_ms:.3f} ms; plain {plain_ms:.1f} ms; "
        f"kernel = {100 * k_ms * launches / ms:.1f}% of the run; max|diff| "
        f"vs plain {err:.3e}, max|diff|/max|plain| {rel:.3e} [{smi}]")
    return {
        "name": "stencil_tb.tb_acoustic (sharded pass: per-shard params "
                f"and domain mask, {rows} shard rows)",
        "route": "cuda",
        "source": "src/repro_torch/kernels/csrc/stencil_tb.cu",
        "replaces": "src/repro/kernels/stencil_tb.py:129",
        "launches": launches,
        "max_abs_err": err,
        "ms": k_ms,
        "plain_ms": plain_ms,
        "bound_ms": bound,
        "bound_by": by,
        "library_ms": None,
    }


def _against_single(phase, fc, single, plan, smi):
    """One sharded run of `fc` on `plan` against `single`, the
    single-device TB result; prints and returns its ms."""
    out, launches, rounds = sharded_run(plan, fc.nt, fc.state,
                                        fc.params._asdict(), fc.g, fc.gr,
                                        phase)
    errs, same = field_errors(fc.physics, out, single)
    worst = check_errors(phase, errs, FIELD_RTOL, "vs the single-device run")
    del out
    ms, _ = cuda_ms(lambda: H.sharded_tb_propagate(
        plan, fc.nt, fc.state, fc.params._asdict(), fc.g, fc.gr))
    say(phase, f"{tuple(fc.state[0].shape)} nt={fc.nt} mesh {MESH}, T="
        f"{plan.T} inner T {plan.inner_T} tile {plan.inner_tile} overlap "
        f"{plan.overlap} per-field halo {plan.per_field_halo}: {launches} "
        f"launches, {rounds} exchange rounds; vs the single-device TB run "
        f"max {worst:.3e} (limit {FIELD_RTOL:g}), bit-equal: {same}; run "
        f"{ms:.1f} ms [{smi}]")
    return ms


def phase_sharded_small(smi, dev):
    """TTI and elastic at 256^3 (a reduction of 512^3: the single-device
    512^3 paths already run) and the acoustic schedules at 128^3 on the
    2x2 mesh, each against its own single-device TB run."""
    for name in ("tti", "elastic"):
        fc = full_case(name, dev, shape=SHARDED_SMALL_SHAPE,
                       time_ms=REDUCED_TIME_MS)
        single = fc.run(plan_for(fc.physics, T_TB))
        single_ms, _ = cuda_ms(lambda: fc.run(plan_for(fc.physics, T_TB)))
        say(f"sharded-small-{name}", f"single-device TB run {single_ms:.1f} "
            f"ms")
        _against_single(f"sharded-small-{name}", fc, single,
                        dist_plan(fc.physics, SHARDED_SMALL_SHAPE, fc.dt,
                                  fc.spacing, dev), smi)
        del fc, single
        torch.cuda.empty_cache()
    fc = full_case("acoustic", dev, shape=NESTED_SHAPE,
                   time_ms=REDUCED_TIME_MS)
    single = fc.run(plan_for(fc.physics, T_TB))
    args = (fc.physics, NESTED_SHAPE, fc.dt, fc.spacing, dev)
    px, py = MESH
    block = (NESTED_SHAPE[0] // px, NESTED_SHAPE[1] // py)
    hier, entry, info = cached_plan_hierarchy(
        "acoustic", NESTED_SHAPE[2], ORDER, block, cache=PlanCache(),
        tiles=(16, 32, 64), depths=(1, 2, 4, 8))
    auto = H.dist_plan_from_hier(ShardMesh(MESH, devices=(dev,)),
                                 NESTED_SHAPE, fc.physics, ORDER, hier,
                                 fc.dt, fc.spacing, inner="cuda")
    say("sharded-small-acoustic", f"auto-plan (cached_plan_hierarchy, "
        f"{'hit' if info.hit else 'sweep'}): outer T {hier.outer_T}, inner "
        f"T {hier.inner.T}, tile {hier.inner.tile}, overlap {hier.overlap}, "
        f"field depths {hier.field_depths}; modelled cost "
        f"{entry['cost_s']:.3e} s per point-step")
    for what, plan in (("time-nested", dist_plan(*args, inner_T=2)),
                       ("overlap", dist_plan(*args, overlap=True)),
                       ("uniform halo", dist_plan(*args,
                                                  per_field_halo=False)),
                       ("nt % T = 3, remainder", dist_plan(*args)),
                       ("auto-plan", auto)):
        say("sharded-small-acoustic", f"{what}:")
        _against_single("sharded-small-acoustic", fc, single, plan, smi)
    del fc, single
    torch.cuda.empty_cache()


def phase_survey_sharded(smi, dev):
    """`SurveyEngine.run_sharded` for 2 shots at 128^3 on the 2x2 mesh
    against `run` (the batched single-device route)."""
    phase = "survey-sharded"
    fc = full_case("acoustic", dev, shape=NESTED_SHAPE,
                   time_ms=REDUCED_TIME_MS)
    h = fc.spacing[0]
    grid = Grid(shape=NESTED_SHAPE, spacing=fc.spacing)
    wav = S.ricker_wavelet(fc.nt, fc.dt, fc.case.f0)
    rec = receiver_line(NESTED_SHAPE) * h
    shots = [Shot(src_coords=source_point(NESTED_SHAPE, x) * h, wavelet=wav,
                  rec_coords=rec, shot_id=i)
             for i, x in enumerate((0.3 * NESTED_SHAPE[0] + 0.37,
                                    0.7 * NESTED_SHAPE[0] - 0.63))]
    engine = SurveyEngine("acoustic", grid, fc.params._asdict(), fc.nt,
                          fc.dt, order=ORDER, plan=plan_for(fc.physics, T_TB),
                          plan_cache=PlanCache(),
                          bucket_cap=SHARDED_SURVEY_SHOTS, device=dev)
    res = engine.run(shots)
    plan = dist_plan(fc.physics, NESTED_SHAPE, fc.dt, fc.spacing, dev)
    ker.launches = 0
    sres = engine.run_sharded(shots, plan)
    torch.cuda.synchronize()
    launches = ker.launches
    if launches != len(shots) * expected_launches(plan, fc.nt):
        raise AssertionError(f"{phase}: {launches} launches")
    worst = max(max(stencil_survey.channel_errors(a, b))
                for a, b in zip(sres.traces, res.traces))
    if not worst <= FIELD_RTOL:
        raise AssertionError(f"{phase}: sharded traces differ from run's by "
                             f"{worst:.3e}")
    s = sres.stats
    say(phase, f"{len(shots)} shots {NESTED_SHAPE} nt={fc.nt}: run_sharded "
        f"on mesh {s['mesh']} (outer T {s['outer_T']}, inner {s['inner']}) "
        f"{launches} launches, {s['seconds']:.3f} s, "
        f"{s['shots_per_s']:.3f} shots/s; run (batched, one card) "
        f"{res.stats['warm_seconds']:.3f} s warm; traces max|diff|/max|ref| "
        f"{worst:.3e} (limit {FIELD_RTOL:g}) [{smi}]")
    del res, sres, engine, fc
    torch.cuda.empty_cache()


# ---------------------------------------------------------------------------
# The bf16 acoustic tile (kernel B1a-bf16)
# ---------------------------------------------------------------------------

BF16 = torch.bfloat16


def bf16_bound(f32):
    """The reference's bf16 bound (tests/test_kernel_stencil_tb.py:119) from
    the float32 result: 0.1 max(max|f32|, 1e-3) + 1e-2."""
    return 0.1 * max(float(f32.abs().max()), 1e-3) + 1e-2


# bf16 kernel vs the plain bf16 version: both compute in float32 and round
# at the same stores, so they differ by rounding flips of a few bf16
# spacings (2^-8..2^-7 of a value); held per field and receiver channel
BF16_PLAIN_RTOL = 2 ** -6


def compare_bf16(spec, physics, args, args32):
    """The bf16 kernel on `args` against the plain bf16 version on them
    (max|diff| <= 2^-6 max|plain| per field and receiver channel) and the
    float32 kernel on `args32`, the same values in float32 (within the
    reference's bf16 bound of its result).  Returns (max|diff| / max|plain|
    vs plain, max|diff| vs float32, the least margin to the reference's
    bound: bound - diff, max|diff| vs plain)."""
    fst, frec = uncounted(lambda: ker.tb_time_tile(
        dataclasses.replace(spec, dtype=torch.float32), physics, *args32))
    pst, prec = ker.tb_time_tile_plain(spec, physics, *args)
    worst_p = worst_f = abs_p = 0.0
    margin = math.inf
    outs = []
    for plan in schedules(spec, physics):
        with on_schedule(plan):
            outs.append(uncounted(lambda: ker.tb_time_tile(spec, physics,
                                                           *args)))
        COMPARED[schedule_name(plan)] += 1
    torch.cuda.synchronize()
    for kst, krec in outs:
        for k, p, f in zip((*kst, krec), (*pst, prec), (*fst, frec)):
            if k.dtype != BF16 or not torch.isfinite(k.float()).all():
                raise AssertionError("bf16 kernel: wrong dtype or non-finite")
            chans = ((k[..., c], p[..., c])
                     for c in range(k.shape[-1])) if k is krec else ((k, p),)
            for kc, pc in chans:
                dp = float((kc.float() - pc.float()).abs().max())
                scale = float(pc.float().abs().max())
                if dp > BF16_PLAIN_RTOL * scale:
                    raise AssertionError(
                        f"bf16 kernel: max|diff| {dp:.3e} vs plain bf16 > "
                        f"2^-6 x max|plain| {scale:.3e}")
                worst_p = max(worst_p, dp / scale if scale else 0.0)
                abs_p = max(abs_p, dp)
            bound = bf16_bound(f)
            df = float((k.float() - f).abs().max())
            worst_f = max(worst_f, df)
            margin = min(margin, bound - df)
            if df > bound:
                raise AssertionError(f"bf16 kernel: max|diff| {df:.3e} vs "
                                     f"float32 > bound {bound:.3e}")
    return worst_p, worst_f, margin, abs_p


def to_bf16_args(args):
    """Kernel operands in bf16: fields, params, source values and receiver
    weights (coordinates stay int32)."""
    pads, ppads, sc, sv, rc, rw = args
    return (tuple(f.to(BF16) for f in pads), tuple(f.to(BF16) for f in ppads),
            sc, sv.to(BF16), rc, rw.to(BF16))


def phase_kernel_vs_plain_bf16(dev):
    """Kernel B1a-bf16 on the small acoustic cases, one shot and a batch."""
    physics = phys.ACOUSTIC
    worst = (0.0, 0.0, math.inf)
    for i, (T, tile, order, shape, sources) in enumerate(SMALL_CASES):
        state, params, g, gr, dt = small_case("acoustic", shape, order,
                                              3 if sources else 0, 4, i, dev)
        plan = TBPlan(tile, T, physics.step_radius(order))
        spec, args = kernel_inputs(physics, plan, state, params, g, gr, dt, 1,
                                   SMALL_SPACING, order=order)
        bspec = dataclasses.replace(spec, dtype=BF16)
        dp, df, margin, _ = compare_bf16(bspec, physics,
                                         to_bf16_args(args), args)
        worst = (max(worst[0], dp), max(worst[1], df), min(worst[2], margin))
        say("kernel-vs-plain-bf16", f"acoustic T={T} tile={tile} "
            f"order={order} shape={shape} sources={sources}: max|diff|/"
            f"max|plain| vs plain bf16 {dp:.3e} (limit 2^-6 per field and "
            f"channel), max|diff| vs float32 kernel {df:.3e} (bound 0.1 "
            f"max|f32| + 1e-2; least margin {margin:.3e})")
    T, tile, order, shape, nsrcs = BATCHED_CASES[0]
    states, sparse, params = [], [], None
    for b, ns in enumerate(nsrcs):
        st, prm, g, gr, dt = small_case("acoustic", shape, order, ns, 4,
                                        40 + b, dev)
        params = params or prm
        states.append(st)
        sparse.append((g, gr))
    spec, args = batch_operands(physics, TBPlan(tile, T, order // 2), order,
                                dt, SMALL_SPACING, states, params, sparse, 1)
    dp, df, margin, _ = compare_bf16(dataclasses.replace(spec, dtype=BF16),
                                     physics, to_bf16_args(args), args)
    say("kernel-vs-plain-bf16", f"acoustic B={len(nsrcs)} T={T} tile={tile}:"
        f" max|diff|/max|plain| vs plain bf16 {dp:.3e}, max|diff| vs "
        f"float32 kernel {df:.3e} (least margin {margin:.3e}); small cases "
        f"worst {worst[0]:.3e} / {worst[1]:.3e}, least margin "
        f"{worst[2]:.3e}")


def phase_main_bf16(fc, smi, final32, tb_ms):
    """The 512^3 acoustic paper case in bf16 through the entry point
    (ops.acoustic_tb_propagate with bf16 fields: kernel B1a-bf16), launches
    counted; then one mid-run tile of live state against the plain bf16
    version and the float32 kernel.  Returns the bf16 kernel's entry."""
    phase = "main-acoustic-bf16"
    plan = plan_for(fc.physics, T_TB)
    fcb = dataclasses.replace(
        fc, state=tuple(f.to(BF16) for f in fc.state),
        params=type(fc.params)(*(p.to(BF16) for p in fc.params)))
    ker.launches = 0
    final, recs = fcb.run(plan)
    torch.cuda.synchronize()
    launches = ker.launches
    expect = -(-fc.nt // T_TB)
    if launches != expect or final[0].dtype != BF16:
        raise AssertionError(f"{phase}: {launches} launches (expected "
                             f"{expect}), dtype {final[0].dtype}")
    if not (all(torch.isfinite(f.float()).all() for f in final)
            and torch.isfinite(recs.float()).all()):
        raise AssertionError(f"{phase}: non-finite values")
    drift = max(max_rel(a.float(), b) for a, b in zip(final, final32))
    del final, recs
    ms, _ = cuda_ms(lambda: fcb.run(plan))
    say(phase, f"{SHAPE} nt={fc.nt} T={T_TB} in bf16: {launches} kernel "
        f"launches, run {ms:.1f} ms (float32 {tb_ms:.1f} ms); final fields "
        f"max|d|/max|f32| vs the float32 run {drift:.3e} ({fc.nt} steps of "
        f"bf16 rounding; not held to a bound) [{smi}]")
    t0 = (fc.nt // T_TB // 2) * T_TB
    spec, args = kernel_inputs(fc.physics, plan, final32,
                               fc.params._asdict(), fc.g, fc.gr, fc.dt, t0,
                               fc.spacing)
    bspec = dataclasses.replace(spec, dtype=BF16)
    bargs = to_bf16_args(args)
    dp, df, margin, dp_abs = compare_bf16(bspec, fc.physics, bargs, args)
    del args
    k_ms, lo, hi, _ = time_kernel(bspec, fc.physics, bargs)
    plain_ms, _ = cuda_ms(lambda: ker.tb_time_tile_plain(bspec, fc.physics,
                                                         *bargs))
    cost = ker.kernel_cost(bspec, fc.physics)
    bound, by = bound_of(cost)
    say("kernel-vs-plain-bf16", f"tb_acoustic bf16 at {SHAPE} T={T_TB} "
        f"(mid-run live state): max|diff|/max|plain| vs plain bf16 "
        f"{dp:.3e} (limit 2^-6), max|diff| vs float32 kernel {df:.3e} "
        f"(least margin to 0.1 max|f32| + 1e-2: "
        f"{margin:.3e}); {k_ms:.3f} ms per launch (median of 3 means of 5; "
        f"least {lo:.3f}, most {hi:.3f}) vs bound {bound:.3f} ms by {by} "
        f"({cost['min_bytes'] / 1e9:.2f} GB), plain {plain_ms:.1f} ms "
        f"[{smi}]")
    return {
        "name": "stencil_tb.tb_acoustic (bf16)",
        "route": "cuda",
        "source": "src/repro_torch/kernels/csrc/stencil_tb.cu",
        "replaces": "src/repro/kernels/stencil_tb.py:129",
        "launches": launches,
        "max_abs_err": dp_abs,
        "ms": k_ms,
        "plain_ms": plain_ms,
        "bound_ms": bound,
        "bound_by": by,
        "library_ms": None,
    }


# ---------------------------------------------------------------------------
# Kernel B2 (the Mamba2 SSD chunked scan) and the Mamba2 serving path
# ---------------------------------------------------------------------------

SSD_RTOL, SSD_ATOL = 1e-4, 1e-5          # tests/test_kernel_ssd.py
SSD_FIELD_RTOL = 1e-5                    # max|diff| / max|plain|
# (B, S, H, G, N, P, Q): tests/test_kernel_ssd.py's shapes (B2's float32-core
# schedule), then mamba2-130m's head shape (N 128, P 64, Q 64: the
# tensor-core schedule with bf16 inputs) with one chunk and with two groups,
# mamba2-130m's serve shape (24 heads of 64, state 128, chunk 64; 8 x 1024)
# and zamba2-2.7b's (80 heads of 64, state 64, chunk 128: the float32-core
# schedule for both dtypes)
SERVE_SHAPE = (8, 1024, 24, 1, 128, 64, 64)
ZAMBA2_SSD_SHAPE = (8, 1024, 80, 1, 64, 64, 128)
SSD_CASES = [
    (2, 16, 4, 2, 8, 8, 4), (2, 32, 4, 2, 8, 8, 8), (2, 32, 4, 2, 8, 8, 32),
    (1, 16, 2, 1, 4, 4, 8), (2, 24, 6, 3, 5, 8, 4), (3, 8, 4, 4, 16, 16, 8),
    (2, 64, 4, 1, 128, 64, 64), (2, 256, 8, 2, 128, 64, 64),
    SERVE_SHAPE, ZAMBA2_SSD_SHAPE,
]


def ssd_case(shape, seed, dtype, with_h0, dev):
    """(spec, (x, dt, B, C, A), h0) drawn as tests/test_kernel_ssd.py
    draws: x, B, C in `dtype`; dt, A and h0 float32."""
    Bsz, S_, Hh, G, N, P, Q = shape
    gen = torch.Generator(device=dev).manual_seed(seed)

    def randn(*shp, dt=torch.float32):
        return torch.randn(shp, generator=gen, device=dev).to(dt)

    x = randn(Bsz, S_, Hh, P, dt=dtype)
    dtv = 0.1 + 0.5 * torch.rand((Bsz, S_, Hh), generator=gen, device=dev)
    Bm, Cm = randn(Bsz, S_, G, N, dt=dtype), randn(Bsz, S_, G, N, dt=dtype)
    A = -torch.exp(0.3 * randn(Hh))
    h0 = randn(Bsz, Hh, N, P) if with_h0 else None
    spec = ssd.SSDSpec(seq_len=S_, chunk=Q, nheads=Hh, ngroups=G, headdim=P,
                       state=N)
    return spec, (x, dtv, Bm, Cm, A), h0


def check_ssd(name, got, want):
    """(max|diff|, max|diff| / max|plain|, elements outside rtol 1e-4 /
    atol 1e-5) of a kernel output against its plain version; raises past
    rtol 1e-4 with atol 1e-5 x max(1, max|plain|) (as tests/test_torch_ssd.py
    scales it) or past max|diff| / max|plain| = 1e-5."""
    diff = (got - want).abs()
    err, scale = float(diff.max()), float(want.abs().max())
    outside = int((diff > SSD_ATOL + SSD_RTOL * want.abs()).sum())
    rel = err / scale if scale > 0 else (0.0 if err == 0 else math.inf)
    ok = bool((diff <= SSD_ATOL * max(1.0, scale)
               + SSD_RTOL * want.abs()).all())
    if not (ok and rel <= SSD_FIELD_RTOL):
        raise AssertionError(f"{name}: kernel B2 disagrees with its plain "
                             f"version: max|diff| {err:.3e}, max|diff|/"
                             f"max|plain| {rel:.3e}, {outside} elements "
                             f"outside rtol {SSD_RTOL} atol {SSD_ATOL}")
    return err, rel, outside


def ssd_design(spec, schedule):
    """B2's design at this shape on `schedule`: ptxas registers and spill
    stores of its float32-y kernel, dynamic shared memory a block, blocks
    an SM (the occupancy API), and waves over the card's SMs."""
    b = _build.build_all(["ssd_scan"])["ssd_scan"]
    lib = ssd._bind()
    sched = ssd.SCHEDULES.index(schedule)
    name = ("ssd_scan_tc_kernelIfE" if schedule == "tensor cores"
            else "ssd_scan_kernelI13__nv_bfloat16fE")
    regs, _, spill = next(v for k, v in ptxas_usage(b.log).items()
                          if name in k)
    smem = lib.repro_ssd_smem_bytes(spec.state, spec.headdim, spec.chunk,
                                    sched)
    per_sm = lib.repro_ssd_blocks_per_sm(0, spec.state, spec.headdim,
                                         spec.chunk, sched)
    return regs, spill, smem, per_sm


def phase_kernel_vs_plain_ssd(dev, smi):
    """Kernel B2 against ssd_scan_plain on the reference test's shapes and
    mamba2-130m's head shape (the serve phase's among them), float32 and
    bf16 inputs, h0 zero and given, each on the schedule
    `ssd.schedule_of` picks (each schedule on at least two shapes); then
    timed at the serve shapes (bf16 inputs, float32 y: block_forward's
    call) on the tensor-core schedule, and the float32-core schedule on
    the same inputs beside it.  Returns the kernels-line entry (launches
    set by serve-mamba2)."""
    worst = 0.0
    shapes = {name: set() for name in ssd.SCHEDULES}
    for shape in SSD_CASES:
        for dtype in (torch.float32, BF16):
            for with_h0 in (False, True):
                spec, args, h0 = ssd_case(shape, 7, dtype, with_h0, dev)
                schedule = ssd.schedule_of(spec, dtype)
                shapes[schedule].add(shape)
                y, h = uncounted(lambda: ssd.ssd_scan(spec, *args, h0=h0))
                py, ph = ssd.ssd_scan_plain(spec, *args, h0=h0)
                torch.cuda.synchronize()
                ey = check_ssd(f"y {shape}", y, py)
                eh = check_ssd(f"h_final {shape}", h, ph)
                worst = max(worst, ey[1], eh[1])
                say("kernel-vs-plain-ssd", f"(B,S,H,G,N,P,Q)={shape} "
                    f"{str(dtype)[6:]} inputs, h0 "
                    f"{'given' if with_h0 else 'zero'}, {schedule}: y "
                    f"max|diff| {ey[0]:.3e} (/max|plain| {ey[1]:.2e}, "
                    f"{ey[2]} outside rtol/atol), h_final {eh[0]:.3e} "
                    f"(/max|plain| {eh[1]:.2e}, {eh[2]} outside); bit-equal "
                    f"{torch.equal(y, py) and torch.equal(h, ph)}")
                del y, h, py, ph
    if min(len(v) for v in shapes.values()) < 2:
        raise AssertionError(f"kernel-vs-plain-ssd: a B2 schedule ran on "
                             f"fewer than two shapes: {shapes}")
    spec, args, h0 = ssd_case(SERVE_SHAPE, 7, BF16, False, dev)
    bspec = dataclasses.replace(spec, dtype=BF16)
    yb = uncounted(lambda: ssd.ssd_scan(bspec, *args))[0]
    py, _ = ssd.ssd_scan_plain(spec, *args)
    torch.cuda.synchronize()
    err_b = float((yb.float() - py).abs().max())
    ok = bool(((yb.float() - py).abs() <= 2 ** -8 * py.abs()
               + SSD_ATOL * max(1.0, float(py.abs().max()))).all())
    if not ok:
        raise AssertionError(f"bf16 y: {err_b:.3e} beyond one bf16 rounding")
    say("kernel-vs-plain-ssd", f"bf16 y at {SERVE_SHAPE} "
        f"({ssd.schedule_of(spec, BF16)}): within one bf16 rounding of the "
        f"plain float32 y (max|diff| {err_b:.3e})")
    del yb, py
    schedule = ssd.schedule_of(spec, BF16)
    launch = lambda: ssd.ssd_scan(spec, *args)  # noqa: E731
    err = check_ssd("y serve", uncounted(launch)[0],
                    ssd.ssd_scan_plain(spec, *args)[0])[0]

    def timed():
        means = [uncounted(lambda: cuda_ms(launch, reps=5))[0]
                 for _ in range(3)]
        return statistics.median(means), min(means), max(means)

    ms, lo, hi = timed()
    first = ssd.schedule_of
    ssd.schedule_of = lambda *a: "float32 cores"
    try:
        ms_f32, _, _ = timed()
    finally:
        ssd.schedule_of = first
    plain_ms, _ = cuda_ms(lambda: ssd.ssd_scan_plain(spec, *args))
    cost = ssd.kernel_cost(spec, SERVE_SHAPE[0], in_dtype=BF16)
    t_bytes = cost["min_bytes"] / HBM_BW * 1e3
    t_tc = cost["needed_flops"] / BF16_TC_PEAK * 1e3
    t_f32 = cost["needed_flops"] / F32_PEAK * 1e3
    bound, by = max(t_bytes, t_tc), ("bytes" if t_bytes >= t_tc
                                     else "operations")
    say("kernel-vs-plain-ssd", f"all cases within rtol {SSD_RTOL}, atol "
        f"{SSD_ATOL} x max(1, max|plain|) and max|diff|/max|plain| "
        f"{SSD_FIELD_RTOL} (worst {worst:.2e}); shapes by schedule: "
        + "; ".join(f"{k}: {sorted(v)}" for k, v in shapes.items()))
    say("kernels-ssd", f"ssd_scan at (B,S,H,G,N,P,Q)={SERVE_SHAPE}, bf16 "
        f"x/B/C, float32 y, {schedule} schedule: {ms:.3f} ms per launch "
        f"(median of 3 means of 5; least {lo:.3f}, most {hi:.3f}) vs bound "
        f"{bound:.4f} ms by {by} ({cost['min_bytes'] / 1e6:.1f} MB in "
        f"{t_bytes:.4f} ms; {cost['needed_flops'] / 1e9:.2f} GFLOP needed, "
        f"causal halves only, in {t_tc:.4f} ms at 989 TFLOP/s bf16 on the "
        f"tensor cores); the float32-core schedule's bound "
        f"{max(t_bytes, t_f32):.3f} ms (the same work in {t_f32:.3f} ms at "
        f"67 TFLOP/s); the float32-core schedule on the same inputs "
        f"{ms_f32:.3f} ms ({ms_f32 / ms:.2f}x); plain {plain_ms:.1f} ms; no "
        f"single PyTorch call computes a chunked scan, so no library time "
        f"[{smi}]")
    for name in ssd.SCHEDULES:
        regs, spill, smem, per_sm = ssd_design(spec, name)
        blocks = SERVE_SHAPE[0] * SERVE_SHAPE[2]
        sms = torch.cuda.get_device_properties(0).multi_processor_count
        say("kernels-ssd", f"design: {name} schedule, {blocks} blocks (one "
            f"a (batch, head)): {regs} registers, {spill} B spill stores, "
            f"{smem} B shared a block, {per_sm} block(s) an SM, "
            f"{blocks / (per_sm * sms):.2f} waves on {sms} SMs")
    return {
        "name": "ssd_scan.ssd_scan (Mamba2 SSD chunked scan), mamba2-130m's "
                "head shape",
        "route": "cuda",
        "source": "src/repro_torch/kernels/csrc/ssd_scan.cu",
        "replaces": "src/repro/kernels/ssd_scan.py:49",
        "launches": None,              # set from serve-mamba2's counted run
        "max_abs_err": err,
        "ms": ms,
        "plain_ms": plain_ms,
        "bound_ms": bound,
        "bound_by": by,
        "library_ms": None,
        "schedule": schedule,
        "float32_core_bound_ms": max(t_bytes, t_f32),
    }


def phase_kernels_ssd_zamba2(dev, smi):
    """Kernel B2 at zamba2-2.7b's serve shape (ZAMBA2_SSD_SHAPE; bf16
    x/B/C, float32 y: block_forward's call) on the schedule
    `ssd.schedule_of` picks (the float32-core one: the tensor-core schedule
    covers only (N, P, Q) = ssd.TC_SHAPE): held against ssd_scan_plain
    (its time is that call's), timed as the mamba2-130m shape is, its
    bound as `phase_kernel_vs_plain_ssd`'s: from `ssd.kernel_cost` at the
    card's rate for bf16 inputs (the tensor cores), whichever schedule
    runs, with the float32-core bound beside it; and a `design:` line.
    Returns the kernels-line entry (launches set by serve-zamba2)."""
    phase = "kernels-ssd-zamba2"
    shape = ZAMBA2_SSD_SHAPE
    spec, args, _ = ssd_case(shape, 7, BF16, False, dev)
    schedule = ssd.schedule_of(spec, BF16)
    launch = lambda: ssd.ssd_scan(spec, *args)  # noqa: E731
    plain_ms, (py, _) = cuda_ms(lambda: ssd.ssd_scan_plain(spec, *args))
    err = check_ssd(f"y {shape}", uncounted(launch)[0], py)[0]
    del py
    means = [uncounted(lambda: cuda_ms(launch, reps=5))[0]
             for _ in range(3)]
    ms = statistics.median(means)
    cost = ssd.kernel_cost(spec, shape[0], in_dtype=BF16)
    t_bytes = cost["min_bytes"] / HBM_BW * 1e3
    t_tc = cost["needed_flops"] / BF16_TC_PEAK * 1e3
    t_f32 = cost["needed_flops"] / F32_PEAK * 1e3
    bound, by = max(t_bytes, t_tc), ("bytes" if t_bytes >= t_tc
                                     else "operations")
    say(phase, f"ssd_scan at (B,S,H,G,N,P,Q)={shape} (zamba2-2.7b), bf16 "
        f"x/B/C, float32 y, {schedule} schedule: {ms:.3f} ms per launch "
        f"(median of 3 means of 5; least {min(means):.3f}, most "
        f"{max(means):.3f}) vs bound {bound:.4f} ms by {by} "
        f"({cost['min_bytes'] / 1e6:.1f} MB in {t_bytes:.4f} ms; "
        f"{cost['needed_flops'] / 1e9:.2f} GFLOP needed, causal halves "
        f"only, in {t_tc:.4f} ms at 989 TFLOP/s bf16 on the tensor cores); "
        f"the float32-core bound {max(t_bytes, t_f32):.3f} ms (the same "
        f"work in {t_f32:.3f} ms at 67 TFLOP/s); y max|diff| {err:.3e} "
        f"against plain ({plain_ms:.1f} ms); no "
        f"single PyTorch call computes a chunked scan, so no library time "
        f"[{smi}]")
    regs, spill, smem, per_sm = ssd_design(spec, schedule)
    blocks = shape[0] * shape[2]
    sms = torch.cuda.get_device_properties(0).multi_processor_count
    say(phase, f"design: {schedule} schedule at zamba2-2.7b's shape, "
        f"{blocks} blocks (one a (batch, head)): {regs} registers, {spill} "
        f"B spill stores, {smem} B shared a block, {per_sm} block(s) an SM, "
        f"{blocks / (per_sm * sms):.2f} waves on {sms} SMs")
    return {
        "name": "ssd_scan.ssd_scan (Mamba2 SSD chunked scan), zamba2-2.7b's "
                "head shape",
        "route": "cuda",
        "source": "src/repro_torch/kernels/csrc/ssd_scan.cu",
        "replaces": "src/repro/kernels/ssd_scan.py:49",
        "launches": None,              # set from serve-zamba2's counted run
        "max_abs_err": err,
        "ms": ms,
        "plain_ms": plain_ms,
        "bound_ms": bound,
        "bound_by": by,
        "library_ms": None,
        "schedule": schedule,
        "float32_core_bound_ms": max(t_bytes, t_f32),
    }


SERVE_SEED = 0
SERVE_REQUESTS = 16
SERVE_BATCH = 8
SERVE_NEW = 32
SERVE_PROMPT = (256, 1024)           # prompt lengths drawn in this range
# the stub families' text: whisper's decoder prompts (a few words of
# context) and llava's questions about an image, lengths drawn in these
# ranges; their embeddings: whisper's 30 s window of 1500 frames
# (max_source_positions), llava's anyres 5 x 576 image positions
STUB_PROMPT = {"encdec": (4, 64), "vlm": (32, 256)}
STUB_KEY = {"encdec": "frame_embeds", "vlm": "image_embeds"}


def stub_positions(cfg):
    """Stub embedding positions a request carries (0 for text-in
    families)."""
    return {"encdec": cfg.max_source_positions,
            "vlm": cfg.num_image_tokens}.get(cfg.family, 0)


def serve_max_len(cfg):
    """The cache capacity a serve phase asks for: the longest prompt (with
    llava's image positions) and the new tokens."""
    lo, hi = STUB_PROMPT.get(cfg.family, SERVE_PROMPT)
    return hi + SERVE_NEW + (cfg.num_image_tokens if cfg.family == "vlm"
                             else 0)


def timed_fn(fn, kind, events):
    """fn, each call bracketed by CUDA events appended to `events` as
    (kind, start, end)."""
    def call(*a):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        out = fn(*a)
        end.record()
        events.append((kind, start, end))
        return out
    return call


def timed_steps(engine, events):
    """Wrap the engine's step functions so each call is bracketed by CUDA
    events, appended to `events` as (kind, start, end)."""
    engine._prefill = timed_fn(engine._prefill, "prefill", events)
    engine._decode = timed_fn(engine._decode, "decode", events)


def with_plain_scan(fn):
    """fn() with the model's scan running `ssd_scan_plain` (the model
    itself never does)."""
    kernel = ssd.ssd_scan
    ssd.ssd_scan = ssd.ssd_scan_plain
    try:
        return fn()
    finally:
        ssd.ssd_scan = kernel


# the serve phases: one model each, at its published widths and depth
SERVE_ARCHS = {"serve-mamba2": "mamba2-130m", "serve-zamba2": "zamba2-2.7b",
               "serve-qwen3": "qwen3-1.7b",
               "serve-qwen3moe": "qwen3-moe-30b-a3b",
               "serve-whisper": "whisper-medium",
               "serve-llava": "llava-next-mistral-7b"}


def scan_layers(cfg):
    """B2 launches a prefill: one a Mamba2 layer (the ssm and hybrid
    families); the attention families run no TPU kernel's port (their
    attention, MoE and MLPs are plain PyTorch, as the reference computes
    them outside Pallas)."""
    return cfg.num_layers if cfg.family in ("ssm", "hybrid") else 0


def widths(cfg):
    """A config's widths, as the serve phases print them."""
    if cfg.num_heads:
        heads = (f"{cfg.num_heads} heads of {cfg.hd()} "
                 f"({cfg.num_kv_heads} kv)"
                 + (", qk-norm" if cfg.qk_norm else ""))
    if cfg.family == "moe":
        out = (f"{cfg.num_layers} layers, d_model {cfg.d_model}, {heads}, "
               f"{cfg.num_experts} experts, top-{cfg.experts_per_tok}, "
               f"d_ff {cfg.moe_d_ff}")
    elif cfg.family == "encdec":
        out = (f"{cfg.num_layers} + {cfg.num_decoder_layers} layers, "
               f"d_model {cfg.d_model}, {heads}, d_ff {cfg.d_ff}, "
               f"{cfg.max_source_positions} frames")
    elif cfg.family in ("dense", "vlm"):
        out = (f"{cfg.num_layers} layers, d_model {cfg.d_model}, {heads}, "
               f"d_ff {cfg.d_ff}")
        if cfg.family == "vlm":
            out += f", {cfg.num_image_tokens} image positions"
    else:
        d_inner = cfg.ssm_expand * cfg.d_model
        out = (f"{cfg.num_layers} layers, d_model {cfg.d_model}, "
               f"{d_inner // cfg.ssm_headdim} SSD heads of {cfg.ssm_headdim}"
               f", state {cfg.ssm_state}, chunk {cfg.ssm_chunk}")
        if cfg.family == "hybrid":
            out += (f", {cfg.num_layers // cfg.shared_attn_every} "
                    f"shared-attention applications of {cfg.num_heads} "
                    f"heads of {cfg.hd()}")
    return out + f", vocab {cfg.vocab_size}"


# whisper's parameters a decode step does not read (the encoder ran at
# prefill) or only gathers rows of (the decoder positions)
DECODE_UNREAD = {"encdec": ("enc_blocks", "enc_pos", "enc_final_norm",
                            "dec_pos")}


def decode_weight_bytes(params, cfg):
    """Bytes of the parameters a decode step reads: all of them, but the
    embedding table when it is not tied (a step gathers B of its rows) and
    `DECODE_UNREAD`.  The MoE's capacity dispatch runs every expert on its
    C slots, so a step reads every expert's weights."""
    unread = DECODE_UNREAD.get(cfg.family, ())
    leaves, stack = [], [{k: v for k, v in params.items()
                          if k not in unread}]
    while stack:
        node = stack.pop()
        for v in node.values():
            (stack if isinstance(v, dict) else leaves).append(v)
    total = sum(t.numel() * t.element_size() for t in leaves)
    if not cfg.tie_embeddings:
        emb = params["embed"]["embedding"]
        total -= emb.numel() * emb.element_size()
    return total


@contextlib.contextmanager
def counting_drops(records):
    """Within, every MoE dispatch appends (entries, C, dropped entries as a
    device tensor) to `records` (no read-back to the host)."""
    dispatch = moe.dispatch

    def counted(cfg, x2d, expert_idx, weights, C):
        d = dispatch(cfg, x2d, expert_idx, weights, C)
        records.append((d.keep.numel(), C, (~d.keep).sum()))
        return d

    moe.dispatch = counted
    try:
        yield
    finally:
        moe.dispatch = dispatch


def say_drops(phase, cfg, per_batch_calls):
    """The dropped (token, choice) entries of each prefill (its first
    num_layers dispatches: the first is layer 0's, the last the last
    layer's) and of the batches' decode steps."""
    parts = []
    for calls in per_batch_calls:
        pre, dec = calls[:cfg.num_layers], calls[cfg.num_layers:]
        for what, rs in (("prefill", pre), ("decode", dec)):
            n = sum(r[0] for r in rs)
            dropped = sum(int(r[2]) for r in rs)
            parts.append(f"{what} {dropped} of {n} ({dropped / n:.4%}, "
                         f"C {rs[0][1]} over {len(rs)} dispatches of "
                         f"{rs[0][0]} entries; first / last dispatch "
                         + " / ".join(f"{int(r[2]) / r[0]:.2%}"
                                      for r in (rs[0], rs[-1])) + ")")
    say(phase, "MoE dropped (token, choice) entries per batch: "
        + "; ".join(parts))


def stub_batches(cfg, dev):
    """SERVE_REQUESTS requests of a stub family in batches of SERVE_BATCH,
    each batch in `models.api`'s layout: text prompts (STUB_PROMPT
    lengths, drawn from SERVE_SEED) left-padded with token 0 as the engine
    pads, and random bf16 stub embeddings of `stub_positions` a request.
    Returns (batches, each batch's prompt lengths)."""
    rng = np.random.RandomState(SERVE_SEED)
    gen = torch.Generator(device=dev).manual_seed(SERVE_SEED)
    lo, hi = STUB_PROMPT[cfg.family]
    batches, lengths = [], []
    for _ in range(0, SERVE_REQUESTS, SERVE_BATCH):
        prompts = [rng.randint(0, cfg.vocab_size, size=rng.randint(
            lo, hi + 1)).astype(np.int32) for _ in range(SERVE_BATCH)]
        plen = max(len(p) for p in prompts)
        toks = np.zeros((SERVE_BATCH, plen), np.int32)
        for i, p in enumerate(prompts):
            toks[i, plen - len(p):] = p
        emb = torch.randn((SERVE_BATCH, stub_positions(cfg), cfg.d_model),
                          generator=gen, device=dev).to(torch.bfloat16)
        batches.append({"tokens": torch.as_tensor(toks, device=dev),
                        STUB_KEY[cfg.family]: emb})
        lengths.append([len(p) for p in prompts])
    return batches, lengths


def stub_generate(prefill, decode, params, batch, n_new):
    """Greedy generation through the step functions, as the engine runs
    them: (B, n_new) tokens on the host."""
    tok, cache = prefill(params, batch)
    outs = [tok]
    for _ in range(n_new - 1):
        tok, cache = decode(params, tok, cache)
        outs.append(tok)
    return torch.cat(outs, dim=1).cpu().numpy()


def phase_serve(phase, dev, smi, entry):
    """SERVE_ARCHS[phase] at its published widths and depth on the card,
    random bf16 parameters from SERVE_SEED, 16 requests in 2 batches of 8,
    32 new tokens each.  The text-in families go through
    serving.GenerationEngine with prompts of 256-1024 tokens; whisper and
    llava through `launch.steps`' prefill and decode steps with their stub
    embeddings in the batch (`stub_batches`).  B2 counted (`scan_layers`
    launches a prefill: 24 for mamba2-130m, 54 for zamba2-2.7b, none for
    the others); the MoE's dropped entries counted.  Then one batch in
    float32 (`serve_f32_checks`).  `entry` (B2's kernels-line entry at
    this model's head shape, or None) gets the launches."""
    arch = SERVE_ARCHS[phase]
    cfg = configs.get(arch)
    t0 = time.perf_counter()
    params = api.init(SERVE_SEED, cfg, device=dev)
    torch.cuda.synchronize()
    init_s = time.perf_counter() - t0
    max_len = serve_max_len(cfg)
    events = []
    if cfg.family in STUB_KEY:
        batches, lengths = stub_batches(cfg, dev)
        prefill = timed_fn(make_prefill_step(cfg, max_len), "prefill",
                           events)
        decode = timed_fn(make_decode_step(cfg), "decode", events)

        def generate(batch):
            return stub_generate(prefill, decode, params, batch, SERVE_NEW)

        # warm-up: the first batch, 4 new tokens (cuBLAS handles)
        uncounted(lambda: stub_generate(prefill, decode, params, batches[0],
                                        4))
        first = batches[0]
    else:
        engine = GenerationEngine(params, cfg, max_len=max_len,
                                  batch_size=SERVE_BATCH, device=dev)
        rng = np.random.RandomState(SERVE_SEED)
        reqs = [Request(prompt=rng.randint(0, cfg.vocab_size, size=rng.randint(
            SERVE_PROMPT[0], SERVE_PROMPT[1] + 1)).astype(np.int32),
            max_new_tokens=SERVE_NEW) for _ in range(SERVE_REQUESTS)]
        batches = [reqs[i:i + SERVE_BATCH]
                   for i in range(0, SERVE_REQUESTS, SERVE_BATCH)]
        lengths = [[len(r.prompt) for r in b] for b in batches]

        def generate(batch):
            return np.stack([r.output for r in engine.generate(batch)])

        # warm-up: a short batch (cuBLAS handles, the kernel's library)
        uncounted(lambda: engine.generate([Request(prompt=r.prompt[:64],
                                                   max_new_tokens=4)
                                           for r in batches[0]]))
        timed_steps(engine, events)
        first = {"tokens": engine._make_batch(batches[0])}
    events.clear()
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    ssd.launches = 0
    walls, per_batch, outs, drops = [], [], [], []
    t_all = time.perf_counter()
    with counting_drops(drops):
        for batch in batches:
            before, calls = ssd.launches, len(drops)
            t0 = time.perf_counter()
            outs.append(generate(batch))      # ends in a copy to the host
            walls.append(time.perf_counter() - t0)
            per_batch.append((ssd.launches - before, drops[calls:]))
    wall = time.perf_counter() - t_all
    launches = ssd.launches
    peak = torch.cuda.max_memory_allocated() / 2 ** 30
    scans = [n for n, _ in per_batch]
    if scans != [scan_layers(cfg)] * len(batches):
        raise AssertionError(f"{phase}: B2 launches per prefill {scans}, "
                             f"expected {scan_layers(cfg)}")
    for out in outs:
        if out.shape != (SERVE_BATCH, SERVE_NEW) or not np.all(
                (out >= 0) & (out < cfg.vocab_size)):
            raise AssertionError(f"{phase}: output {out} out of range")
    torch.cuda.synchronize()
    pre = [s.elapsed_time(e) for k, s, e in events if k == "prefill"]
    dec = [s.elapsed_time(e) for k, s, e in events if k == "decode"]
    tokens = SERVE_REQUESTS * SERVE_NEW
    plens = [max(ls) for ls in lengths]
    stub = stub_positions(cfg)
    stub_say = (f", each with {stub} {STUB_KEY[cfg.family]} positions"
                if stub else "")
    say(phase, f"{arch} ({widths(cfg)}, bf16, "
        f"{cfg.param_count() / 1e6:.1f} M parameters, init {init_s:.2f} s): "
        f"{SERVE_REQUESTS} requests in {len(batches)} batches of "
        f"{SERVE_BATCH}, padded prompt lengths {plens}{stub_say}, "
        f"{SERVE_NEW} new tokens each; B2 launches per prefill {scans} "
        f"({launches} in all)")
    read = decode_weight_bytes(params, cfg)
    say(phase, f"prefill ms per batch (CUDA events) "
        + ", ".join(f"{p:.2f}" for p in pre)
        + f"; decode {statistics.mean(dec):.3f} ms per token step (mean of "
        f"{len(dec)}; batch of {SERVE_BATCH}; bound by the weights' bytes a "
        f"step, {read / 1e9:.2f} GB at {HBM_BW / 1e12:.2f} TB/s: "
        f"{read / HBM_BW * 1e3:.3f} ms); wall {wall:.3f} s "
        f"(per batch " + ", ".join(f"{w:.3f}" for w in walls)
        + f" s), {tokens / wall:.1f} generated tok/s; prompt + generated "
        f"{(sum(plens) * SERVE_BATCH + tokens) / wall:.0f} tok/s; peak "
        f"{peak:.2f} GiB [{smi}]")
    if cfg.family == "moe":
        say_drops(phase, cfg, [calls for _, calls in per_batch])
    if entry is not None:
        entry["launches"] = launches
    logits, _ = uncounted(lambda: api.prefill(params, cfg, first, max_len))
    if not torch.isfinite(logits).all():
        raise AssertionError(f"{phase}: non-finite bf16 prefill logits")
    del logits, params, generate, batches
    if cfg.family not in STUB_KEY:
        del engine
    torch.cuda.empty_cache()
    serve_f32_checks(cfg, first, max_len, dev, phase)
    return {"prefill_ms": pre, "decode_ms": statistics.mean(dec),
            "tok_s": tokens / wall, "peak_gib": peak}


# float32 checks of a serve phase: the rows of its first batch they take,
# and the cuts its float32 model needs.  qwen3-moe's float32 parameters
# are 122 GB: 4 of its 48 layers at full width, and a capacity factor of
# E / K = 16, so that nothing drops and decode's routing matches the
# forward's.  llava's scores for 8 x ~3100 positions in float32 take
# 25 GB: 2 of its requests.
F32_ROWS = {"moe": 2, "vlm": 2}
F32_CUTS = {"moe": lambda cfg: dict(
    num_layers=4, capacity_factor=cfg.num_experts / cfg.experts_per_tok)}


def moe_oracle(p, cfg, x):
    """The dense top-k mixture in float64: every expert's SwiGLU on every
    token, each token keeping its top-k experts' outputs weighted by the
    router (no capacity, no dispatch)."""
    p = {k: v.double() for k, v in p.items()}
    x2d = x.double().reshape(-1, x.shape[-1])
    probs = torch.softmax(x2d @ p["router"], dim=-1)
    w, top = torch.topk(probs, cfg.experts_per_tok, dim=-1)
    w = w / w.sum(-1, keepdim=True)
    y = torch.zeros_like(x2d)
    for e in range(cfg.num_experts):
        g = x2d @ p["w_gate"][e]
        h = g * torch.sigmoid(g) * (x2d @ p["w_up"][e])
        y += (w * (top == e)).sum(-1, keepdim=True) * (h @ p["w_down"][e])
    return y.reshape(x.shape)


def moe_oracle_check(params, cfg32, batch, phase):
    """Layer 0's MoE FFN on its real input (the batch's hidden state after
    the layer's attention) against `moe_oracle`: max|diff| within 1e-5 of
    max|ref|."""
    bp = L.index(params["blocks"], 0)
    x = L.embed(params["embed"], cfg32, batch["tokens"])
    pos = L.positions(*x.shape[:2], x.device)
    x = x + L.attention_block(bp["attn"], cfg32, L.rms_norm(
        x, bp["attn_norm"], cfg32.norm_eps), pos, causal=True)[0]
    h = L.rms_norm(x, bp["mlp_norm"], cfg32.norm_eps)
    got = moe.moe_block(bp["moe"], cfg32, h)[0].double()
    want = moe_oracle(bp["moe"], cfg32, h)
    err = max_rel(got, want)
    if err > 1e-5:
        raise AssertionError(f"{phase}: moe_block vs the dense oracle "
                             f"{err:.3e} > 1e-5")
    return (f"layer 0's moe_block ({h.shape[0] * h.shape[1]} tokens, C "
            f"{moe.capacity(h.shape[0] * h.shape[1], cfg32)}) vs the dense "
            f"float64 top-{cfg32.experts_per_tok} oracle max|diff|/max|ref| "
            f"{err:.2e} (limit 1e-5)")


def serve_f32_checks(cfg, batch, max_len, dev, phase):
    """The first batch (its first F32_ROWS[family] rows) in float32, the
    same seed's parameters (cut by F32_CUTS): where the model scans,
    prefill logits and every cache tensor with B2 against ssd_scan_plain
    (max|diff|/max|ref| <= 1e-4); for the MoE, `moe_oracle_check`; then
    prefill + one decode step against the teacher-forced forward (rtol
    1e-3, atol 1e-4, tests/test_arch_smoke.py)."""
    cut = F32_CUTS.get(cfg.family, lambda c: {})(cfg)
    cfg32 = dataclasses.replace(cfg, param_dtype="float32",
                                activation_dtype="float32", **cut)
    params = api.init(SERVE_SEED, cfg32, device=dev)
    rows = F32_ROWS.get(cfg.family, SERVE_BATCH)
    batch = {k: v[:rows] for k, v in batch.items()}
    toks = batch["tokens"]
    f32 = torch.float32
    checks = []
    if scan_layers(cfg):
        got = uncounted(lambda: api.prefill(params, cfg32, batch, max_len,
                                            cache_dtype=f32))
        want = with_plain_scan(lambda: api.prefill(
            params, cfg32, batch, max_len, cache_dtype=f32))
        errs = {"logits": max_rel(got[0], want[0])}
        errs.update({f: max_rel(getattr(got[1], f), getattr(want[1], f))
                     for f in got[1]._fields if f != "length"})
        del got, want
        if max(errs.values()) > MAIN_TOL:
            raise AssertionError(f"{phase}: float32 prefill with B2 vs "
                                 f"plain: {errs} > {MAIN_TOL}")
        checks.append("prefill with B2 vs ssd_scan_plain max|diff|/"
                      "max|ref| " + ", ".join(f"{k} {v:.2e}"
                                              for k, v in errs.items())
                      + f" (limit {MAIN_TOL:g})")
    if cfg.family == "moe":
        checks.append(moe_oracle_check(params, cfg32, batch, phase))
    full, _ = uncounted(lambda: api.forward(params, cfg32, batch))
    last = full[:, -1].clone()
    del full
    prompt = dict(batch, tokens=toks[:, :-1])
    _, cache = uncounted(lambda: api.prefill(params, cfg32, prompt, max_len,
                                             cache_dtype=f32))
    step, _ = api.decode_step(params, cfg32, toks[:, -1:], cache)
    d = (step[:, 0] - last).abs()
    ok = bool((d <= 1e-4 + 1e-3 * last.abs()).all())
    say(phase, f"float32 ({cut or 'full size'}), batch {tuple(toks.shape)}"
        + "".join(f"; {c}" for c in checks)
        + f"; decode step vs teacher-forced forward max|diff| "
        f"{float(d.max()):.3e} (rtol 1e-3, atol 1e-4): "
        f"{'ok' if ok else 'FAIL'}")
    if not ok:
        raise AssertionError(f"{phase}: decode disagrees with forward")
    del params, cache, step
    torch.cuda.empty_cache()


def run_path(name, smi, dev):
    """One main path; returns (its kernel entry, its TB run's ms, for
    acoustic the sharded path's and the bf16 tile's kernel entries, and
    its order-4 case's record for the nine-case summary)."""
    fc = full_case(name, dev)
    state, launches, tb_ms, kept, peak = timed(f"main-{name}",
                                               phase_main_path, fc, smi)
    extra = []
    if kept is not None:
        extra.append(timed("sharded-acoustic", phase_sharded_acoustic, fc,
                           smi, (state, *kept), tb_ms))
        del kept
        torch.cuda.empty_cache()
    sb_ms = timed(f"sb-{name}", phase_sb, fc, smi, tb_ms, state)
    entry = timed(f"kernels-{name}", kernel_entry, fc, state, launches,
                  tb_ms, smi)
    record = {"case": fc.case.name, "physics": name, "order": ORDER,
              "nt": fc.nt, "tile": list(TILE), "T": T_TB,
              "schedule": entry["schedule"],
              "TB": {"ms": tb_ms, "launches": launches,
                     "kernel_ms": entry["ms"], "bound_ms": entry["bound_ms"],
                     "bound_by": entry["bound_by"], "peak_gib": peak},
              "SB": {"ms": sb_ms, "launches": fc.nt},
              "TB/SB": tb_ms / sb_ms}
    if name == "acoustic":
        extra.append(timed("main-acoustic-bf16", phase_main_bf16, fc, smi,
                           state, tb_ms))
        torch.cuda.empty_cache()
    # the batched kernel at the main path's shapes, B = 2: the live state
    # and, as a null shot, a copy shifted along x.  Its operands go into
    # segments of their own (an empty cache), so that once the state is
    # gone the cache can give the launch's one large scratch block (48.4
    # GiB for elastic) beside them
    fc.state = None
    torch.cuda.empty_cache()
    plan = plan_for(fc.physics, T_TB)
    spec, args = batch_operands(
        fc.physics, plan, ORDER, fc.dt, fc.spacing,
        [state, tuple(torch.roll(f, 7, 0) for f in state)],
        fc.params._asdict(), [(fc.g, fc.gr), None],
        (fc.nt // T_TB // 2) * T_TB)
    del state
    torch.cuda.empty_cache()     # a 512^3 elastic batch needs 48 GB at once
    timed(f"kernels-batched-{name}", phase_batched_main, fc, spec, args,
          smi)
    del fc, spec, args
    torch.cuda.empty_cache()          # the next path's fields are larger
    return entry, tb_ms, extra, record


SECONDS = {}                          # phase -> seconds


def timed(phase, fn, *args):
    """fn(*args), its seconds kept in SECONDS and printed."""
    t0 = time.perf_counter()
    out = fn(*args)
    SECONDS[phase] = time.perf_counter() - t0
    say("time", f"{phase} {SECONDS[phase]:.1f} s")
    return out


def say_paper_table(records, smi):
    """The nine paper cases, TB against SB, one line each."""
    for r in sorted(records, key=lambda r: (r["physics"], r["order"])):
        tb, sb = r["TB"], r["SB"]
        say("paper", f"{r['case']}: nt {r['nt']}, tile {tuple(r['tile'])} "
            f"T={r['T']} ({r['schedule']}), {tb['launches']} launches, TB "
            f"{tb['ms']:.1f} ms, SB {sb['ms']:.1f} ms, TB/SB "
            f"{r['TB/SB']:.3f}; kernel {tb['kernel_ms']:.3f} ms per launch "
            f"vs bound {tb['bound_ms']:.3f} ms by {tb['bound_by']}; peak "
            f"{tb['peak_gib']:.2f} GiB [{smi}]")
    print(json.dumps({"paper_cases": records}), flush=True)


def main():
    t_start = time.perf_counter()
    smi = phase_environment()
    dev = torch.device("cuda", 0)
    timed("build", phase_build)
    timed("kernel-vs-plain", phase_kernel_vs_plain, dev)
    timed("kernel-vs-plain-edges", phase_kernel_vs_plain_edges, dev)
    timed("kernels-batched", phase_kernels_batched, dev)
    timed("kernel-vs-plain-dom", phase_kernel_vs_plain_dom, dev)
    timed("kernel-vs-plain-bf16", phase_kernel_vs_plain_bf16, dev)
    say("kernel-vs-plain", f"launches held against the plain version by "
        f"schedule (acoustic, TTI, elastic): {COMPARED}")
    b2 = timed("kernel-vs-plain-ssd", phase_kernel_vs_plain_ssd, dev, smi)
    b2z = timed("kernels-ssd-zamba2", phase_kernels_ssd_zamba2, dev, smi)
    timed("serve-mamba2", phase_serve, "serve-mamba2", dev, smi, b2)
    timed("serve-zamba2", phase_serve, "serve-zamba2", dev, smi, b2z)
    timed("serve-qwen3", phase_serve, "serve-qwen3", dev, smi, None)
    for phase in ("serve-qwen3moe", "serve-whisper", "serve-llava"):
        timed(phase, phase_serve, phase, dev, smi, None)
    entries, tb_ms, extra, paper = [], {}, [], []
    for name in ("acoustic", "tti", "elastic"):
        entry, tb_ms[name], more, record = run_path(name, smi, dev)
        entries.append(entry)
        extra += more
        paper.append(record)
    for name, order in PAPER_EXTRA:
        paper.append(timed(f"paper-{name}-O{order}", phase_paper_case, name,
                           order, smi, dev))
    say_paper_table(paper, smi)
    entries.append(timed("survey-acoustic", phase_survey_acoustic, smi, dev,
                         tb_ms["acoustic"]))
    timed("survey-tti", phase_survey_tti, smi, dev, tb_ms["tti"])
    entries += timed("survey-small", phase_survey_small, smi, dev)
    entries += extra + [b2, b2z]
    timed("sharded-small", phase_sharded_small, smi, dev)
    timed("survey-sharded", phase_survey_sharded, smi, dev)
    say("time", f"total {time.perf_counter() - t_start:.1f} s: " + ", ".join(
        f"{k} {v:.1f}" for k, v in SECONDS.items()))
    print(json.dumps({"kernels": entries}), flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)


if __name__ == "__main__":
    main()
