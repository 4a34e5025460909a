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
the survey engine's sharded route; and the 512^3 acoustic mesh one shard
a process (sharded-acoustic-ranks: four ranks spawned on the card over
gloo, each holding its block and exchanging halos through the host,
kernel B1c one shard row a launch in each), held to the single-device
run.  Then the language models: kernel B2
(the SSD chunked scan) against its plain version on both of its schedules
(tensor cores for bf16 inputs at mamba2-130m's and zamba2-2.7b's head
shapes, (N, P, Q) = (128, 64, 64) and (64, 64, 128), float32 cores for
the rest; each line names the one that ran), and six models at their published widths
and depth, each serving 16 requests with random bf16 parameters from a
seed: through `serving.GenerationEngine` mamba2-130m (B2 counted, 24
launches a prefill), zamba2-2.7b (Mamba2 plus a shared attention block;
54 B2 launches a prefill), and with no TPU kernel on their paths the
dense qwen3-1.7b and qwen3-moe-30b-a3b (128 experts, top 8, the
sort-based capacity dispatch, its dropped entries counted); through
`launch.steps`, with their stub embeddings in the batch, whisper-medium
(24 + 24 layers over 1500 frames) and llava-next-mistral-7b (2880 image
positions before the text).  Then training (train-mamba2): B2 under a
gradient (`ssd_scan.SSDScanFn`, its backward the autodiff of
`_ssd_chunked`), its forward and its gradients against autograd through
the plain scan at both tensor-core head shapes and at the trainer's own
call (8 x 4096, bf16), a planted wrong backward refused, one float32
step of mamba2-130m at full width with B2 against the plain scan, and
the trainer's CLI
(`launch.train.main`) for mamba2-130m at full width in bf16, 8 x 4096
tokens a step, B2 counted (48 launches a step under remat "full"), with
a simulated preemption and a bit-exact restore.  Then the same CLI in two
data-parallel processes (train-mamba2-dp2: spawned ranks sharing the one
card over gloo, 4 x 4096 tokens a rank, ZeRO-1, B2 counted in each),
resumed in one process (elastic DP 2 -> 1), its losses held to the
one-process run's, with a float32 check of the reduced gradient and the
sharded optimizer state.  Then the same CLI in two model-parallel
processes (train-mamba2-tp2: --model-axis 2, each rank 12 of the 24
heads and all 8 x 4096 tokens, B2 counted in each, the model-axis
collectives timed), resumed in one process (TP 2 -> 1), its losses held
to the one-process run's; in the same ranks tp2-qwen3moe, one float32
step of qwen3-moe-30b-a3b at full width cut to 2 of its 48 layers with
its experts, heads and vocabulary split, against one process on the
card, and serve-mamba2-tp2, mamba2-130m served by
`GenerationEngine(rules=)` with 12 of its 24 heads a rank (B2 counted in
each, a float32 batch's logits against one process's); in the
data-parallel ranks train-mamba2-fsdp2, the same model's step with FSDP
over the data axis (its losses against the one-process run's, a float32
step's gradient against one process's), and train-zamba2-fsdp2, the same
for zamba2-2.7b at full width cut to 6 of its 54 layers, whose weights
the rules do split over the data axis.  Then dryrun-vs-card: the port's
dry run (`launch.dryrun`, an eager trace on ``meta`` over a recorder,
no card) of those ranks' steps and of serve-mamba2's prefill, its
collectives a rank and B2 launches held equal to the counted ones and
its peak within 25% of the card's.  A scanning model's
bf16 prefill logits are held to the plain scan's, within twice the gap
of a scan one float32 ulp
from the plain one.  Each has a float32 batch: its prefill held
against the plain scan where the model scans, the MoE's layer against a
dense top-k oracle, and decode against the teacher-forced forward.  Then
the bf16 acoustic tile (B1a-bf16).  It prints one JSON line listing every
kernel and a final JSON status line.  It needs a card: without one it
exits non-zero before printing any result.  It imports neither JAX nor
the JAX package.

Phases (one line each): environment, build, kernel vs plain on small
cases (kernel-vs-plain, kernel-vs-plain-edges: a source on a trapezoid
boundary and a receiver on four tiles' corner, kernels-batched,
kernel-vs-plain-dom, kernel-vs-plain-bf16, kernel-vs-first-acoustic,
kernel-vs-first-tti and kernel-vs-first-elastic: the cluster-shared
z-wavefront B6 at halos 16 and 12 and trapezoid B5 at halos 32 and 48
bit-equal to the first schedule and held to the plain version,
kernel-vs-plain-ssd with kernels-ssd, kernels-ssd-zamba2), serve-mamba2,
serve-zamba2, serve-qwen3, serve-qwen3moe, serve-whisper, serve-llava,
train-mamba2, train-mamba2-dp2 (with train-mamba2-fsdp2 and
train-zamba2-fsdp2), train-mamba2-tp2 (with tp2-qwen3moe and
serve-mamba2-tp2), kernels-ssd-serve-tp2, kernels-ssd-fsdp-zamba2,
dryrun-vs-card, then for each path: main path
at full size, spatially-blocked baseline, kernel timing (with its design:
the schedule the launch takes, registers, shared memory, blocks an SM,
achieved GB/s), the batched kernel at the main path's shapes (after
acoustic: sharded-acoustic, sharded-acoustic-ranks and
main-acoustic-bf16); the paper's cases at
orders 8 and 12 (paper-*: acoustic on B6, TTI and elastic on B5 at tile
64, each such run counted and its kernel held against the plain version
on a mid-run tile; at half depth, elastic's at a quarter,
PAPER_CUT_MS; elastic's order-4 main path at half depth,
MAIN_TIME_MS; the bf16 runs cut first: MAIN_BF16_MS, PAPER_BF16_MS);
then survey-acoustic,
survey-tti, survey-small, sharded-small-*, survey-sharded and the kernel
line.  Any failed check raises, and the script exits non-zero.
"""
import collections
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
COMPARED = {"first": 0, "z-streamed": 0, "cluster": 0, "wavefront": 0}


# grids up to this many points hold every schedule against the plain
# version; larger ones (the 512^3 launches, whose two schedules' outputs
# and scratch would not fit the card together) only the one picked, which
# the main paths also hold to the Listing-1 reference end to end
EVERY_SCHEDULE_POINTS = 256 ** 3


def schedules(spec, physics):
    """The schedules the physics' kernel can run at `spec`, the one
    `stencil_tb.launch_plan` picks first: None for the first schedule, a
    z-streamed (bx, by, shared bytes), a `stencil_tb.ClusterPlan` (B5,
    TTI and elastic) or a `stencil_tb.WavePlan` (B6, acoustic)."""
    out = [ker.launch_plan(spec, physics)]
    if spec.nx * spec.ny * spec.nz > EVERY_SCHEDULE_POINTS:
        return out
    for make in (lambda: None, lambda: ker.stream_plan(spec, physics),
                 lambda: ker.cluster_plan(spec, physics),
                 lambda: ker.wave_plan(spec, physics)):
        try:
            plan = make()
        except ValueError:              # no sub-tile fits, or no B5
            continue
        if ker.schedule_name(plan) not in map(ker.schedule_name, out):
            out.append(plan)
    return out


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


def schedule_of(spec, physics):
    """The schedule a launch of `spec` takes, for the kernels line."""
    plan = ker.launch_plan(spec, physics)
    if plan is None:
        return "first"
    if isinstance(plan, ker.ClusterPlan):
        return (f"cluster-shared (B5), {plan.cluster} blocks a cluster, "
                f"chunks up to {plan.chunk[0]}x{plan.chunk[1]}, "
                f"{plan.smem} B shared")
    if isinstance(plan, ker.WavePlan):
        return (f"cluster-shared wavefront (B6), {plan.cluster} blocks a "
                f"cluster ({plan.parts[0]}x{plan.parts[1]} parts), "
                f"{plan.planes} plane(s) a step, {plan.smem} B shared")
    return f"z-streamed, sub-tile ({plan[0]}, {plan[1]})"


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
        name = ker.schedule_name(plan)
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


# The cluster-shared schedules against the first schedule at the deep
# halos they run, orders 8 and 12: B5 (TTI, elastic; T = 4, halo 32 and
# 48) on a reduced grid of 2 x 2 tiles, B6 (acoustic; halo 16 at T = 4,
# two planes a step, and 12 at T = 2, one) on 5 x 5 tiles of 32, where
# `launch_plan` takes it
KVF_SHAPE = (160, 160, 64)
KVF_TILE = {"acoustic": (32, 32), "tti": (80, 80), "elastic": (80, 80)}
KVF_T = {"acoustic": {8: 4, 12: 2}, "tti": {8: 4, 12: 4},
         "elastic": {8: 4, 12: 4}}


def phase_kernel_vs_first(name, dev, smi):
    """The cluster-shared trapezoid (B5) or z-wavefront (B6), which
    `launch_plan` takes at these halos, against the first schedule (bit
    for bit: fields and receiver partials) and the plain version (rtol /
    atol and FIELD_RTOL) on KVF_SHAPE, one launch each, with its cluster,
    shared bytes and the clusters the card holds at once."""
    physics = phys.PHYSICS[name]
    phase = f"kernel-vs-first-{name}"
    kind = ker.WavePlan if name == "acoustic" else ker.ClusterPlan
    for i, order in enumerate((8, 12)):
        state, params, g, gr, dt = small_case(name, KVF_SHAPE, order, 3, 8,
                                              60 + i, dev)
        T = KVF_T[name][order]
        plan = TBPlan(KVF_TILE[name], T, physics.step_radius(order))
        spec, args = kernel_inputs(physics, plan, state, params, g, gr, dt,
                                   1, SMALL_SPACING, order=order)
        cplan = ker.launch_plan(spec, physics)
        if not isinstance(cplan, kind):
            raise AssertionError(f"{phase}: launch_plan took {cplan} at halo "
                                 f"{spec.halo}, not {kind.__name__}")
        runs = {}
        for sched in (cplan, None):
            with on_schedule(sched):
                runs[ker.schedule_name(sched)] = cuda_ms(lambda: uncounted(
                    lambda: ker.tb_time_tile(spec, physics, *args)))
            COMPARED[ker.schedule_name(sched)] += 1
        plain_ms, (pst, prec) = cuda_ms(lambda: ker.tb_time_tile_plain(
            spec, physics, *args))
        (b_ms, (kst, krec)), (f_ms, (fst, frec)) = \
            runs[ker.schedule_name(cplan)], runs["first"]
        same = all(torch.equal(a, b)
                   for a, b in zip((*kst, krec), (*fst, frec)))
        if not same:
            raise AssertionError(f"{phase}: {schedule_of(spec, physics)} "
                                 f"differs from the first schedule at order "
                                 f"{order}")
        pairs = list(zip(physics.state_fields, kst, pst)) + [
            (f"rec[{c}]", krec[..., c], prec[..., c])
            for c in range(prec.shape[-1])]
        errs = [check_close(f"{phase} order {order} {f}", k, q,
                            ATOL[name]) for f, k, q in pairs]
        if not float(prec.abs().max()) > 0:
            raise AssertionError(f"{phase}: no receiver signal")
        active = occupancy(spec, physics, cplan)
        say(phase, f"order {order} T={T} (halo {spec.halo}) {KVF_SHAPE} tile "
            f"{KVF_TILE[name]}: {schedule_of(spec, physics)}, {active} "
            f"clusters at once, redundancy "
            f"{ker.redundancy(spec, physics, cplan):.3f} (first schedule "
            f"{ker.redundancy(spec, physics, None):.3f}); bit-equal to the "
            f"first schedule: {same}; vs plain max|diff| "
            f"{max(e for e, _ in errs):.3e}, max|diff|/max|plain| "
            f"{max(r for _, r in errs):.3e} (field rtol {FIELD_RTOL}); one "
            f"launch {ker.schedule_name(cplan)} {b_ms:.2f} ms, first "
            f"{f_ms:.2f} ms, plain "
            f"{plain_ms:.1f} ms [{smi}]")
        del runs, kst, krec, fst, frec, pst, prec, args
        torch.cuda.empty_cache()


def occupancy(spec, physics, plan):
    """Clusters of a B5 or B6 launch of `plan` the card holds at once."""
    if isinstance(plan, ker.WavePlan):
        return ker.wave_occupancy(spec, physics, plan)
    return ker.cluster_occupancy(spec, physics, plan)


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
    del rfinal, rrec

    torch.cuda.reset_peak_memory_stats()
    ms, _ = cuda_ms(lambda: fc.run(plan))
    peak = torch.cuda.max_memory_allocated() / 2 ** 30
    mpts = SHAPE[0] * SHAPE[1] * SHAPE[2] * nt / (ms * 1e-3) / 1e6
    say(f"main-{name}", f"TB run {ms:.1f} ms = {ms / launches:.3f} ms per "
        f"time tile = {ms / nt:.3f} ms per step, {mpts:.1f} Mpt*steps/s, "
        f"peak {peak:.2f} GiB [{smi}]")
    return final, recs, launches, ms, kept, peak


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
    plan's dynamic shared memory), blocks an SM (for B5 also its cluster
    and the clusters the card holds at once), and the launch's achieved
    GB/s: the least bytes (`kernel_cost`) and the bytes its schedule moves
    by design (`stencil_tb.design_bytes`) over its time."""
    lib = KERNEL_FILES[physics.name]
    usage = ptxas_usage(_build.build_all([lib])[lib].log)
    plan = ker.launch_plan(spec, physics)
    cluster = isinstance(plan, (ker.ClusterPlan, ker.WavePlan))
    if plan is None:
        bx, by, dyn = (*spec.tile, 0)
    elif cluster:
        bx, by, dyn = (*spec.tile, plan.smem)
    else:
        bx, by, dyn = plan
    props = torch.cuda.get_device_properties(0)
    sm_smem = getattr(props, "shared_memory_per_multiprocessor", 233472)
    sm_regs = getattr(props, "regs_per_multiprocessor", 65536)
    sm_threads = getattr(props, "max_threads_per_multi_processor", 2048)
    threads = ker._STREAM_THREADS
    kind = ker.schedule_name(plan)
    parts = []
    for entry, (regs, static, spill) in sorted(usage.items()):
        entry_kind = ("cluster" if "ClusterArgs" in entry else
                      "wavefront" if "WaveArgs" in entry else
                      "z-streamed" if "StreamArgs" in entry else "first")
        if f"_kernelILi{spec.radius}E" not in entry or entry_kind != kind:
            continue
        blocks = min(sm_smem // (dyn + static + 1024),
                     sm_regs // (regs * threads), sm_threads // threads)
        m = re.search(r"(tb_\w+?_kernel)ILi(\d+)ELb([01])E(\w*?)Ev", entry)
        kind_t = "bf16" if "bfloat16" in m.group(4) else "f32"
        if kind_t != ("bf16" if spec.dtype == BF16 else "f32"):
            continue
        parts.append(f"{m.group(1)}<R={m.group(2)}, DOM={m.group(3)}, "
                     f"{kind_t}>: {regs} registers, {spill} B spill stores, "
                     f"{dyn} + {static} B shared a block, {blocks} block(s) "
                     "an SM")
    design = ker.design_bytes(spec, physics)
    nblocks = (spec.nx // bx) * (spec.ny // by)
    if plan is None:
        what = "first schedule, one block a tile"
    elif cluster:
        active = occupancy(spec, physics, plan)
        what = (f"{schedule_of(spec, physics)} on tile {spec.tile}, "
                f"{active} clusters at once "
                f"({nblocks / max(active, 1):.2f} waves), redundancy "
                f"{ker.redundancy(spec, physics, plan):.3f}")
        nblocks *= plan.cluster
    else:
        what = (f"z-streamed schedule, sub-tile ({bx}, {by}) of tile "
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

# the TB plans tried in order (tile, T), by physics and order: the first
# whose propagation fits the card.  Acoustic: a smaller tile does not make
# a launch smaller (each tile's window overhangs it by the same halo), so
# (16, 16) comes last.  TTI and elastic: the cluster-shared trapezoid (B5)
# at tiles 64 and 128 first, in the order `tools/paper_cases.py --kernels`
# measured fastest a step in all four cases (PERF.md: tile 64 with 2
# blocks a cluster fills the card in one wave; T = 2 beats T = 4), then
# the plans of PR 19.
_FIRST_PLANS = (((32, 32), 4), ((32, 32), 2), ((16, 16), 2))
_B5_PLANS = (((64, 64), 2), ((128, 128), 2), ((64, 64), 4),
             ((128, 128), 4))
# acoustic: the cluster-shared z-wavefront (B6), which `launch_plan`
# takes from halo 12, at the tiles and depths `tools/paper_cases.py
# --kernels` measured fastest a step (PERF.md), each with the cluster and
# planes a step `stencil_tb.wave_size` gives
_B6_PLANS = {8: (((32, 32), 3), ((32, 32), 4)), 12: (((32, 32), 2),)}
PAPER_PLANS = {
    ("acoustic", 8): _B6_PLANS[8] + _FIRST_PLANS,
    ("acoustic", 12): _B6_PLANS[12] + _FIRST_PLANS,
    ("tti", 8): _B5_PLANS + _FIRST_PLANS,
    ("tti", 12): _B5_PLANS + _FIRST_PLANS,
    ("elastic", 8): _B5_PLANS + _FIRST_PLANS,
    ("elastic", 12): _B5_PLANS + _FIRST_PLANS,
}
# the paper cases' depth in simulated ms: acoustic and TTI at half the
# paper's 512 ms (nt 220 / 230 for acoustic at orders 8 / 12, 440 / 459 at
# 512 ms; TTI 131 / 136 of 261 / 272), elastic at a quarter (nt 110 /
# 115): the same width and plans, still held to Listing 1; the time they
# free keeps the whole script inside its limit beside the training phases
# in ranks, sharded-acoustic-ranks, serve-mamba2-tp2 and dryrun-vs-card.
# PERF.md keeps the full-depth figures
PAPER_CUT_MS = {(name, order): 128.0 if name == "elastic" else 256.0
                for name in ("acoustic", "tti", "elastic")
                for order in (8, 12)}
# device bytes a propagation may count on beyond `ops.propagation_bytes`
# (its tables, receiver partials and traces, the allocator's rounding)
PAPER_RESERVE = 2 * 2 ** 30


def paper_plan(fc):
    """(plan, [(tile, T, GiB) of the plans tried]): the first of the
    case's PAPER_PLANS whose propagation (`ops.propagation_bytes`) fits
    this card's free memory less PAPER_RESERVE; raises if none does."""
    from repro_torch.survey.engine import free_device_bytes

    torch.cuda.empty_cache()
    free = free_device_bytes(fc.state[0].device)
    shape = tuple(fc.state[0].shape)
    # the case's state and params, already made, count in each `need`
    made = sum(f.numel() * f.element_size() for f in (*fc.state, *fc.params))
    tried = []
    plans = PAPER_PLANS[fc.physics.name, fc.order]
    for tile, T in plans:
        plan = TBPlan(tile, T, fc.physics.step_radius(fc.order))
        need = ops.propagation_bytes(fc.physics, shape, fc.nt, plan,
                                     fc.order)
        tried.append((tile, T, need / 2 ** 30))
        if need + PAPER_RESERVE <= free + made:
            return plan, tried
    raise AssertionError(f"{fc.case.name}: no plan of {plans} fits "
                         f"the card's {free / 2 ** 30:.2f} GiB free: " +
                         ", ".join(f"tile {t} T={d} {g:.2f} GiB"
                                   for t, d, g in tried))


def counted_run(fc, plan):
    """fc.run(plan) with the launch counter set to 0 just before and read
    just after, CUDA events around the run and around each launch: (final,
    recs, launches, run ms, ms of each full-depth launch, peak GiB, the
    launches by schedule)."""
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
    ker.schedule_launches.update(dict.fromkeys(ker.schedule_launches, 0))
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
    return final, recs, launches, ms, per_launch, peak, dict(
        ker.schedule_launches)


def phase_paper_case(name, order, smi, dev):
    """One of the paper's cases beyond order 4 at its full width and depth:
    the Listing-1 reference once (kept on the host), then the TB run on
    the first plan of PAPER_PLANS that fits and the SB run (T = 1), once
    each through the entry point with the kernel counted, each held to
    the reference within MAIN_TOL on every field and receiver channel.
    Returns the case's record for the nine-case summary."""
    phase = f"paper-{name}-O{order}"
    cut_ms = PAPER_CUT_MS.get((name, order))
    fc = full_case(name, dev, order=order, time_ms=cut_ms)
    plan, tried = paper_plan(fc)
    model = plan_for_physics(name, SHAPE[2], order,
                             tiles=(4, 8, 16, 32, 64, 128),
                             depths=(1, 2, 4, 8))[0]
    spec = ops.make_spec(SHAPE, plan, order, fc.dt, fc.spacing, 1, 1,
                         physics=fc.physics)
    say(phase, f"{fc.case.name}: {SHAPE} spacing {fc.spacing[0]:g} m "
        f"nt={fc.nt} dt={fc.dt:.6e}"
        + (f" (cut depth: {cut_ms:g} of the paper's 512 ms)" if cut_ms
           else "")
        + f"; plan tile {plan.tile} T={plan.T} "
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
           "nt": fc.nt, "half_depth": bool(cut_ms),
           "tile": list(plan.tile), "T": plan.T,
           "schedule": schedule_of(spec, fc.physics),
           "model_plan": {"tile": list(model.tile), "T": model.T}}
    sb = TBPlan(TILE, 1, fc.physics.step_radius(order))
    for what, p in (("TB", plan), ("SB", sb)):
        final, recs, launches, ms, per_launch, peak, by_schedule = \
            counted_run(fc, p)
        if not (all(torch.isfinite(f).all() for f in final)
                and torch.isfinite(recs).all()):
            raise AssertionError(f"{phase}: {what} non-finite values")
        errs, same = field_errors(fc.physics, (final, recs), (
            tuple(f.to(dev) for f in rfinal), rrec))
        del recs
        worst = check_errors(phase, errs, MAIN_TOL,
                             f"{what} vs the Listing-1 reference")
        pspec = ops.make_spec(SHAPE, p, order, fc.dt, fc.spacing, 1, 1,
                              physics=fc.physics)
        k_ms = statistics.median(per_launch)
        cost = ker.kernel_cost(pspec, fc.physics)
        bound, by = bound_of(cost)
        if isinstance(ker.launch_plan(pspec, fc.physics),
                      (ker.ClusterPlan, ker.WavePlan)):
            out["kernel_entry"] = cluster_entry(phase, fc, pspec, final,
                                                by_schedule, k_ms, cost, smi)
        del final
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
    before = EARLIER_TB_SB.get((name, order))
    say(phase, f"TB/SB {out['TB/SB']:.3f} (no gain claimed)"
        + (f"; on the schedules before the cluster-shared wavefront "
           f"(PERF.md): {before}" if before else "") + f" [{smi}]")
    del fc, rfinal, rrec
    torch.cuda.empty_cache()
    return out


PAPER_EXTRA = [(c.propagator, c.space_order) for c in
               paper_stencil.PAPER_CASES if c.space_order != ORDER]
# TB/SB of the acoustic cases at orders 8 and 12 on the schedules they took
# before the cluster-shared wavefront (B6), printed beside today's (PERF.md
# section 5: z-streamed 16 x 16 and the first schedule)
EARLIER_TB_SB = {("acoustic", 8): 1.589, ("acoustic", 12): 3.763}


def cluster_entry(phase, fc, spec, final, by_schedule, k_ms, cost, smi):
    """The kernels-line entry of a paper case's TB run on a cluster-shared
    schedule, the trapezoid B5 (TTI, elastic) or the z-wavefront B6
    (acoustic): every launch of the run whose shape takes it (the
    full-depth ones, and the remainder's where its halo does) took it, and
    the kernel on a mid-run tile of the run's final state (the source's
    values of that tile) is held against the plain version."""
    name, plan = fc.physics.name, ker.launch_plan(spec, fc.physics)
    kind = ker.schedule_name(plan)
    label = "B6" if kind == "wavefront" else "B5"
    r = fc.physics.step_radius(fc.order)
    expect = fc.nt // spec.T
    if fc.nt % spec.T:                  # the remainder tile's own halo
        rspec = ops.make_spec(SHAPE, TBPlan(spec.tile, fc.nt % spec.T, r),
                              fc.order, fc.dt, fc.spacing, 1, 1,
                              physics=fc.physics)
        expect += ker.schedule_name(ker.launch_plan(rspec,
                                                    fc.physics)) == kind
    if by_schedule[kind] != expect:
        raise AssertionError(f"{phase}: {by_schedule[kind]} {label} "
                             f"launches, expected {expect} ({by_schedule})")
    t0 = (fc.nt // spec.T // 2) * spec.T
    tplan = TBPlan(spec.tile, spec.T, r)
    cspec, args = kernel_inputs(fc.physics, tplan, final,
                                fc.params._asdict(), fc.g, fc.gr, fc.dt, t0,
                                fc.spacing, order=fc.order)
    err, rel, _, plain_ms = compare_kernel(cspec, fc.physics, args)
    del args
    say_design(phase, fc.physics, spec, k_ms, cost)
    bound, by = bound_of(cost)
    say(phase, f"{label} tb_{name} at tile {spec.tile} T={spec.T}: "
        f"{by_schedule[kind]} launches in the TB run, {k_ms:.3f} ms "
        f"a launch vs bound {bound:.3f} ms by {by}; vs plain on the tile "
        f"at step {t0}: max|diff| {err:.3e}, max|diff|/max|plain| "
        f"{rel:.3e}, plain {plain_ms:.1f} ms [{smi}]")
    shape = ({"parts": list(plan.parts), "planes": plan.planes}
             if kind == "wavefront" else {"chunk": list(plan.chunk)})
    return {
        "name": f"stencil_tb.tb_{name}_{kind}_O{fc.order}",
        "route": "cuda",
        "source": f"src/repro_torch/kernels/csrc/{KERNEL_FILES[name]}.cu",
        "replaces": "src/repro/kernels/stencil_tb.py:129",
        "launches": by_schedule[kind],
        "max_abs_err": err,
        "ms": k_ms,
        "plain_ms": plain_ms,
        "bound_ms": bound,
        "bound_by": by,
        "library_ms": None,
        "schedule": schedule_of(spec, fc.physics),
        "cluster": plan.cluster,
        **shape,
        "smem": plan.smem,
        "tile": list(spec.tile),
        "T": spec.T,
    }


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
              inner_T=None, order=ORDER, mesh=None, **kw):
    """A `DistTBPlan` of the 2x2 mesh on `dev` (or of `mesh`, a rank's
    view) with the CUDA inner executor: exchange depth T, inner tile
    `tile`, inner depth `inner_T` (default T: the flat schedule)."""
    r = physics.step_radius(order)
    return H.DistTBPlan(
        mesh=mesh or ShardMesh(MESH, devices=(dev,)),
        grid_shape=tuple(shape),
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
        # B1c-bf16: the flat run in bf16, every pass's launch held against
        # the plain bf16 version and the float32 kernel (`compare_bf16`)
        state, params, g, gr, dt = small_case(name, DOM_SHAPE, ORDER, 3, 4,
                                              20, dev)
        plan = dist_plan(physics, DOM_SHAPE, dt, SMALL_SPACING, dev, T=T,
                         tile=(24, 24))
        seen = []

        def check16(spec, p, *args, dom=None, param_copies=None):
            seen.append(compare_bf16(spec, p, args, to_bf16_args(
                args, torch.float32), dom=dom)[:3])
            return uncounted(lambda: ker.tb_time_tile(spec, p, *args,
                                                      dom=dom))

        ops.EXECUTORS["cuda"] = check16
        try:
            H.sharded_tb_propagate(
                plan, nt, tuple(f.to(BF16) for f in state),
                {f: a.to(BF16) for f, a in params.items()}, g, gr)
        finally:
            ops.EXECUTORS["cuda"] = ker.tb_time_tile
        if len(seen) != expected_launches(plan, nt):
            raise AssertionError(f"{name}: {len(seen)} bf16 passes")
        say("kernel-vs-plain-dom", f"{name} in bf16 (B1c-bf16), mesh {MESH} "
            f"block (24, 24) T={T} nt={nt} flat: {len(seen)} launches of 4 "
            "shard rows, each on every schedule it has: worst max|diff|/"
            f"max|plain| vs plain bf16 {max(d[0] for d in seen):.3e} (limit "
            f"2^-6), max|diff| vs float32 kernel "
            f"{max(d[1] for d in seen):.3e} (least margin to 0.1 max|f32| + "
            f"1e-2: {min(d[2] for d in seen):.3e})")
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


RANKS_WORLD = MESH[0] * MESH[1]      # one shard a rank
RANKS_TIMEOUT = 600.0                # seconds for the ranks to report


def save_run(tmp, what, physics, fields, rec):
    """A run's global fields and traces as .npy files in `tmp`, named
    `what`, for the ranks to read their blocks of."""
    for f, a in zip(physics.state_fields, fields):
        np.save(Path(tmp) / f"{what}-{f}.npy", a.cpu().numpy())
    np.save(Path(tmp) / f"{what}-rec.npy", rec.cpu().numpy())


def against_saved(tmp, what, physics, plan, st, rec):
    """This rank's blocks `st` (on a rank's view of `plan`'s mesh) and the
    traces `rec` against the run `save_run` saved as `what`: per field
    (max|diff|, max|saved|) over the block and whether the block is
    bit-equal; per receiver channel max|diff| / max|saved|, and whether
    the traces are bit-equal."""
    dev = rec.device
    bx, by = plan.block
    i, j = divmod(plan.mesh.rank, plan.pgrid[1])
    fields, equal = {}, True
    for f, a in zip(physics.state_fields, st):
        whole = np.load(Path(tmp) / f"{what}-{f}.npy", mmap_mode="r")
        want = torch.as_tensor(np.ascontiguousarray(
            whole[i * bx:(i + 1) * bx, j * by:(j + 1) * by]), device=dev)
        fields[f] = (float((a - want).abs().max()), float(want.abs().max()))
        equal = equal and torch.equal(a, want)
        del want
    want = torch.as_tensor(np.load(Path(tmp) / f"{what}-rec.npy"),
                           device=dev)
    w, r = (t if t.dim() == 3 else t[..., None] for t in (want, rec))
    return {"fields": fields, "equal": equal,
            "rec": {f"rec[{c}]": max_rel(r[..., c], w[..., c])
                    for c in range(w.shape[-1])},
            "rec_equal": torch.equal(rec, want)}


def ranks_errors(res, key, physics):
    """max|diff| / max|saved| per field over all the ranks' blocks (their
    `against_saved` results under `key`), rank 0's per trace channel, and
    whether every block and the traces are bit-equal."""
    errs = {f: max(r[key]["fields"][f][0] for r in res)
            / max(max(r[key]["fields"][f][1] for r in res), 1e-30)
            for f in physics.state_fields}
    errs.update(res[0][key]["rec"])
    same = all(r[key]["equal"] for r in res) and res[0][key]["rec_equal"]
    return errs, same


def same_traces(group, rec):
    """Whether every rank of `group` holds these traces bit for bit: the
    least and the most over the ranks of a checksum of their bits."""
    bits = rec.contiguous().view(torch.int32).long().sum().reshape(1)
    most = group.all_reduce_(bits.clone(), op=torch.distributed.ReduceOp.MAX)
    least = group.all_reduce_(bits.clone(),
                              op=torch.distributed.ReduceOp.MIN)
    return bool(torch.equal(most, least))


def spawn_sharded(fn, tmp):
    """fn(rank, tmp) in RANKS_WORLD spawned ranks (gloo over a free
    localhost port); (their results, wall seconds)."""
    from repro_torch.distributed import process_group

    t0 = time.perf_counter()
    res = process_group.spawn_ranks(
        fn, RANKS_WORLD, (tmp,), timeout=RANKS_TIMEOUT,
        env={"MASTER_ADDR": "localhost", "MASTER_PORT": str(free_port())})
    return res, time.perf_counter() - t0


def in_gloo_group(fn, tmp):
    """fn(group, tmp) in this rank's gloo group on cuda:LOCAL_RANK %
    device_count (`DataParallel.start`), left at the end."""
    from repro_torch.distributed.process_group import DataParallel

    group = DataParallel.start("gloo", "cuda")
    try:
        return fn(group, tmp)
    finally:
        group.close()


def host_case(fc):
    """`fc`'s global state and params moved to the host (the rank's card
    then holds its blocks alone): (state tuple, params dict)."""
    state = tuple(f.cpu() for f in fc.state)
    params = {k: v.cpu() for k, v in fc.params._asdict().items()}
    fc.state = fc.params = None
    torch.cuda.empty_cache()
    return state, params


def phase_sharded_acoustic_ranks(fc, smi, kept, four_rows):
    """sharded-acoustic-ranks: sharded-acoustic's case and plan (the 512^3
    acoustic paper case, nt 399, a 2x2 mesh, T=4, tile 32 flat, kernel
    B1c) one shard a process: RANKS_WORLD ranks spawned by
    `process_group.spawn_ranks(sharded_rank, ...)`, each on cuda:0 over
    gloo, each holding its own block and exchanging halos with its
    neighbours through the host (`DataParallel.exchange`).  Each rank's
    block and the traces are held against main-acoustic's single-device
    run within FIELD_RTOL (bit-equality reported) and its Listing-1
    reference within MAIN_TOL (`kept`, saved for the ranks to a
    temporary directory: no block travels through the result queue);
    each rank's launches and exchange rounds against `expected_launches`
    / `expected_rounds`.  Prints the run's ms (CUDA events on rank 0),
    the state exchange's bytes, transfer ms and wait ms a tile a rank,
    peak GiB a rank, and B1c's one-row launch (rank 0, a mid-run pass)
    against its bound beside the four-row launch of sharded-acoustic
    (`four_rows`, its kernel-line entry).  Returns the one-row route's
    kernel-line entry."""
    import tempfile

    phase = "sharded-acoustic-ranks"
    final, recs, rfinal, rrec = kept
    physics = fc.physics
    torch.cuda.empty_cache()
    with tempfile.TemporaryDirectory() as tmp:
        save_run(tmp, "single", physics, final, recs)
        save_run(tmp, "listing1", physics, rfinal, rrec)
        res, wall = spawn_sharded(sharded_rank, tmp)
    r0 = res[0]
    plan = dist_plan(physics, SHAPE, fc.dt, fc.spacing, fc.state[0].device)
    want = (expected_launches(plan, fc.nt), expected_rounds(plan, fc.nt))
    counts = [(r["launches"], r["rounds"]) for r in res]
    if any(c != want for c in counts):
        raise AssertionError(f"{phase}: (launches, exchange rounds) by rank "
                             f"{counts}, expected {want} in each")
    errs, same = ranks_errors(res, "single", physics)
    rerrs, _ = ranks_errors(res, "listing1", physics)
    worst = check_errors(phase, errs, FIELD_RTOL, "vs the single-device run")
    rworst = check_errors(phase, rerrs, MAIN_TOL, "vs the Listing-1 "
                          "reference")
    if not (all(r["finite"] for r in res)
            and all(r["rec_same"] for r in res)):
        raise AssertionError(f"{phase}: non-finite blocks, or ranks "
                             "holding different traces")
    n_tiles = -(-fc.nt // plan.T)
    ex = [r["exchange"] for r in res]
    say(phase, f"{SHAPE} nt={fc.nt} on a {MESH} mesh, one {plan.block} "
        f"block a rank in {RANKS_WORLD} ranks (gloo on one card, strips "
        f"through pinned host buffers), T={plan.T} tile {plan.inner_tile} "
        f"flat, field depths {plan.field_depths(plan.T)}: launches and "
        f"exchange rounds by rank {counts} (expected {want}, one shard row "
        f"a launch); vs the single-device TB run: " + ", ".join(
            f"{k} {v:.2e}" for k, v in errs.items())
        + f" (max {worst:.3e}, limit {FIELD_RTOL:g}), bit-equal: {same} "
        f"(fields: {all(r['single']['equal'] for r in res)}); vs the "
        f"Listing-1 reference max {rworst:.3e} (limit {MAIN_TOL:g}); every "
        "rank holds the same traces")
    say(phase, f"warm run {r0['ms']:.1f} ms (CUDA events on rank 0; ranks "
        + ", ".join(f"{r['ms']:.1f}" for r in res) + f"), cold run "
        f"{r0['cold_ms']:.1f} ms (the counted one, with the exchange "
        f"timed); a tile a rank, the state's exchange: " + ", ".join(
            f"{e['bytes'] / n_tiles / 1e6:.2f}" for e in ex)
        + " MB sent, transfer " + ", ".join(
            f"{e['transfer_s'] / n_tiles * 1e3:.3f}" for e in ex)
        + " ms, wait at the barrier before it " + ", ".join(
            f"{e['wait_s'] / n_tiles * 1e3:.3f}" for e in ex)
        + f" ms (by rank; {n_tiles} tiles; gloo through the host: this "
        f"one-card rig's cost, not a link's); peak GiB by rank " + ", ".join(
            f"{r['peak_gib']:.2f}" for r in res)
        + f"; wall {wall:.1f} s for the ranks (start, case, two runs, "
        f"checks, the kernel timing) [{smi}]")
    k = r0["kernel"]
    say(phase, f"kernel B1c, one shard row at grid {k['grid']} + halo "
        f"{k['halo']}, tile {k['tile']} (rank 0, a mid-run pass, the other "
        f"ranks idle at a barrier): {k['ms']:.3f} ms per launch (median of "
        f"3 means of 5; least {k['lo']:.3f}, most {k['hi']:.3f}) vs bound "
        f"{k['bound_ms']:.3f} ms by {k['bound_by']} ({k['gb']:.2f} GB); "
        f"plain {k['plain_ms']:.1f} ms; max|diff| vs plain "
        f"{k['err']:.3e}, max|diff|/max|plain| {k['rel']:.3e}; beside it "
        f"sharded-acoustic's four-row launch {four_rows['ms']:.3f} ms vs "
        f"bound {four_rows['bound_ms']:.3f} ms [{smi}]")
    return {
        "name": "stencil_tb.tb_acoustic (sharded pass in a rank: one shard "
                "row, its params and domain mask)",
        "route": "cuda",
        "source": "src/repro_torch/kernels/csrc/stencil_tb.cu",
        "replaces": "src/repro/kernels/stencil_tb.py:129",
        "launches": counts[0][0],
        "launches_by_rank": [c[0] for c in counts],
        "max_abs_err": k["err"],
        "ms": k["ms"],
        "plain_ms": k["plain_ms"],
        "bound_ms": k["bound_ms"],
        "bound_by": k["bound_by"],
        "library_ms": None,
    }


def sharded_rank(rank, tmp):
    """One rank of sharded-acoustic-ranks, in a process of its own
    (`sharded_rank_run` in its gloo group)."""
    return in_gloo_group(sharded_rank_run, tmp)


def sharded_rank_run(group, tmp):
    """This rank's part of sharded-acoustic-ranks: the case built on the
    card as main-acoustic builds it, its global fields then moved to the
    host; a counted run (B1c's launches and the exchange rounds from 0,
    the state exchange timed: the wait at a barrier apart from the
    transfer after it), its block and the traces against the saved
    single-device run and Listing-1 reference; a warm run timed by CUDA
    events; on rank 0, B1c's one-row launch of a mid-run pass timed and
    held against the plain version while the other ranks wait."""
    from repro_torch.launch.mesh import make_rank_mesh

    dev = group.device
    fc = full_case("acoustic", dev)
    state, params = host_case(fc)
    physics = fc.physics
    mesh = make_rank_mesh(MESH, group)
    plan = dist_plan(physics, SHAPE, fc.dt, fc.spacing, dev, mesh=mesh)
    mid = (fc.nt // plan.T) // 2
    captured = []

    def capture(spec, p, *args, dom=None, param_copies=None):
        if len(captured) == mid and group.rank == 0:
            captured.append((spec, args, dom))
        else:
            captured.append(None)
        return ker.tb_time_tile(spec, p, *args, dom=dom,
                                param_copies=param_copies)

    exchange = {"bytes": 0, "transfer_s": 0.0, "wait_s": 0.0}
    to_depth = H.exchange_to_depth

    def counted_exchange(*a, **kw):
        before = dict(group.p2p)
        out = to_depth(*a, **kw)
        exchange["bytes"] += group.p2p["bytes_sent"] - before["bytes_sent"]
        for key in ("transfer_s", "wait_s"):
            exchange[key] += group.p2p[key] - before[key]
        return out

    def run():
        return H.sharded_tb_propagate(plan, fc.nt, state, params, fc.g,
                                      fc.gr)

    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    group.max(0.0)
    ker.launches = 0
    mesh.exchange_rounds = 0
    group.timing = True
    ops.EXECUTORS["cuda"] = capture
    try:
        with patched(H, "exchange_to_depth", counted_exchange):
            cold_ms, (st, rec) = cuda_ms(run)
    finally:
        ops.EXECUTORS["cuda"] = ker.tb_time_tile
        group.timing = False
    out = {"launches": ker.launches, "rounds": mesh.exchange_rounds,
           "exchange": exchange, "cold_ms": cold_ms,
           "finite": all(bool(torch.isfinite(f).all()) for f in st)
           and bool(torch.isfinite(rec).all()),
           "rec_same": same_traces(group, rec)}
    for what in ("single", "listing1"):
        out[what] = against_saved(tmp, what, physics, plan, st, rec)
    del st, rec
    group.max(0.0)
    out["ms"], res = cuda_ms(run)
    del res
    out["peak_gib"] = torch.cuda.max_memory_allocated(dev) / 2 ** 30
    group.max(0.0)
    if group.rank == 0:
        spec, args, dom = next(c for c in captured if c is not None)
        k_ms, lo, hi, _ = time_kernel(spec, physics, args, dom=dom)
        err, rel, _, plain_ms = compare_kernel(spec, physics, args, dom=dom)
        cost = ker.kernel_cost(spec, physics, shots=1, shard_rows=True)
        bound, by = bound_of(cost)
        out["kernel"] = {"ms": k_ms, "lo": lo, "hi": hi, "err": err,
                         "rel": rel, "plain_ms": plain_ms, "bound_ms": bound,
                         "bound_by": by, "gb": cost["min_bytes"] / 1e9,
                         "grid": (spec.nx, spec.ny, spec.nz),
                         "halo": spec.halo, "tile": spec.tile}
        del spec, args, dom
    del captured
    group.max(0.0)
    return out


# sharded-small-ranks: (name, physics, shape, plan fields) of each case run
# in the ranks against its single-device TB run
SMALL_RANK_CASES = [
    ("elastic", "elastic", SHARDED_SMALL_SHAPE, {}),
    ("acoustic, overlap", "acoustic", NESTED_SHAPE, {"overlap": True}),
]


def sharded_survey(fc, dev):
    """survey-sharded's engine and its 2 shots on `fc` (the 128^3
    acoustic case)."""
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
    return engine, shots


def phase_sharded_small_ranks(smi, dev):
    """sharded-small-ranks: sharded-small's and survey-sharded's cases on
    the 2x2 mesh one shard a process (RANKS_WORLD spawned gloo ranks on
    the card): elastic at 256^3 with its nine per-field depths, acoustic
    at 128^3 with the overlapped first step and nt % T = 3, each rank's
    block and the traces against the case's single-device TB run, and
    `SurveyEngine.run_sharded` for the two 128^3 shots against `run`; each
    within FIELD_RTOL, with the launches and exchange rounds each rank
    makes.  Run by `tools/sharded_ranks.py`, outside this script's time
    limit."""
    import tempfile

    phase = "sharded-small-ranks"
    with tempfile.TemporaryDirectory() as tmp:
        for name, pname, shape, _ in SMALL_RANK_CASES:
            fc = full_case(pname, dev, shape=shape, time_ms=REDUCED_TIME_MS)
            save_run(tmp, name, fc.physics,
                     *fc.run(plan_for(fc.physics, T_TB)))
            del fc
            torch.cuda.empty_cache()
        fc = full_case("acoustic", dev, shape=NESTED_SHAPE,
                       time_ms=REDUCED_TIME_MS)
        engine, shots = sharded_survey(fc, dev)
        np.save(Path(tmp) / "survey.npy", np.stack(engine.run(shots).traces))
        del engine, fc
        torch.cuda.empty_cache()
        res, wall = spawn_sharded(small_rank, tmp)
    for name, pname, shape, kw in SMALL_RANK_CASES:
        physics = phys.PHYSICS[pname]
        errs, same = ranks_errors([r[name] for r in res], "single", physics)
        worst = check_errors(f"{phase} {name}", errs, FIELD_RTOL,
                             "vs the single-device run")
        r0 = res[0][name]
        counts = [(r[name]["launches"], r[name]["rounds"]) for r in res]
        if not all(r[name]["rec_same"] for r in res):
            raise AssertionError(f"{phase} {name}: the ranks hold different "
                                 "traces")
        say(phase, f"{name} {shape} nt={r0['nt']} mesh {MESH} in "
            f"{RANKS_WORLD} ranks, T={T_TB} tile {TILE} {kw or 'flat'}, field "
            f"depths {r0['depths']}: launches and exchange rounds by rank "
            f"{counts} (as the plan needs: checked in each rank); vs the "
            f"single-device TB run max {worst:.3e} (limit {FIELD_RTOL:g}), "
            f"bit-equal: {same} (fields: "
            f"{all(r[name]['single']['equal'] for r in res)}); run "
            f"{r0['ms']:.1f} ms (CUDA events on rank 0), "
            f"{r0['sent'] / 1e6:.1f} MB sent by rank 0 [{smi}]")
    s = res[0]["survey"]
    worst = max(r["survey"]["worst"] for r in res)
    if not worst <= FIELD_RTOL:
        raise AssertionError(f"{phase}: run_sharded's traces differ from "
                             f"run's by {worst:.3e}")
    say(phase, f"run_sharded in {RANKS_WORLD} ranks, {s['shots']} shots "
        f"{NESTED_SHAPE}: launches by rank "
        f"{[r['survey']['launches'] for r in res]} (as the plan needs: "
        f"checked in each rank), {s['seconds']:.3f} s on rank 0; every "
        f"rank's traces against run's max|diff|/max|ref| {worst:.3e} "
        f"(limit {FIELD_RTOL:g}); wall {wall:.1f} s for the ranks [{smi}]")


def small_rank(rank, tmp):
    """One rank of sharded-small-ranks (`small_rank_run` in its gloo
    group)."""
    return in_gloo_group(small_rank_run, tmp)


def small_rank_run(group, tmp):
    """This rank's part of sharded-small-ranks: each SMALL_RANK_CASES case
    built on the card, its global fields moved to the host, one counted
    run (`sharded_run`: raises unless the launches and exchange rounds
    are what the plan needs) timed by CUDA events, against the saved
    single-device run; then `run_sharded` of survey-sharded's shots."""
    from repro_torch.launch.mesh import make_rank_mesh

    dev = group.device
    mesh = make_rank_mesh(MESH, group)
    out = {}
    for name, pname, shape, kw in SMALL_RANK_CASES:
        fc = full_case(pname, dev, shape=shape, time_ms=REDUCED_TIME_MS)
        state, params = host_case(fc)
        plan = dist_plan(fc.physics, shape, fc.dt, fc.spacing, dev,
                         mesh=mesh, **kw)
        group.max(0.0)
        sent = group.p2p["bytes_sent"]
        ms, ((st, rec), launches, rounds) = cuda_ms(lambda: sharded_run(
            plan, fc.nt, state, params, fc.g, fc.gr, name))
        out[name] = {"launches": launches, "rounds": rounds, "ms": ms,
                     "nt": fc.nt, "depths": plan.field_depths(plan.T),
                     "sent": group.p2p["bytes_sent"] - sent,
                     "rec_same": same_traces(group, rec),
                     "single": against_saved(tmp, name, fc.physics, plan, st,
                                             rec)}
        del st, rec, state, params, fc
        torch.cuda.empty_cache()
    fc = full_case("acoustic", dev, shape=NESTED_SHAPE,
                   time_ms=REDUCED_TIME_MS)
    engine, shots = sharded_survey(fc, dev)
    plan = dist_plan(fc.physics, NESTED_SHAPE, fc.dt, fc.spacing, dev,
                     mesh=mesh)
    ker.launches = 0
    sres = engine.run_sharded(shots, plan)
    torch.cuda.synchronize()
    if ker.launches != len(shots) * expected_launches(plan, fc.nt):
        raise AssertionError(f"run_sharded: {ker.launches} launches")
    want = np.load(Path(tmp) / "survey.npy")
    out["survey"] = {
        "launches": ker.launches, "shots": len(shots),
        "seconds": sres.stats["seconds"],
        "worst": max(max(stencil_survey.channel_errors(a, b))
                     for a, b in zip(sres.traces, want))}
    group.max(0.0)
    return out


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
    engine, shots = sharded_survey(fc, dev)
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
# The bf16 tiles (kernels B1a-bf16 acoustic, B1b-bf16 TTI and elastic,
# B1c-bf16 with the sharded pass's domain masks)
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
# bf16 launches held against the plain version, by (physics, schedule)
COMPARED_BF16 = collections.Counter()


def compare_bf16(spec, physics, args, args32, dom=None):
    """The bf16 kernel on `args` against the plain bf16 version on them
    (max|diff| <= 2^-6 max|plain| per field and receiver channel), once on
    every schedule it has at this shape (`schedules`), and the float32
    kernel on `args32`, the same values in float32 (within the reference's
    bf16 bound of its result); `dom` the rows' domain masks (kernel
    B1c-bf16).  Returns (max|diff| / max|plain| vs plain, max|diff| vs
    float32, the least margin to the reference's bound: bound - diff,
    max|diff| vs plain, the plain version's ms: one call, by CUDA
    events)."""
    fst, frec = uncounted(lambda: ker.tb_time_tile(
        dataclasses.replace(spec, dtype=torch.float32), physics, *args32,
        dom=dom))
    plain_ms, (pst, prec) = cuda_ms(lambda: ker.tb_time_tile_plain(
        spec, physics, *args, dom=dom))
    worst_p = worst_f = abs_p = 0.0
    margin = math.inf
    outs = []
    for plan in schedules(spec, physics):
        with on_schedule(plan):
            outs.append(uncounted(lambda: ker.tb_time_tile(spec, physics,
                                                           *args, dom=dom)))
        COMPARED[ker.schedule_name(plan)] += 1
        COMPARED_BF16[physics.name, ker.schedule_name(plan)] += 1
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
    return worst_p, worst_f, margin, abs_p, plain_ms


def to_bf16_args(args, dtype=BF16):
    """Kernel operands in bf16 (or `dtype`): fields, params, source values
    and receiver weights (coordinates stay int32)."""
    pads, ppads, sc, sv, rc, rw = args
    return (tuple(f.to(dtype) for f in pads),
            tuple(f.to(dtype) for f in ppads), sc, sv.to(dtype), rc,
            rw.to(dtype))


def phase_kernel_vs_plain_bf16_mp(dev):
    """Kernel B1b-bf16 on the small TTI and elastic cases of
    SMALL_MP_CASES at the orders it is built for (`stencil_tb.bf16_built`),
    each on every schedule it has there (the first, z-streamed and B5),
    and one batch of two shots each.  Raises unless every schedule was
    held for both."""
    for name in ("tti", "elastic"):
        physics = phys.PHYSICS[name]
        worst = (0.0, 0.0, math.inf)
        for i, (T, tile, order, shape, sources) in enumerate(SMALL_MP_CASES):
            state, params, g, gr, dt = small_case(
                name, shape, order, 3 if sources else 0, 4, i, dev)
            plan = TBPlan(tile, T, physics.step_radius(order))
            spec, args = kernel_inputs(physics, plan, state, params, g, gr,
                                       dt, 1, SMALL_SPACING, order=order)
            if not ker.bf16_built(spec, physics):
                continue      # the orders the bf16 paths launch are built
            dp, df, margin, _, _ = compare_bf16(
                dataclasses.replace(spec, dtype=BF16), physics,
                to_bf16_args(args), args)
            worst = (max(worst[0], dp), max(worst[1], df),
                     min(worst[2], margin))
            say("kernel-vs-plain-bf16", f"{name} T={T} tile={tile} "
                f"order={order} shape={shape} sources={sources} "
                f"({len(schedules(spec, physics))} schedules): max|diff|/"
                f"max|plain| vs plain bf16 {dp:.3e} (limit 2^-6 per field "
                f"and channel), max|diff| vs float32 kernel {df:.3e} (least "
                f"margin to 0.1 max|f32| + 1e-2: {margin:.3e})")
        T, tile, order, shape, nsrcs = BATCHED_CASES[0]
        states, sparse, params = [], [], None
        for b, ns in enumerate(nsrcs[:2]):
            st, prm, g, gr, dt = small_case(name, shape, order, ns, 4,
                                            50 + b, dev)
            params = params or prm
            states.append(st)
            sparse.append((g, gr))
        spec, args = batch_operands(
            physics, TBPlan(tile, T, physics.step_radius(order)), order, dt,
            SMALL_SPACING, states, params, sparse, 1)
        dp, df, margin, _, _ = compare_bf16(
            dataclasses.replace(spec, dtype=BF16), physics,
            to_bf16_args(args), args)
        held = {s: COMPARED_BF16[name, s]
                for s in ("first", "z-streamed", "cluster")}
        say("kernel-vs-plain-bf16", f"{name} B=2 T={T} tile={tile}: "
            f"max|diff|/max|plain| vs plain bf16 {dp:.3e}, max|diff| vs "
            f"float32 kernel {df:.3e} (least margin {margin:.3e}); small "
            f"cases worst {worst[0]:.3e} / {worst[1]:.3e}, least margin "
            f"{worst[2]:.3e}; bf16 launches held by schedule {held}")
        if not all(held.values()):
            raise AssertionError(f"{name}: a bf16 schedule was not held "
                                 f"against the plain version: {held}")


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
        dp, df, margin, _, _ = compare_bf16(bspec, physics,
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
    dp, df, margin, _, _ = compare_bf16(
        dataclasses.replace(spec, dtype=BF16), physics, to_bf16_args(args),
        args)
    say("kernel-vs-plain-bf16", f"acoustic B={len(nsrcs)} T={T} tile={tile}:"
        f" max|diff|/max|plain| vs plain bf16 {dp:.3e}, max|diff| vs "
        f"float32 kernel {df:.3e} (least margin {margin:.3e}); small cases "
        f"worst {worst[0]:.3e} / {worst[1]:.3e}, least margin "
        f"{worst[2]:.3e}")


def bf16_case(fc):
    """`fc` with its state and params in bf16."""
    return dataclasses.replace(
        fc, state=tuple(f.to(BF16) for f in fc.state),
        params=type(fc.params)(*(p.to(BF16) for p in fc.params)))


def bf16_tile(spec, physics, args32, per_launch, phase, what, smi):
    """The bf16 kernel on one tile (`args32`, float32 values, in bf16)
    against the plain bf16 version and the float32 kernel
    (`compare_bf16`), beside its time: the median of `per_launch`, the
    run's full-depth launches (CUDA events, `counted_run`); prints a line
    and returns (max|diff| vs plain, kernel ms, plain ms, bound ms, bound
    by)."""
    bspec = dataclasses.replace(spec, dtype=BF16)
    bargs = to_bf16_args(args32)
    dp, df, margin, dp_abs, plain_ms = compare_bf16(bspec, physics, bargs,
                                                    args32)
    k_ms = statistics.median(per_launch)
    cost = ker.kernel_cost(bspec, physics)
    bound, by = bound_of(cost)
    say(phase, f"{what}: max|diff|/max|plain| vs plain bf16 {dp:.3e} "
        f"(limit 2^-6), max|diff| vs float32 kernel {df:.3e} (least margin "
        f"to 0.1 max|f32| + 1e-2: {margin:.3e}); {k_ms:.3f} ms per launch "
        f"(median of the run's {len(per_launch)}; least "
        f"{min(per_launch):.3f}, most {max(per_launch):.3f}) vs bound "
        f"{bound:.3f} ms by {by} ({cost['min_bytes'] / 1e9:.2f} GB), "
        f"{schedule_of(bspec, physics)} schedule, plain {plain_ms:.1f} ms "
        f"[{smi}]")
    return dp_abs, k_ms, plain_ms, bound, by


def schedule_count(fc, plan, dtype=BF16):
    """(the schedule of `plan`'s full-depth launches of `fc` in `dtype`,
    how many of a run's launches take it: the full-depth ones, and the
    remainder's where its own halo takes it too)."""
    r = fc.physics.step_radius(fc.order)

    def kind(T):
        spec = ops.make_spec(SHAPE, TBPlan(plan.tile, T, r), fc.order,
                             fc.dt, fc.spacing, 1, 1, dtype, fc.physics)
        return ker.schedule_name(ker.launch_plan(spec, fc.physics))

    full, rem = kind(plan.T), fc.nt % plan.T
    return full, fc.nt // plan.T + (bool(rem) and kind(rem) == full)


def bf16_entry(name, source, launches, tile, schedule):
    """A bf16 kernel's kernels-line entry from `bf16_tile`'s figures."""
    err, ms, plain_ms, bound, by = tile
    return {"name": name, "route": "cuda", "source": source,
            "replaces": "src/repro/kernels/stencil_tb.py:129",
            "launches": launches, "max_abs_err": err, "ms": ms,
            "plain_ms": plain_ms, "bound_ms": bound, "bound_by": by,
            "library_ms": None, "schedule": schedule}


def phase_main_bf16(fc, smi, final32, recs32, tb_ms, peak32):
    """The 512^3 paper case of `fc`'s physics in bf16 through its entry
    point (bf16 state and params: kernel B1a-bf16 acoustic, B1b-bf16 TTI
    and elastic) at the main path's plan and depth (or MAIN_BF16_MS'):
    one run, launches counted (every one in bf16 on the float32 run's
    schedule), timed, its peak beside `ops.propagation_bytes`' and the
    float32 run's, its drift from the float32 run (`final32`, `recs32`)
    printed, not held to a bound: the traces' over the steps both ran, the
    final fields' where the depths are equal; then one mid-run tile of the
    float32 run's live state against the plain bf16 version and the
    float32 kernel (`bf16_tile`).  Returns (the kernels-line entry, the
    bf16 run's (final, traces))."""
    name = fc.physics.name
    phase = f"main-{name}-bf16"
    plan = plan_for(fc.physics, T_TB)
    nt = fc.nt
    if name in MAIN_BF16_MS:
        nt = dataclasses.replace(fc.case,
                                 time_ms=MAIN_BF16_MS[name]).nt(fc.dt)
    fcb = dataclasses.replace(bf16_case(fc), nt=nt)
    spec = ops.make_spec(SHAPE, plan, fc.order, fc.dt, fc.spacing, 1, 1,
                         BF16, fc.physics)
    kind, on_kind = schedule_count(fcb, plan)
    final, recs, launches, ms, per_launch, peak, by_schedule = \
        counted_run(fcb, plan)
    expect = -(-nt // T_TB)
    if (launches != expect or by_schedule[kind] != on_kind
            or final[0].dtype != BF16 or recs.dtype != BF16):
        raise AssertionError(f"{phase}: {launches} launches ({by_schedule}"
                             f"; expected {expect}, {on_kind} on {kind}), "
                             f"dtype {final[0].dtype}")
    if not (all(torch.isfinite(f.float()).all() for f in final)
            and torch.isfinite(recs.float()).all()):
        raise AssertionError(f"{phase}: non-finite values")
    r32 = recs32[:nt].reshape(nt, NREC, -1)
    drift_tr = [max_rel(a.float(), b) for a, b in zip(
        recs.reshape(r32.shape).unbind(-1), r32.unbind(-1))]
    drift = ""
    if nt == fc.nt:
        d = max(max_rel(a.float(), b) for a, b in zip(final, final32))
        drift = f"final fields max|d|/max|f32| {d:.3e}, "
    need = ops.propagation_bytes(fc.physics, SHAPE, nt, plan, fc.order,
                                 BF16) / 2 ** 30
    cut = f" (cut depth: {MAIN_BF16_MS[name]:g} ms)" if nt != fc.nt else ""
    say(phase, f"{SHAPE} nt={nt}{cut} T={T_TB} in bf16: {launches} kernel "
        f"launches in bf16 ({on_kind} on the {kind} schedule: "
        f"{by_schedule}), run {ms:.1f} ms = {ms / launches:.3f} ms a time "
        f"tile (float32 {tb_ms:.1f} ms at nt {fc.nt} = "
        f"{tb_ms / -(-fc.nt // T_TB):.3f} ms a time tile); peak "
        f"{peak:.2f} GiB (float32 {peak32:.2f} GiB; ops.propagation_bytes "
        f"in bf16 {need:.2f} GiB); vs the float32 run: {drift}traces "
        "max|d|/max|f32| per channel " + ", ".join(
            f"{d:.3e}" for d in drift_tr) + f" ({nt} steps of bf16 "
        f"rounding; not held to a bound) [{smi}]")
    t0 = (fc.nt // T_TB // 2) * T_TB
    tspec, args = kernel_inputs(fc.physics, plan, final32,
                                fc.params._asdict(), fc.g, fc.gr, fc.dt, t0,
                                fc.spacing)
    tile = bf16_tile(tspec, fc.physics, args, per_launch,
                     "kernel-vs-plain-bf16", f"tb_{name} bf16 at {SHAPE} "
                     f"T={T_TB} (mid-run live state)", smi)
    del args
    return bf16_entry(f"stencil_tb.tb_{name} (bf16)",
                      f"src/repro_torch/kernels/csrc/{KERNEL_FILES[name]}.cu",
                      launches, tile, schedule_of(spec, fc.physics)), \
        (final, recs)


def phase_sharded_acoustic_bf16(fc, smi, single, tb_ms):
    """sharded-acoustic's 2x2 single-controller mesh of the 512^3
    acoustic case (the same plan) in bf16: kernel B1c-bf16 on every pass,
    launches and exchange rounds counted, the run timed; its fields and
    traces against main-acoustic-bf16's single-device run (`single`),
    held bit-equal (and within 2^-6 of each one's max), after that run
    repeated is held bit-equal to itself; then B1c-bf16 on a mid-run pass
    (four shard rows, their params and masks) against the plain bf16
    version and the float32 kernel.  Returns its kernels-line entry."""
    phase = "sharded-acoustic-bf16"
    final, recs = single
    physics = fc.physics
    fcb = bf16_case(fc)
    # the receivers' segment sum does not hang on the order in which the
    # card's atomic adds land (`ops.combine_rec_partials`): the run again
    # gives the same traces
    again = fcb.run(plan_for(physics, T_TB))
    repeat = [torch.equal(a, b)
              for a, b in zip((*again[0], again[1]), (*final, recs))]
    say(phase, f"main-acoustic-bf16's run repeated: fields and traces "
        f"bit-equal to the first: {repeat}")
    if not all(repeat):
        raise AssertionError(f"{phase}: the single-device bf16 run differs "
                             f"from itself: {repeat}")
    del again
    plan = dist_plan(physics, SHAPE, fc.dt, fc.spacing, fc.state[0].device)
    mid = (fc.nt // plan.T) // 2
    captured = []

    def capture(spec, p, *args, dom=None, param_copies=None):
        captured.append((spec, args, dom) if len(captured) == mid else None)
        return ker.tb_time_tile(spec, p, *args, dom=dom,
                                param_copies=param_copies)

    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    ops.EXECUTORS["cuda"] = capture
    try:
        ms, ((st, rec), launches, rounds) = cuda_ms(lambda: sharded_run(
            plan, fc.nt, fcb.state, fcb.params._asdict(), fc.g, fc.gr,
            phase))
    finally:
        ops.EXECUTORS["cuda"] = ker.tb_time_tile
    peak = torch.cuda.max_memory_allocated() / 2 ** 30
    if st[0].dtype != BF16 or rec.dtype != BF16:
        raise AssertionError(f"{phase}: dtype {st[0].dtype}")
    errs, same = field_errors(
        physics, (tuple(f.float() for f in st), rec.float()),
        (tuple(f.float() for f in final), recs.float()))
    worst = check_errors(phase, errs, BF16_PLAIN_RTOL,
                         "vs the single-device bf16 run")
    if not same:
        raise AssertionError(f"{phase}: not bit-equal to the single-device "
                             f"bf16 run: {errs}")
    say(phase, f"{SHAPE} nt={fc.nt} in bf16 on a {MESH} mesh of "
        f"{plan.block} blocks (one card), T={plan.T} tile "
        f"{plan.inner_tile}: {launches} kernel launches (4 shard rows each),"
        f" {rounds} exchange rounds, run {ms:.1f} ms (single-device "
        f"float32 TB {tb_ms:.1f} ms), peak {peak:.2f} GiB; vs the "
        f"single-device bf16 run: " + ", ".join(
            f"{k} {v:.2e}" for k, v in errs.items())
        + f" (max {worst:.3e}, limit 2^-6), bit-equal: {same} [{smi}]")
    del st, rec, final, recs, single
    spec, args, dom = next(c for c in captured if c is not None)
    del captured
    args32 = to_bf16_args(args, torch.float32)
    dp, df, margin, dp_abs, plain_ms = compare_bf16(spec, physics, args,
                                                    args32, dom=dom)
    k_ms, lo, hi, _ = time_kernel(spec, physics, args, dom=dom)
    rows = args[0][0].shape[0]
    cost = ker.kernel_cost(spec, physics, shots=rows, shard_rows=True)
    bound, by = bound_of(cost)
    say(phase, f"kernel B1c-bf16, {rows} shard rows at grid ({spec.nx}, "
        f"{spec.ny}, {spec.nz}) + halo {spec.halo}, tile {spec.tile}: "
        f"{k_ms:.3f} ms per launch (median of 3 means of 5; least {lo:.3f}, "
        f"most {hi:.3f}) vs bound {bound:.3f} ms by {by} "
        f"({cost['min_bytes'] / 1e9:.2f} GB); plain {plain_ms:.1f} ms; "
        f"max|diff|/max|plain| vs plain bf16 {dp:.3e} (limit 2^-6), "
        f"max|diff| vs float32 kernel {df:.3e} (least margin {margin:.3e}) "
        f"[{smi}]")
    return bf16_entry(
        "stencil_tb.tb_acoustic (sharded pass in bf16: per-shard params and "
        f"domain mask, {rows} shard rows)",
        "src/repro_torch/kernels/csrc/stencil_tb.cu", launches,
        (dp_abs, k_ms, plain_ms, bound, by), schedule_of(spec, physics))


# the order-8 paper cases run in bf16 on B5 (paper-<physics>-O8-bf16),
# at PAPER_BF16_MS simulated ms (nt 33 for TTI, 55 for elastic): an
# eighth of the paper's depth, cut below the float32 runs' to keep the
# script inside its limit (the bf16 phases are cut first)
PAPER_BF16 = [("tti", 8), ("elastic", 8)]
PAPER_BF16_MS = 64.0


def phase_paper_bf16(name, order, smi, dev, record):
    """A paper case of `PAPER_BF16` in bf16 at the float32 run's plan
    (`record`, its phase's) and PAPER_BF16_MS: kernel B1b-bf16 on the
    cluster-shared trapezoid (B5), one counted run (every launch whose
    shape takes B5 on it), timed beside the float32 run, its peak beside
    `ops.propagation_bytes`'; then the kernel on a mid-run tile of the
    bf16 run's final state (in float32, the same values) against the plain
    bf16 version and the float32 kernel.  Returns its kernels-line
    entry."""
    phase = f"paper-{name}-O{order}-bf16"
    fc = full_case(name, dev, order=order, time_ms=PAPER_BF16_MS)
    r = fc.physics.step_radius(order)
    plan = TBPlan(tuple(record["tile"]), record["T"], r)
    fcb = bf16_case(fc)
    fc.state = None
    spec = ops.make_spec(SHAPE, plan, order, fc.dt, fc.spacing, 1, 1, BF16,
                         fc.physics)
    schedule = schedule_of(spec, fc.physics)
    kind, expect = schedule_count(fc, plan)
    final, recs, launches, ms, per_launch, peak, by_schedule = \
        counted_run(fcb, plan)
    if (kind != "cluster" or by_schedule[kind] != expect
            or final[0].dtype != BF16):
        raise AssertionError(f"{phase}: {by_schedule} ({kind}, expected "
                             f"{expect} B5 launches), dtype "
                             f"{final[0].dtype}")
    if not (all(torch.isfinite(f.float()).all() for f in final)
            and torch.isfinite(recs.float()).all()):
        raise AssertionError(f"{phase}: non-finite values")
    del recs
    need = ops.propagation_bytes(fc.physics, SHAPE, fc.nt, plan, order,
                                 BF16) / 2 ** 30
    say(phase, f"{fc.case.name} in bf16: nt={fc.nt} (cut depth: "
        f"{PAPER_BF16_MS:g} of the paper's 512 ms), tile {plan.tile} "
        f"T={plan.T}, {schedule}: {launches} kernel launches "
        f"({by_schedule}), run {ms:.1f} ms (float32 "
        f"{record['TB']['ms']:.1f} ms at nt {record['nt']}; its kernel "
        f"{record['TB']['kernel_ms']:.3f} ms a depth-{plan.T} launch); "
        f"peak {peak:.2f} GiB (float32 "
        f"{record['TB']['peak_gib']:.2f} GiB; ops.propagation_bytes in bf16 "
        f"{need:.2f} GiB) [{smi}]")
    t0 = (fc.nt // plan.T // 2) * plan.T
    tspec, args = kernel_inputs(fc.physics, plan,
                                tuple(f.float() for f in final),
                                fc.params._asdict(), fc.g, fc.gr, fc.dt, t0,
                                fc.spacing, order=order)
    del final, fcb
    tile = bf16_tile(tspec, fc.physics, args, per_launch, phase,
                     f"B5 tb_{name} bf16 on the tile at step {t0} of the "
                     "bf16 run", smi)
    del args, fc
    torch.cuda.empty_cache()
    return bf16_entry(f"stencil_tb.tb_{name}_cluster_O{order} (bf16)",
                      f"src/repro_torch/kernels/csrc/{KERNEL_FILES[name]}.cu",
                      by_schedule[kind], tile, schedule)


# ---------------------------------------------------------------------------
# Kernel B2 (the Mamba2 SSD chunked scan) and the Mamba2 serving path
# ---------------------------------------------------------------------------

SSD_RTOL, SSD_ATOL = 1e-4, 1e-5          # tests/test_kernel_ssd.py
SSD_FIELD_RTOL = 1e-5                    # max|diff| / max|plain|
# (B, S, H, G, N, P, Q): tests/test_kernel_ssd.py's shapes (B2's float32-core
# schedule), then mamba2-130m's head shape (N 128, P 64, Q 64: the
# tensor-core schedule with bf16 inputs) with one chunk and with two groups,
# mamba2-130m's serve shape (24 heads of 64, state 128, chunk 64; 8 x 1024)
# and zamba2-2.7b's (80 heads of 64, state 64, chunk 128: the tensor-core
# schedule with bf16 inputs too)
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


@contextlib.contextmanager
def patched(owner, name, value):
    """`owner.name` set to `value` for the block (the port itself never
    does that)."""
    first = getattr(owner, name)
    setattr(owner, name, value)
    try:
        yield
    finally:
        setattr(owner, name, first)


def forced_schedule(name):
    """B2's launches take the schedule `name`, whatever `ssd.schedule_of`
    would pick (the C entry still refuses a shape the schedule does not
    take)."""
    return patched(ssd, "schedule_of", lambda *a: name)


def ssd_design(spec, schedule):
    """B2's design at this shape on `schedule`: ptxas registers and spill
    stores of its float32-y kernel (the tensor-core one instantiated at
    this (N, P, Q)), dynamic shared memory a block, blocks an SM (the
    occupancy API), and waves over the card's SMs."""
    b = _build.build_all(["ssd_scan"])["ssd_scan"]
    lib = ssd._bind()
    sched = ssd.SCHEDULES.index(schedule)
    name = (f"ssd_scan_tc_kernelILi{spec.state}ELi{spec.headdim}"
            f"ELi{spec.chunk}EfE" if schedule == "tensor cores"
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
    with forced_schedule("float32 cores"):
        ms_f32, _, _ = timed()
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
    `ssd.schedule_of` picks (the tensor cores, instantiated at (N, P, Q) =
    (64, 64, 128)): held against ssd_scan_plain (its time is that call's),
    timed as the mamba2-130m shape is, with the float32-core schedule on
    the same inputs beside it; its bound as `phase_kernel_vs_plain_ssd`'s:
    from `ssd.kernel_cost` at the card's rate for bf16 inputs (the tensor
    cores), with the float32-core bound beside it; and a `design:` line a
    schedule.  Returns the kernels-line entry (launches set by
    serve-zamba2)."""
    phase = "kernels-ssd-zamba2"
    shape = ZAMBA2_SSD_SHAPE
    spec, args, _ = ssd_case(shape, 7, BF16, False, dev)
    schedule = ssd.schedule_of(spec, BF16)
    if schedule != "tensor cores":
        raise AssertionError(f"{phase}: {schedule} schedule at {shape}, "
                             f"expected the tensor cores")
    launch = lambda: ssd.ssd_scan(spec, *args)  # noqa: E731
    plain_ms, (py, _) = cuda_ms(lambda: ssd.ssd_scan_plain(spec, *args))
    err = check_ssd(f"y {shape}", uncounted(launch)[0], py)[0]
    del py

    def timed():
        means = [uncounted(lambda: cuda_ms(launch, reps=5))[0]
                 for _ in range(3)]
        return statistics.median(means), min(means), max(means)

    ms, lo, hi = timed()
    with forced_schedule("float32 cores"):
        ms_f32, lo_f32, hi_f32 = timed()
    if not ms < ms_f32:
        raise AssertionError(f"{phase}: the tensor cores ({ms:.3f} ms) are "
                             f"not faster than the float32 cores "
                             f"({ms_f32:.3f} ms)")
    cost = ssd.kernel_cost(spec, shape[0], in_dtype=BF16)
    t_bytes = cost["min_bytes"] / HBM_BW * 1e3
    t_tc = cost["needed_flops"] / BF16_TC_PEAK * 1e3
    t_f32 = cost["needed_flops"] / F32_PEAK * 1e3
    bound, by = max(t_bytes, t_tc), ("bytes" if t_bytes >= t_tc
                                     else "operations")
    say(phase, f"ssd_scan at (B,S,H,G,N,P,Q)={shape} (zamba2-2.7b), bf16 "
        f"x/B/C, float32 y, {schedule} schedule: {ms:.3f} ms per launch "
        f"(median of 3 means of 5; least {lo:.3f}, most {hi:.3f}) vs bound "
        f"{bound:.4f} ms by {by} ({cost['min_bytes'] / 1e6:.1f} MB in "
        f"{t_bytes:.4f} ms; {cost['needed_flops'] / 1e9:.2f} GFLOP needed, "
        f"causal halves only, in {t_tc:.4f} ms at 989 TFLOP/s bf16 on the "
        f"tensor cores); the float32-core schedule on the same inputs "
        f"{ms_f32:.3f} ms (least {lo_f32:.3f}, most {hi_f32:.3f}; "
        f"{ms_f32 / ms:.2f}x), its bound {max(t_bytes, t_f32):.3f} ms (the "
        f"same work in {t_f32:.3f} ms at 67 TFLOP/s); y max|diff| "
        f"{err:.3e} against plain ({plain_ms:.1f} ms); no single PyTorch "
        f"call computes a chunked scan, so no library time [{smi}]")
    blocks = shape[0] * shape[2]
    sms = torch.cuda.get_device_properties(0).multi_processor_count
    for name in ssd.SCHEDULES:
        regs, spill, smem, per_sm = ssd_design(spec, name)
        say(phase, f"design: {name} schedule at zamba2-2.7b's shape, "
            f"{blocks} blocks (one a (batch, head)): {regs} registers, "
            f"{spill} B spill stores, {smem} B shared a block, {per_sm} "
            f"block(s) an SM, {blocks / (per_sm * sms):.2f} waves on {sms} "
            f"SMs")
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
        "float32_core_ms": ms_f32,
        "float32_core_bound_ms": max(t_bytes, t_f32),
    }


SERVE_SEED = 0
# a bf16 model's prefill logits with B2 against the plain scan's: at most
# twice the gap a scan one float32 ulp from the plain one makes (`ulp_scan`),
# as tests/test_torch_zamba2.py holds served logits within twice the
# reference's own gap.  At full width with random parameters that control
# moves the logits by ~46-48% of max|logits| (ROADMAP C6), so ROADMAP C2's
# 2^-5 is printed beside it but holds for no scan that is not bit-equal.
BF16_LOGITS_CONTROLS = 2
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


def with_scan(scan, fn):
    """fn() with the model's scan replaced by `scan` (the model itself
    never does that)."""
    with patched(ssd, "ssd_scan", scan):
        return fn()


def with_plain_scan(fn):
    """fn() with the model's scan running `ssd_scan_plain`."""
    return with_scan(ssd.ssd_scan_plain, fn)


def ulp_scan(seed=0):
    """A control scan: `ssd_scan_plain` with each element of y moved by one
    float32 ulp, up or down by a random sign drawn from `seed`; as far
    from the plain scan as float32 rounding alone."""
    gens = {}

    def scan(spec, *args, h0=None):
        y, h = ssd.ssd_scan_plain(spec, *args, h0=h0)
        gen = gens.setdefault(y.device, torch.Generator(
            device=y.device).manual_seed(seed))
        up = torch.rand(y.shape, generator=gen, device=y.device) < 0.5
        away = torch.where(up, torch.inf, -torch.inf).to(y.dtype)
        return torch.nextafter(y, away), h

    return scan


def bf16_logits_gap(phase, cfg, logits, prefill):
    """A scanning model's bf16 prefill logits with B2 (`logits`) against
    the plain scan's (`prefill()` under `with_plain_scan`), beside the
    `ulp_scan` control's: max|diff| / max|plain logits| over every
    position and at the last one; raises past BF16_LOGITS_CONTROLS times
    the control's gap."""
    plain = with_plain_scan(prefill).float()
    ctrl = with_scan(ulp_scan(), prefill).float()
    scale = float(plain.abs().max())
    gaps = {}
    for name, got in (("B2", logits.float()), ("control", ctrl)):
        d = (got - plain).abs()
        gaps[name] = (float(d.max()) / scale, float(d[:, -1].max()) / scale)
    del plain, ctrl
    (gap, last), (c_gap, c_last) = gaps["B2"], gaps["control"]
    say(phase, f"bf16 prefill logits {tuple(logits.shape)} with B2 "
        f"({scan_schedule(cfg)}) vs ssd_scan_plain: max|diff|/max|logits| "
        f"{gap:.3e} (last position {last:.3e}); the plain scan with y "
        f"moved one float32 ulp {c_gap:.3e} (last {c_last:.3e}); limit "
        f"{BF16_LOGITS_CONTROLS} x the control {BF16_LOGITS_CONTROLS * c_gap:.3e}"
        f" (2^-5 = {2 ** -5:.3e}: {'within' if gap <= 2 ** -5 else 'beyond'}"
        f", the control {'within' if c_gap <= 2 ** -5 else 'beyond'})")
    if gap > BF16_LOGITS_CONTROLS * c_gap:
        raise AssertionError(f"{phase}: bf16 prefill logits with B2 vs "
                             f"plain {gap:.3e} > {BF16_LOGITS_CONTROLS} x "
                             f"the one-ulp control's {c_gap:.3e}")


# the serve phases: one model each, at its published widths and depth
SERVE_ARCHS = {"serve-mamba2": "mamba2-130m", "serve-zamba2": "zamba2-2.7b",
               "serve-qwen3": "qwen3-1.7b",
               "serve-qwen3moe": "qwen3-moe-30b-a3b",
               "serve-whisper": "whisper-medium",
               "serve-llava": "llava-next-mistral-7b"}


def scan_schedule(cfg):
    """The B2 schedule a bf16 prefill of this scanning model takes
    (`models.mamba2.block_forward`'s call: x, B and C in bf16)."""
    spec = ssd.SSDSpec(seq_len=cfg.ssm_chunk, chunk=cfg.ssm_chunk,
                       nheads=1, ngroups=cfg.ssm_ngroups,
                       headdim=cfg.ssm_headdim, state=cfg.ssm_state)
    return ssd.schedule_of(spec, BF16)


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
        f"({launches} in all"
        + (f", {scan_schedule(cfg)} schedule" if launches else "") + ")")
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
    if scan_layers(cfg):
        bf16_logits_gap(phase, cfg, logits, lambda: api.prefill(
            params, cfg, first, max_len)[0])
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


# ---------------------------------------------------------------------------
# Training: mamba2-130m at full width, a gradient through kernel B2
# ---------------------------------------------------------------------------

TRAIN_ARCH = "mamba2-130m"
TRAIN_SEED = 0
# B2 under a gradient: (label, (B, S, H, G, N, P, Q), input dtypes) at
# mamba2-130m's head shape and zamba2-2.7b's (both B2's tensor-core shapes
# in bf16), the trainer's own call in train-mamba2 (c) (the CLI's 8 x 4096
# tokens at mamba2-130m's heads in bf16, 64 chunks of carried state), a
# rank's call in train-mamba2-dp2 (its 4 x 4096 of the same global batch)
# and a rank's call in train-mamba2-tp2 (all 8 x 4096, its 12 of the 24
# heads)
GRAD_CASES = [("mamba2-130m's head shape", (2, 1024, 24, 1, 128, 64, 64),
               (torch.float32, BF16)),
              ("zamba2-2.7b's head shape", (2, 1024, 80, 1, 64, 64, 128),
               (torch.float32, BF16)),
              ("the trainer's call", (8, 4096, 24, 1, 128, 64, 64), (BF16,)),
              ("a data-parallel rank's call", (4, 4096, 24, 1, 128, 64, 64),
               (BF16,)),
              ("a model-parallel rank's call", (8, 4096, 12, 1, 128, 64, 64),
               (BF16,))]
# the main paths' calls of GRAD_CASES, timed: label -> key of B2's
# kernels-line entry
GRAD_TIMED = {"the trainer's call": "train_call",
              "a data-parallel rank's call": "dp2_call",
              "a model-parallel rank's call": "tp2_call"}
GRAD_TOL = 1e-4              # float32: max|diff| / max|plain gradient|
# bf16 inputs: the same ratio.  The backward computes in float32 from the
# same inputs as autograd through the plain version; they differ by the
# final cast to bf16 and the order of the sums.  Sound readings reach
# 2.3e-3 (dC at the trainer's call; PERF.md, PR 25), a planted wrong backward
# (PLANTED) reads far above the bound, and the phase fails unless it does.
GRAD_TOL_BF16 = 2 ** -6
TRAIN_F32_SHAPE = (1024, 2)  # (seq_len, batch) of the float32 model check
TRAIN_LOSS_RTOL = 1e-5
# the CLI at the config's own dtypes: its flags, then steps straight and
# the step the simulated preemption stops after
TRAIN_CLI = ["--arch", TRAIN_ARCH, "--seq-len", "4096", "--batch", "8",
             "--mesh", "single", "--save-every", "4", "--log-every", "1",
             "--keep", "1"]
# (six steps keep the whole script inside its time limit beside
# train-mamba2-dp2)
TRAIN_STEPS, TRAIN_STOP = 6, 4
TRAIN_TIMED = slice(2, None)     # the steps timed: 2-5
RESUME_RTOL = 1e-3               # a CUDA index-add may reorder sums
MATMUL_MARKS = ("gemm", "xmma", "cutlass", "nvjet", "gemv", "wgmma")


def _cotangent_dropped(chunked):
    """`chunked` with h_final's cotangent dropped from its gradient."""
    def planted(*a, **kw):
        y, h = chunked(*a, **kw)
        return y, h.detach() + 0 * h
    return planted


def _decay_halved(chunked):
    """`chunked` with the decay rate A halved."""
    def planted(xh, dtv, Bm, Cm, A, chunk, h0=None):
        return chunked(xh, dtv, Bm, Cm, 0.5 * A, chunk, h0=h0)
    return planted


# planted wrong backwards: `SSDScanFn.backward` differentiates
# `models.mamba2._ssd_chunked`, patched for the call to one of these
PLANTED = {"h_final's cotangent dropped": _cotangent_dropped,
           "decay rate A halved": _decay_halved}


def scan_grads(spec, args, cots, scan):
    """(gradients of (x, dt, B, C, A), (y, h_final), y's grad_fn, forward
    ms, backward ms) through `scan` (a forward that autograd records) at
    `args`, with cotangents `cots` on (y, h_final); the times by CUDA
    events around the forward and around `torch.autograd.grad`."""
    leaves = [a.detach().clone().requires_grad_() for a in args]
    ev = [torch.cuda.Event(enable_timing=True) for _ in range(3)]
    torch.cuda.synchronize()
    ev[0].record()
    y, h = scan(spec, *leaves)
    ev[1].record()
    grads = torch.autograd.grad((y, h), leaves, cots)
    ev[2].record()
    torch.cuda.synchronize()
    return (grads, (y.detach(), h.detach()), y.grad_fn,
            ev[0].elapsed_time(ev[1]), ev[1].elapsed_time(ev[2]))


def grad_gaps(got, want, what):
    """{name: max|diff| / max|plain gradient|} of (dx, ddt, dB, dC, dA);
    raises where a gradient is not finite or not in its input's dtype."""
    gaps = {}
    for name, g, w in zip(("dx", "ddt", "dB", "dC", "dA"), got, want):
        if g.dtype != w.dtype or not torch.isfinite(g).all():
            raise AssertionError(f"train-mamba2: {name} at {what}: dtype "
                                 f"{g.dtype} or not finite")
        gaps[name] = max_rel(g.float(), w.float())
    return gaps


def phase_train_grads(dev, smi, entry):
    """(a) B2's forward and the backward formula under a gradient:
    `ssd.ssd_scan` on grad-requiring card tensors goes through `SSDScanFn`
    (forward B2, backward the autodiff of `_ssd_chunked`), against
    `torch.autograd` straight through `ssd_scan_plain` on the same
    tensors, at each of GRAD_CASES (the trainer's own call among them).
    The forward's y and h_final held to the kernels-ssd bounds
    (`check_ssd`); the gradients of x, dt, B, C and A, with random
    cotangents on y and h_final, within GRAD_TOL (float32 inputs, B2's
    float32-core schedule) or GRAD_TOL_BF16 (bf16, the tensor cores) of
    max|plain gradient|, each.  At mamba2-130m's head shape in bf16 each
    of PLANTED must read beyond GRAD_TOL_BF16.  At each call of GRAD_TIMED
    (the trainer's, a data-parallel rank's), B2's ms a launch beside its
    bound, and the two backwards' ms: `SSDScanFn`'s (`_ssd_chunked`
    recomputed and differentiated) and autograd's through
    `ssd_scan_plain`.  `entry` (B2's kernels-line entry at mamba2-130m's
    head shape) gets each under its GRAD_TIMED key."""
    from repro_torch.models import mamba2

    phase = "train-mamba2"
    for label, shape, dtypes in GRAD_CASES:
        for dtype in dtypes:
            spec, args, _ = ssd_case(shape, 11, dtype, False, dev)
            gen = torch.Generator(device=dev).manual_seed(12)
            Bsz, S_, Hh, G, N, P, Q = shape
            cots = (torch.randn((Bsz, S_, Hh, P), generator=gen, device=dev),
                    torch.randn((Bsz, Hh, N, P), generator=gen, device=dev))
            got, (y, h), fn, fwd_ms, bwd_ms = uncounted(
                lambda: scan_grads(spec, args, cots, ssd.ssd_scan))
            want, (py, ph), _, pfwd_ms, pbwd_ms = scan_grads(
                spec, args, cots, ssd.ssd_scan_plain)
            if type(fn).__name__ != "SSDScanFnBackward":
                raise AssertionError(f"{phase}: ssd_scan under grad recorded "
                                     f"{type(fn).__name__}, not SSDScanFn")
            what = f"{shape} {str(dtype)[6:]}"
            ey = check_ssd(f"{phase}: y {what}", y, py)
            eh = check_ssd(f"{phase}: h_final {what}", h, ph)
            gaps = grad_gaps(got, want, what)
            worst = max(gaps.values())
            tol = GRAD_TOL if dtype == torch.float32 else GRAD_TOL_BF16
            say(phase, f"B2 under a gradient at {label} (B,S,H,G,N,P,Q)="
                f"{shape}, {str(dtype)[6:]} inputs "
                f"({ssd.schedule_of(spec, dtype)} forward): forward y "
                f"max|diff| / max|plain| {ey[1]:.2e}, h_final {eh[1]:.2e} "
                f"(limit {SSD_FIELD_RTOL:g}); gradients max|diff| / max|plain "
                f"grad| " + ", ".join(f"{k} {v:.2e}" for k, v in gaps.items())
                + f" (limit {tol:g}) [{smi}]")
            if worst > tol:
                raise AssertionError(f"{phase}: gradients through SSDScanFn "
                                     f"vs plain at {what}: {gaps} > {tol}")
            if label == GRAD_CASES[0][0] and dtype == BF16:
                for name, plant in PLANTED.items():
                    with patched(mamba2, "_ssd_chunked",
                                 plant(mamba2._ssd_chunked)):
                        bad = uncounted(lambda: scan_grads(
                            spec, args, cots, ssd.ssd_scan))[0]
                    planted = grad_gaps(bad, want, what)
                    say(phase, f"planted wrong backward ({name}) at {what}: "
                        + ", ".join(f"{k} {v:.2e}" for k, v in
                                    planted.items())
                        + f"; worst {max(planted.values()):.2e} against the "
                        f"limit {tol:g}")
                    if max(planted.values()) <= tol:
                        raise AssertionError(f"{phase}: the bf16 gradient "
                                             f"bound passes a planted wrong "
                                             f"backward ({name})")
                    del bad
            if label in GRAD_TIMED:
                # the times of a second call each (the first at a shape
                # also grows the caching allocator's pools)
                fwd_ms, bwd_ms = uncounted(lambda: scan_grads(
                    spec, args, cots, ssd.ssd_scan))[3:]
                pfwd_ms, pbwd_ms = scan_grads(spec, args, cots,
                                              ssd.ssd_scan_plain)[3:]
                launch = lambda: ssd.ssd_scan(spec, *args)  # noqa: E731
                ms = uncounted(lambda: cuda_ms(launch, reps=5))[0]
                plain_ms = cuda_ms(lambda: ssd.ssd_scan_plain(spec, *args))[0]
                cost = ssd.kernel_cost(spec, Bsz, in_dtype=dtype)
                t_bytes = cost["min_bytes"] / HBM_BW * 1e3
                t_ops = cost["needed_flops"] / BF16_TC_PEAK * 1e3
                bound = max(t_bytes, t_ops)
                by = "bytes" if t_bytes >= t_ops else "operations"
                say(phase, f"B2 at {label} {shape} bf16: {ms:.3f} ms a "
                    f"launch (mean of 5) vs bound {bound:.4f} ms by {by} "
                    f"({cost['min_bytes'] / 1e6:.1f} MB in {t_bytes:.4f} ms; "
                    f"{cost['needed_flops'] / 1e9:.2f} GFLOP in {t_ops:.4f} "
                    f"ms at 989 TFLOP/s); plain {plain_ms:.2f} ms; under a "
                    f"gradient (a second call "
                    f"each): SSDScanFn forward {fwd_ms:.2f} ms, backward "
                    f"{bwd_ms:.2f} ms (_ssd_chunked "
                    f"recomputed and differentiated); autograd through "
                    f"ssd_scan_plain: forward {pfwd_ms:.2f} ms, backward "
                    f"{pbwd_ms:.2f} ms [{smi}]")
                entry[GRAD_TIMED[label]] = {
                    "shape": list(shape), "ms": ms, "bound_ms": bound,
                    "bound_by": by, "max_abs_err": ey[0],
                    "plain_ms": plain_ms, "grad_gaps": gaps,
                    "backward_ms": bwd_ms, "plain_backward_ms": pbwd_ms}
            del got, want, args, cots, y, h, py, ph
    torch.cuda.empty_cache()


def phase_train_f32(dev, smi):
    """(b) One training step's loss and gradients
    (`steps.loss_and_grads`, what `make_train_step` differentiates) for
    mamba2-130m at full width in float32 (TRAIN_F32_SHAPE), with B2 (the
    float32-core schedule) against the same step with `ssd_scan` replaced
    by `ssd_scan_plain` under autograd: the loss within TRAIN_LOSS_RTOL;
    the global gradient norm's relative gap and the worst leaf's
    max|diff g| / max|g| printed."""
    from repro_torch.configs.base import ShapeConfig
    from repro_torch.data.pipeline import make_batch
    from repro_torch.launch import steps
    from repro_torch.optim import global_norm
    from repro_torch.tree import tree_leaves

    phase = "train-mamba2"
    cfg = dataclasses.replace(configs.get(TRAIN_ARCH),
                              param_dtype="float32",
                              activation_dtype="float32")
    params = api.init(TRAIN_SEED, cfg, device=dev)
    batch = make_batch(cfg, ShapeConfig("train_f32", *TRAIN_F32_SHAPE,
                                        "train"), device=dev)
    (loss, _, _), grads = uncounted(lambda: steps.loss_and_grads(
        params, cfg, batch))
    (ploss, _, _), pgrads = with_plain_scan(
        lambda: steps.loss_and_grads(params, cfg, batch))
    loss, ploss = float(loss), float(ploss)
    rel = abs(loss - ploss) / abs(ploss)
    gn, pgn = float(global_norm(grads)), float(global_norm(pgrads))
    leaf = max(max_rel(g, w) for g, w in zip(tree_leaves(grads),
                                            tree_leaves(pgrads)))
    say(phase, f"float32 {TRAIN_ARCH} at full width ({widths(cfg)}), batch "
        f"{TRAIN_F32_SHAPE[1]} x {TRAIN_F32_SHAPE[0]}, one step's loss and "
        f"gradients with B2 vs ssd_scan_plain under autograd: loss {loss:.6f}"
        f" vs {ploss:.6f} (relative gap {rel:.2e}, limit "
        f"{TRAIN_LOSS_RTOL:g}); global gradient norm {gn:.6e} vs {pgn:.6e} "
        f"(relative gap {abs(gn - pgn) / pgn:.2e}); worst leaf max|diff g|/"
        f"max|g| {leaf:.2e} [{smi}]")
    if not (math.isfinite(loss) and rel <= TRAIN_LOSS_RTOL):
        raise AssertionError(f"{phase}: float32 loss with B2 {loss} vs plain "
                             f"{ploss}: {rel:.2e} > {TRAIN_LOSS_RTOL}")
    del params, grads, pgrads, batch
    torch.cuda.empty_cache()


def clone_tree(tree):
    """A copy of a checkpoint's tree (dicts and AdamWState) on its
    device."""
    return torch.utils._pytree.tree_map(lambda t: t.clone(), tree)


def equal_trees(got, want):
    """Whether two trees of tensors are equal bit for bit, leaf by leaf."""
    g, gspec = torch.utils._pytree.tree_flatten(got)
    w, wspec = torch.utils._pytree.tree_flatten(want)
    return gspec == wspec and all(
        a.dtype == b.dtype and a.shape == b.shape and torch.equal(
            a.reshape(-1).view(torch.uint8), b.reshape(-1).view(torch.uint8))
        for a, b in zip(g, w))


def read_losses(ckpt):
    """{step: loss} from a run's metrics.jsonl (a resumed run's lines come
    after those of the run it resumes)."""
    with open(Path(ckpt) / "metrics.jsonl") as f:
        return {r["step"]: r["loss"] for r in map(json.loads, f)}


def step_split(prof):
    """Device ms of one profiled train step by kind: B2 (kernels named
    ssd_scan, in the forward and in remat's recompute), the scan's
    autograd backward (every kernel launched under an SSDScanFnBackward
    event), matrix products (cuBLAS's kernels elsewhere) and the rest;
    the total over the card's own events beside them."""
    from torch.autograd import DeviceType

    split = {"B2": 0.0, "scan backward": 0.0, "matrix products": 0.0,
             "rest": 0.0}

    def walk(ev, in_bwd):
        in_bwd = in_bwd or "SSDScanFnBackward" in ev.name
        for k in ev.kernels:
            name = k.name.lower()
            kind = ("B2" if "ssd_scan" in name else "scan backward"
                    if in_bwd else "matrix products"
                    if any(m in name for m in MATMUL_MARKS) else "rest")
            split[kind] += k.duration / 1e3
        for ch in ev.cpu_children:
            walk(ch, in_bwd)

    events = prof.events()
    for ev in events:
        if ev.device_type == DeviceType.CPU and ev.cpu_parent is None:
            walk(ev, False)
    total = sum(e.self_device_time_total for e in events
                if e.device_type == DeviceType.CUDA) / 1e3
    return split, total


def profile_train_step(dev, cfg, shape):
    """(wall ms, device split, device total) of one bf16 train step of
    `cfg` at `shape` under torch.profiler, after one step's warm-up."""
    from torch.profiler import ProfilerActivity, profile

    from repro_torch.data.pipeline import make_batch
    from repro_torch.launch import steps
    from repro_torch.optim import AdamWConfig, adamw_init

    params = api.init(TRAIN_SEED, cfg, shape, device=dev)
    opt = adamw_init(params)
    step = steps.make_train_step(cfg, AdamWConfig())
    batch = make_batch(cfg, shape, device=dev)
    params, opt, _ = uncounted(lambda: step(params, opt, batch))
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        params, opt, _ = uncounted(lambda: step(params, opt, batch))
        torch.cuda.synchronize()
        wall = (time.perf_counter() - t0) * 1e3
    split, total = step_split(prof)
    del params, opt, prof
    torch.cuda.empty_cache()
    return wall, split, total


def phase_train_cli(dev, smi, entry):
    """(c) The trainer's CLI in-process (`repro_torch.launch.train.main`)
    for mamba2-130m at full width in the config's bf16, 8 x 4096 tokens a
    step (TRAIN_CLI), checkpoints in a temporary directory: TRAIN_STEPS
    steps straight (B2 counted: 2 x 24 launches a step under
    remat="full"), then TRAIN_STOP steps and a simulated preemption, then
    a resumed run to TRAIN_STEPS.  Holds every loss finite, the restored
    params and optimizer state bit-equal to the saved ones, and the
    resumed run's last loss within RESUME_RTOL of the straight run's.
    Prints ms a step (CUDA events around each step, median of the steps
    TRAIN_TIMED), tokens/s, peak GiB, and one profiled step's device time
    split B2 /
    the scan's autograd backward / matrix products / the rest.  `entry`
    (B2's kernels-line entry at mamba2-130m's head shape) gets the
    launches as ``train_launches``."""
    import tempfile

    from repro_torch.checkpoint import CheckpointManager
    from repro_torch.configs.base import ShapeConfig
    from repro_torch.launch import steps, train

    phase = "train-mamba2"
    argv = TRAIN_CLI + ["--steps", str(TRAIN_STEPS)]
    args = train.parse_args(argv)
    cfg = configs.get(TRAIN_ARCH)
    shape = ShapeConfig("train_cli", args.seq_len, args.batch, "train")
    tokens = args.seq_len * args.batch
    events, saved = [], {}
    make_step = steps.make_train_step

    def timed_make_step(*a, **kw):
        return timed_fn(make_step(*a, **kw), "train", events)

    save = CheckpointManager.save

    def recording_save(mgr, step, tree, *a, **kw):
        if step == TRAIN_STOP:
            saved[step] = clone_tree(tree)
        return save(mgr, step, tree, *a, **kw)

    with tempfile.TemporaryDirectory() as tmp:
        straight, resumed = str(Path(tmp) / "a"), str(Path(tmp) / "b")
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        ssd.launches = 0
        t0 = time.perf_counter()
        with patched(steps, "make_train_step", timed_make_step):
            rc = train.main(argv + ["--ckpt-dir", straight])
        wall = time.perf_counter() - t0
        launches = ssd.launches
        peak = torch.cuda.max_memory_allocated() / 2 ** 30
        torch.cuda.synchronize()
        ms = [s.elapsed_time(e) for _, s, e in events]
        if rc != 0 or len(ms) != TRAIN_STEPS:
            raise AssertionError(f"{phase}: straight run exit {rc}, "
                                 f"{len(ms)} steps timed")
        per_step = launches / TRAIN_STEPS
        want = 2 * cfg.num_layers if cfg.remat == "full" else cfg.num_layers
        if launches != want * TRAIN_STEPS:
            raise AssertionError(f"{phase}: {launches} B2 launches in "
                                 f"{TRAIN_STEPS} steps, expected {want} a "
                                 f"step (remat {cfg.remat!r})")
        entry["train_launches"] = launches
        with patched(CheckpointManager, "save", recording_save):
            rc_stop = uncounted(lambda: train.main(
                argv + ["--ckpt-dir", resumed, "--stop-after",
                        str(TRAIN_STOP)]))
        mgr = CheckpointManager(resumed)
        step, restored = mgr.restore(saved[TRAIN_STOP])
        same = step == TRAIN_STOP and equal_trees(restored,
                                                  saved[TRAIN_STOP])
        del restored, saved[TRAIN_STOP]
        rc_res = uncounted(lambda: train.main(argv + ["--ckpt-dir",
                                                      resumed]))
        a, b = read_losses(straight), read_losses(resumed)
    last = TRAIN_STEPS - 1
    gap = abs(b[last] - a[last]) / abs(a[last])
    finite = all(math.isfinite(v) for v in (*a.values(), *b.values()))
    med = statistics.median(ms[TRAIN_TIMED])
    say(phase, f"CLI {' '.join(argv)} ({widths(cfg)}, bf16, "
        f"{cfg.param_count() / 1e6:.1f} M parameters, remat {cfg.remat}): "
        f"{med:.2f} ms a step (CUDA events, median of steps "
        f"{TRAIN_TIMED.start}-{TRAIN_STEPS - 1}; all "
        + ", ".join(f"{t:.1f}" for t in ms) + f"), {tokens / med * 1e3:.0f} "
        f"tokens/s, peak {peak:.2f} GiB, B2 launches a step {per_step:g} "
        f"({cfg.num_layers} forward + {cfg.num_layers} in remat's recompute"
        f"), wall {wall:.1f} s for {TRAIN_STEPS} steps with checkpoints "
        f"[{smi}]")
    say(phase, f"losses straight " + ", ".join(f"{a[k]:.4f}" for k in
                                                sorted(a))
        + f"; stopped after {TRAIN_STOP} (exit {rc_stop}) and resumed (exit "
        f"{rc_res}): " + ", ".join(f"{b[k]:.4f}" for k in sorted(b))
        + f"; step {last} relative gap {gap:.2e} (limit {RESUME_RTOL:g}); "
        f"restored params and optimizer state bit-equal to the saved: "
        f"{same}")
    if not (finite and same and rc_stop == 0 and rc_res == 0
            and sorted(b) == list(range(TRAIN_STEPS)) and gap <= RESUME_RTOL):
        raise AssertionError(f"{phase}: resume check failed (finite "
                             f"{finite}, restored equal {same}, exits "
                             f"{rc_stop}/{rc_res}, steps {sorted(b)}, gap "
                             f"{gap:.2e})")
    wall_p, split, total = profile_train_step(dev, cfg, shape)
    attributed = sum(split.values())
    say(phase, f"one step under torch.profiler: wall {wall_p:.1f} ms, "
        f"device {total:.1f} ms (idle share "
        f"{max(wall_p - total, 0.0) / wall_p:.3f}); by the kernels' CPU "
        f"parents ({attributed:.1f} ms): " + ", ".join(
            f"{k} {v:.1f} ms ({v / max(attributed, 1e-9):.1%})"
            for k, v in split.items()) + f" [{smi}]")
    return {"ms_a_step": med, "tokens_s": tokens / med * 1e3,
            "peak_gib": peak, "b2_a_step": per_step, "losses": a}


def phase_train(dev, smi, entry):
    """train-mamba2: (a) B2's forward and the backward formula under a
    gradient, (b) the float32 model step, (c) the CLI at the config's
    dtypes (`phase_train_*`)."""
    phase_train_grads(dev, smi, entry)
    phase_train_f32(dev, smi)
    return phase_train_cli(dev, smi, entry)


# ---------------------------------------------------------------------------
# Training across processes: mamba2-130m in two data-parallel ranks
# ---------------------------------------------------------------------------

DP_WORLD = 2
DP_STEPS = 3          # DP-2 trains steps 0-2 and checkpoints after step 3
# the trainer's CLI as in train-mamba2, started in DP_WORLD processes that
# share the one card over gloo (nccl needs a card a rank); --batch stays
# the global batch, 4 x 4096 tokens a rank
DP_CLI = [("host" if a == "single" else a) for a in TRAIN_CLI] + [
    "--dist-backend", "gloo"]
DP_TIMEOUT = 600.0    # seconds for the ranks to report
# DP-2's ZeRO-1 state after two steps against the control's (one process
# fed the same rows one rank's share at a time): max|diff| / max|control|
# of master, mu and nu.  Both sum the same per-rank float32 gradients, so
# they agree but for a reordered sum: a few float32 ulps of the leaf's max
DP_CONTROL_TOL = 4 * 2 ** -24


def free_port():
    import socket

    with socket.socket() as sock:
        sock.bind(("localhost", 0))
        return sock.getsockname()[1]


def dp_rank(rank, ckpt):
    """One rank of train-mamba2-dp2 and train-mamba2-fsdp2, in a process
    of its own (`process_group.spawn_ranks`): joins the gloo group on
    cuda:LOCAL_RANK % device_count, runs the trainer's CLI
    (`launch.train.main`), the float32 check (`dp_f32_check`), then the
    FSDP steps (`fsdp_rank`)."""
    from repro_torch.distributed.process_group import DataParallel

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    group = DataParallel.start("gloo", "cuda")
    try:
        out = dp_rank_cli(group, ckpt)
        out.update(dp_f32_check(group))
        torch.cuda.empty_cache()
        out["fsdp"] = fsdp_rank(group)
        return out
    finally:
        group.close()


def dp_rank_cli(group, ckpt):
    """This rank's run of the CLI (DP_CLI, DP_STEPS steps then a
    checkpoint): B2 launches (counted from 0 just before), peak GiB, wall
    s, each step's ms (CUDA events), and each gradient reduce's ms on the
    host clock in two parts: the wait, from this rank's gradient done
    (synchronised) to a barrier that every rank has reached (the ranks
    share the card, so one waits for the other's backward), and the
    transfer, from the barrier to the reduced gradient on the card (gloo
    stages the card's buffers through the host)."""
    from repro_torch.distributed.process_group import DataParallel
    from repro_torch.launch import steps, train

    events, wait_ms, reduce_ms = [], [], []
    make_step, reduce = steps.make_train_step, DataParallel.all_reduce_grads

    def timed_make_step(*a, **kw):
        return timed_fn(make_step(*a, **kw), "train", events)

    def timed_reduce(self, grads):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        self.max(0.0)                     # the barrier
        t1 = time.perf_counter()
        out = reduce(self, grads)
        torch.cuda.synchronize()
        wait_ms.append((t1 - t0) * 1e3)
        reduce_ms.append((time.perf_counter() - t1) * 1e3)
        return out

    argv = DP_CLI + ["--steps", str(TRAIN_STEPS), "--stop-after",
                     str(DP_STEPS), "--ckpt-dir", ckpt]
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    ssd.launches = 0
    t0 = time.perf_counter()
    with patched(steps, "make_train_step", timed_make_step), \
            patched(DataParallel, "all_reduce_grads", timed_reduce):
        rc = train.main(argv)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    return {"rc": rc, "launches": ssd.launches, "wall_s": wall,
            "peak_gib": torch.cuda.max_memory_allocated() / 2 ** 30,
            "step_ms": [s.elapsed_time(e) for _, s, e in events],
            "wait_ms": wait_ms, "reduce_ms": reduce_ms, "argv": argv}


def dp_f32_check(group):
    """The float32 check of train-mamba2-dp2: mamba2-130m at full width in
    float32, the global batch TRAIN_F32_SHAPE split one row a rank, two
    data-parallel steps (`make_train_step` with rules, ZeRO-1).  On rank
    0, from the same params: the loss and the reduced gradient of step 0
    against one process on the whole batch (within TRAIN_LOSS_RTOL, and
    GRAD_TOL of max|g| per leaf); the ZeRO-1 state after the two steps,
    gathered, bit-equal to the unsharded `adamw_update` fed the same
    reduced gradients; within DP_CONTROL_TOL of a control's after its two
    steps: one process fed the same rows one rank's share at a time, their
    gradients summed in float32 (so a fault in either step's reduced
    gradient shows); and, for information, the gaps of both to the one
    process's own state on the whole batch (AdamW moves a param by about
    lr whatever its gradient's size, so a gradient element within float32
    rounding of 0 steps either way, and the next gradient is taken
    elsewhere).  Returns the gaps (rank 0)."""
    from repro_torch.configs.base import ShapeConfig
    from repro_torch.data.pipeline import make_batch, rank_batch
    from repro_torch.distributed import ShardingRules
    from repro_torch.distributed.process_group import DataParallel
    from repro_torch.launch import steps
    from repro_torch.launch.mesh import make_host_mesh
    from repro_torch.optim import AdamWConfig, adamw_init, adamw_update
    from repro_torch.optim.adamw import zero1_gather_state, zero1_init
    from repro_torch.tree import named_leaves, tree_map

    dev, rank, world = group.device, group.rank, group.world
    f32 = torch.float32
    cfg = dataclasses.replace(configs.get(TRAIN_ARCH), param_dtype="float32",
                              activation_dtype="float32")
    shape = ShapeConfig("train_f32", *TRAIN_F32_SHAPE, "train")
    opt_cfg = AdamWConfig(warmup_steps=1, total_steps=TRAIN_STEPS)
    mesh = make_host_mesh(group=group)
    rules = ShardingRules(mesh=mesh, cfg=cfg)
    params = api.init(TRAIN_SEED, cfg, shape, device=dev)
    group.broadcast_(params)
    p0 = clone_tree(params) if rank == 0 else None
    specs = steps.zero1_specs(rules, params)
    shapes = tree_map(lambda p: tuple(p.shape), params)
    opt = zero1_init(params, specs, mesh, rank)
    step = steps.make_train_step(cfg, opt_cfg, rules)
    reduced, dp_loss = [], []
    reduce = DataParallel.all_reduce_grads

    def keeping(self, grads):
        out = reduce(self, grads)
        if rank == 0:
            reduced.append(out)
        return out

    with patched(DataParallel, "all_reduce_grads", keeping):
        for s_ in range(2):
            batch = rank_batch(cfg, shape, s_, rank, world, device=dev)
            params, opt, m = step(params, opt, batch)
            dp_loss.append(float(m["loss"]))
    full = zero1_gather_state(opt, specs, group, mesh, shapes)
    del params, opt
    if rank != 0:
        return {}

    def worst(got, want):
        """(max over leaves of max|diff| / max|want|, that leaf)."""
        w = dict(named_leaves(want))
        return max((max_rel(g, w[k]), k) for k, g in named_leaves(got))

    def rows_grads(p, s_):
        """The control's gradient: each rank's rows alone, weighted by
        their share, summed in float32."""
        total = None
        for r in range(world):
            _, g = steps.loss_and_grads(
                p, cfg, rank_batch(cfg, shape, s_, r, world, device=dev),
                ce_weight=1.0 / world)
            g = tree_map(lambda t: t.to(f32), g)
            total = g if total is None else tree_map(torch.add, total, g)
        return total

    def state_gaps(got, want):
        return {f: worst(getattr(got, f), getattr(want, f))[0]
                for f in ("master", "mu", "nu")}

    (loss0, _, _), g0 = steps.loss_and_grads(
        p0, cfg, make_batch(cfg, shape, step=0, device=dev))
    grad_gap, grad_leaf = worst(reduced[0], g0)
    ctrl_grad_gap = worst(rows_grads(p0, 0), g0)[0]
    del g0
    one = steps.make_train_step(cfg, opt_cfg)
    st, pp = adamw_init(p0), p0                  # one process, whole batch
    cst, cp = adamw_init(p0), p0                 # the control
    same = adamw_init(p0)                        # unsharded, DP's gradients
    for s_ in range(2):
        pp, st, _ = one(pp, st, make_batch(cfg, shape, step=s_, device=dev))
        cp, cst, _ = adamw_update(rows_grads(cp, s_), cst, opt_cfg,
                                  param_dtype=f32)
        _, same, _ = adamw_update(reduced[s_], same, opt_cfg,
                                  param_dtype=f32)
    return {"f32": {"loss": dp_loss[0], "one_loss": float(loss0),
                    "grad_gap": grad_gap, "grad_leaf": grad_leaf,
                    "control_grad_gap": ctrl_grad_gap,
                    "state_exact": equal_trees(full, same),
                    "state_gaps": state_gaps(full, st),
                    "control_gaps": state_gaps(cst, st),
                    "dp_vs_control": state_gaps(full, cst)}}


# train-mamba2-fsdp2: the trainer's step (its config, optimizer and
# global batch of TRAIN_CLI) with FSDP over the data axis of the two
# data-parallel ranks, FSDP_STEPS steps from the CLI's initial params; its
# losses within RESUME_RTOL of the straight one-process run's; then one
# float32 step (TRAIN_F32_SHAPE) against one process's.  The rules split
# none of mamba2-130m's weight matrices (ROADMAP C9: under 1024 entries
# once the size-1 model axis holds their wide dim), so the same two ranks
# then run train-zamba2-fsdp2: zamba2-2.7b at its published widths cut to
# FSDP_ZAMBA2_LAYERS layers (one shared-attention application), whose
# every weight the rules split over the data axis: one bf16 step of
# FSDP_ZAMBA2_SHAPE, timed, then the float32 step against one process's
FSDP_STEPS = 2
FSDP_PARAM_TOL = 1e-6   # max|p - p_adamw| / max|p_adamw| (same gradient)
FSDP_ZAMBA2_ARCH = "zamba2-2.7b"
FSDP_ZAMBA2_LAYERS = 6
FSDP_ZAMBA2_SHAPE = (4096, 2)   # (seq_len, global batch): 1 x 4096 a rank
FSDP_ZAMBA2_STEPS = 1
FSDP_ZAMBA2_SSD_SHAPE = (1, 4096, 80, 1, 64, 64, 128)   # a rank's B2 call


def fsdp_rank(group):
    """train-mamba2-fsdp2, then train-zamba2-fsdp2, in this rank
    (`fsdp_steps`, `fsdp_f32_check`).  Returns this rank's figures and
    rank 0's gaps, zamba2's under ``zamba2``."""
    from repro_torch.configs.base import ShapeConfig
    from repro_torch.launch import train
    from repro_torch.optim import AdamWConfig

    cli = train.parse_args(TRAIN_CLI)
    opt_cfg = AdamWConfig(lr=cli.lr, warmup_steps=max(TRAIN_STEPS // 20, 1),
                          total_steps=TRAIN_STEPS)
    cfg = configs.get(TRAIN_ARCH)
    out = fsdp_steps(group, cfg, ShapeConfig("train_cli", cli.seq_len,
                                             cli.batch, "train"),
                     opt_cfg, FSDP_STEPS)
    out.update(fsdp_f32_check(group, cfg))
    zcfg = dataclasses.replace(configs.get(FSDP_ZAMBA2_ARCH),
                               num_layers=FSDP_ZAMBA2_LAYERS)
    out["zamba2"] = fsdp_steps(group, zcfg, ShapeConfig(
        "train_zamba2", *FSDP_ZAMBA2_SHAPE, "train"), opt_cfg,
        FSDP_ZAMBA2_STEPS)
    out["zamba2"].update(fsdp_f32_check(group, zcfg))
    group.max(0.0)
    return out


def fsdp_steps(group, cfg, shape, opt_cfg, n_steps):
    """`n_steps` steps of `launch.steps.make_train_step` with
    `ShardingRules(fsdp=True)` on the (2, 1) mesh from `api.init(0)`'s
    params, each rank the rows of its data coordinate: each step timed
    (CUDA events), B2 counted, its collectives by class counted and the
    data axis's gathers and reduce-scatters timed (`timing_collectives`),
    its peak bytes; how many leaves and parameters FSDP splits."""
    from repro_torch.data.pipeline import rank_batch
    from repro_torch.distributed import ShardingRules
    from repro_torch.launch import steps
    from repro_torch.launch.mesh import make_host_mesh
    from repro_torch.optim.adamw import zero1_init
    from repro_torch.tree import named_leaves

    dev, rank = group.device, group.rank
    mesh = make_host_mesh(group=group)
    data = mesh.axis_groups["data"]
    rules = ShardingRules(mesh=mesh, cfg=cfg, fsdp=True)
    whole = api.init(0, cfg, shape, device=dev)
    group.broadcast_(whole)
    params = rank_shards(whole, rules, mesh, rank)
    opt = zero1_init(whole, steps.zero1_specs(rules, whole), mesh, rank)
    split = [t.numel() for (_, t), (_, sp) in zip(
        named_leaves(whole), named_leaves(rules.param_pspecs(whole)))
        if "data" in str(sp)]
    out = {"losses": [], "ms": [], "launches": [], "counted": [],
           "peaks": [], "timed": [], "split_leaves": len(split),
           "split_share": sum(split) / sum(t.numel() for _, t in
                                           named_leaves(whole))}
    del whole
    step = steps.make_train_step(cfg, opt_cfg, rules)
    for s_ in range(n_steps):
        batch = rank_batch(cfg, shape, s_, data.rank, data.world,
                           device=dev)
        now = {}
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        before = collective_snapshot(group)
        ssd.launches = 0
        with timing_collectives([data], now):
            ms, (params, opt, m) = cuda_ms(lambda: step(params, opt, batch))
        out["losses"].append(float(m["loss"]))
        out["ms"].append(ms)
        out["launches"].append(ssd.launches)
        out["peaks"].append(torch.cuda.max_memory_allocated())
        out["counted"].append(collective_diff(collective_snapshot(group),
                                              before))
        out["timed"].append(now)
    del params, opt, step, batch
    torch.cuda.empty_cache()
    return out


def fsdp_f32_check(group, cfg):
    """`cfg` in float32, one FSDP step on TRAIN_F32_SHAPE from
    TRAIN_SEED's params: the summed gradient (FSDP's leaves from their
    reduce-scattered shards) and the params after the step, gathered; on
    rank 0 held against one process's gradient (GRAD_TOL of max|g| a
    leaf) and against `adamw_update` fed that gradient (FSDP_PARAM_TOL).
    Returns the loss, and rank 0's one-process loss and gaps."""
    from repro_torch.configs.base import ShapeConfig
    from repro_torch.data.pipeline import make_batch, rank_batch
    from repro_torch.distributed import ShardingRules
    from repro_torch.launch import steps
    from repro_torch.launch.mesh import make_host_mesh
    from repro_torch.optim import AdamWConfig, adamw_init, adamw_update
    from repro_torch.optim.adamw import zero1_init
    from repro_torch.tree import named_leaves, tree_map

    dev, rank = group.device, group.rank
    mesh = make_host_mesh(group=group)
    data = mesh.axis_groups["data"]
    cfg32 = dataclasses.replace(cfg, param_dtype="float32",
                                activation_dtype="float32")
    shape32 = ShapeConfig("train_f32", *TRAIN_F32_SHAPE, "train")
    rules32 = ShardingRules(mesh=mesh, cfg=cfg32, fsdp=True)
    whole = api.init(TRAIN_SEED, cfg32, shape32, device=dev)
    pspecs = rules32.param_pspecs(whole)
    shapes = tree_map(lambda p: tuple(p.shape), whole)
    params = rank_shards(whole, rules32, mesh, rank)
    opt = zero1_init(whole, steps.zero1_specs(rules32, whole), mesh, rank)
    opt32 = AdamWConfig(warmup_steps=1, total_steps=TRAIN_STEPS)
    kept, sum_grads = [], steps._sum_grads

    def keeping(*a, **kw):
        kept.append(sum_grads(*a, **kw))
        return kept[-1]

    batch = rank_batch(cfg32, shape32, 0, data.rank, data.world, device=dev)
    with patched(steps, "_sum_grads", keeping):
        params, opt, m = uncounted(lambda: steps.make_train_step(
            cfg32, opt32, rules32)(params, opt, batch))
    grads = group.gather(kept[0], pspecs, mesh, shapes)
    after = group.gather(params, pspecs, mesh, shapes)
    out = {"f32_loss": float(m["loss"])}
    del kept, params, opt
    if rank == 0:
        (loss1, _, _), g1 = uncounted(lambda: steps.loss_and_grads(
            whole, cfg32, make_batch(cfg32, shape32, step=0, device=dev)))
        want, _, _ = adamw_update(grads, adamw_init(whole), opt32,
                                  param_dtype=torch.float32)
        g1 = dict(named_leaves(g1))
        w = dict(named_leaves(want))
        out["f32_one_loss"] = float(loss1)
        out["f32_grad_gap"] = max((max_rel(g, g1[k]), k)
                                  for k, g in named_leaves(grads))
        out["f32_param_gap"] = max((max_rel(p, w[k]), k)
                                   for k, p in named_leaves(after))
        del g1, w, want
    del grads, after, whole
    torch.cuda.empty_cache()
    group.max(0.0)
    return out


def phase_train_dp(dev, smi, entry, straight):
    """train-mamba2-dp2: the trainer's CLI started as DP_WORLD processes
    (spawned; each `launch.train.main`, rank r on cuda:0 over gloo) for
    mamba2-130m at full width in bf16, the global batch 8 x 4096 (4 x 4096
    a rank), DP_STEPS steps and a checkpoint; then that checkpoint
    resumed in this process (elastic DP 2 -> 1) for step DP_STEPS.  Holds
    each rank's B2 launches at 2 x 24 a step (SSDScanFn, no plain scan),
    every loss finite, the DP-2 losses of steps 0-2 and the resumed loss
    of step 3 within RESUME_RTOL of the straight one-process run of
    train-mamba2 (`straight`: its metrics, same seed, stream and global
    batch), and the float32 check (`dp_f32_check`).  Also that nccl
    refuses two ranks on one card.  Prints ms a global step (CUDA events
    on rank 0, median of steps 1-2), global tokens/s, the gradient
    reduce's ms a step, each rank's wait at the barrier before it apart
    from the transfer after it (gloo stages it through the host: a cost
    of this one-card rig, not a link's), peak GiB and B2 launches a rank,
    wall s.
    `entry` (B2's kernel-line entry) gets the launches a rank as
    ``dp2_launches``."""
    import tempfile

    from repro_torch.distributed import process_group
    from repro_torch.launch import train

    phase = "train-mamba2-dp2"
    cfg = configs.get(TRAIN_ARCH)
    if torch.cuda.device_count() < DP_WORLD:
        try:
            process_group.rank_device(1, DP_WORLD, "nccl", "cuda")
        except ValueError as e:
            say(phase, f"nccl with {DP_WORLD} ranks on "
                f"{torch.cuda.device_count()} card refused: {e}")
        else:
            raise AssertionError(f"{phase}: nccl accepted {DP_WORLD} ranks "
                                 "on one card")
    want = (2 if cfg.remat == "full" else 1) * cfg.num_layers
    with tempfile.TemporaryDirectory() as tmp:
        ckpt = str(Path(tmp) / "dp")
        t0 = time.perf_counter()
        res = process_group.spawn_ranks(
            dp_rank, DP_WORLD, (ckpt,), timeout=DP_TIMEOUT,
            env={"MASTER_ADDR": "localhost", "MASTER_PORT": str(free_port())})
        wall = time.perf_counter() - t0
        ssd.launches = 0
        rc_res = train.main(TRAIN_CLI + ["--steps", str(TRAIN_STEPS),
                                         "--stop-after", str(DP_STEPS + 1),
                                         "--ckpt-dir", ckpt])
        resumed_launches = ssd.launches
        got = read_losses(ckpt)
    r0 = res[0]
    ms = r0["step_ms"]
    med = statistics.median(ms[1:])
    cli = train.parse_args(DP_CLI)
    tokens = cli.seq_len * cli.batch
    gaps = {k: abs(got[k] - straight[k]) / abs(straight[k]) for k in got}
    finite = all(math.isfinite(v) for v in got.values())
    launches = [res[r]["launches"] for r in range(DP_WORLD)]
    say(phase, f"CLI in {DP_WORLD} ranks over gloo on one card "
        f"({' '.join(r0['argv'][:-2])}; {widths(cfg)}, bf16): {med:.2f} ms a "
        f"global step of {tokens} tokens (CUDA events on rank 0, median of "
        f"steps 1-{DP_STEPS - 1}; all " + ", ".join(f"{t:.1f}" for t in ms)
        + f"), {tokens / med * 1e3:.0f} tokens/s; gradient reduce "
        f"(float32, gloo through the host: this one-card rig's cost, not a "
        f"link figure), by rank, median a step of the transfer after a "
        f"barrier " + ", ".join(
            f"{statistics.median(res[r]['reduce_ms']):.1f}"
            for r in range(DP_WORLD)) + " ms and of the wait at it for the "
        "other rank's backward " + ", ".join(
            f"{statistics.median(res[r]['wait_ms']):.1f}"
            for r in range(DP_WORLD)) + " ms (rank 0's transfer, all steps: "
        + ", ".join(f"{t:.1f}" for t in r0["reduce_ms"])
        + f"); peak GiB a rank " + ", ".join(
            f"{res[r]['peak_gib']:.2f}" for r in range(DP_WORLD))
        + f"; B2 launches a rank {launches} in {DP_STEPS} steps "
        f"({want} a step expected); wall {wall:.1f} s for the ranks "
        f"(start, {DP_STEPS} steps, checkpoint, float32 check) [{smi}]")
    say(phase, f"losses DP-2 " + ", ".join(
        f"{got[k]:.4f}" for k in range(DP_STEPS)) + f"; resumed in one "
        f"process (DP 2 -> 1, exit {rc_res}, {resumed_launches} B2 "
        f"launches) step {DP_STEPS}: {got.get(DP_STEPS, float('nan')):.4f}; "
        f"straight one-process " + ", ".join(
            f"{straight[k]:.4f}" for k in range(DP_STEPS + 1))
        + "; relative gaps " + ", ".join(
            f"{gaps[k]:.2e}" for k in sorted(gaps))
        + f" (limit {RESUME_RTOL:g})")
    f = r0["f32"]
    lgap = abs(f["loss"] - f["one_loss"]) / abs(f["one_loss"])
    say(phase, f"float32 at full width, batch {TRAIN_F32_SHAPE[1]} x "
        f"{TRAIN_F32_SHAPE[0]} split one row a rank: loss {f['loss']:.6f} vs "
        f"one process {f['one_loss']:.6f} (relative gap {lgap:.2e}, limit "
        f"{TRAIN_LOSS_RTOL:g}); reduced gradient worst leaf max|diff|/max|g| "
        f"{f['grad_gap']:.2e} ({f['grad_leaf']}; limit {GRAD_TOL:g}; the "
        f"control, one process fed the rows one at a time: "
        f"{f['control_grad_gap']:.2e}); ZeRO-1 state after 2 steps "
        f"gathered: bit-equal to unsharded AdamW on the same gradients "
        f"{f['state_exact']}; against the control's state (max|diff| / "
        f"max|control|) " + ", ".join(
            f"{k} {v:.2e}" for k, v in f["dp_vs_control"].items())
        + f" (limit {DP_CONTROL_TOL:.2e}); for information, against the "
        f"one-process run's own state on the whole batch " + ", ".join(
            f"{k} {f['state_gaps'][k]:.2e} (the control's "
            f"{f['control_gaps'][k]:.2e})" for k in ("master", "mu", "nu"))
        + f" [{smi}]")
    ok = (all(res[r]["rc"] == 0 for r in range(DP_WORLD)) and rc_res == 0
          and all(n == want * DP_STEPS for n in launches)
          and resumed_launches == want and finite
          and sorted(got) == list(range(DP_STEPS + 1))
          and max(gaps.values()) <= RESUME_RTOL
          and lgap <= TRAIN_LOSS_RTOL and f["grad_gap"] <= GRAD_TOL
          and f["state_exact"]
          and max(f["dp_vs_control"].values()) <= DP_CONTROL_TOL)
    if not ok:
        raise AssertionError(f"{phase}: check failed (exits "
                             f"{[res[r]['rc'] for r in range(DP_WORLD)]}/"
                             f"{rc_res}, launches {launches}/"
                             f"{resumed_launches}, losses {got}, gaps "
                             f"{gaps}, float32 {f})")
    entry["dp2_launches"] = launches
    fs = [res[r]["fsdp"] for r in range(DP_WORLD)]
    f0 = fs[0]
    fgaps = [abs(a - straight[k]) / abs(straight[k])
             for k, a in enumerate(f0["losses"])]
    say_fsdp("train-mamba2-fsdp2", cfg, tokens, fs, smi, f" (DP-2's " +
             ", ".join(f"{res[r]['peak_gib']:.2f}" for r in range(DP_WORLD))
             + ")")
    say("train-mamba2-fsdp2", f"losses " + ", ".join(
        f"{v:.4f}" for v in f0["losses"]) + f" vs the straight "
        f"one-process run's " + ", ".join(
            f"{straight[k]:.4f}" for k in range(FSDP_STEPS))
        + f" (relative gaps " + ", ".join(f"{g:.2e}" for g in fgaps)
        + f", limit {RESUME_RTOL:g})")
    if not (fsdp_ok(cfg, fs)
            and max(fgaps) <= RESUME_RTOL):
        raise AssertionError(f"train-mamba2-fsdp2: check failed (launches "
                             f"{[x['launches'] for x in fs]}, loss gaps "
                             f"{fgaps}, float32 {f0['f32_grad_gap']} "
                             f"{f0['f32_param_gap']})")
    zs = [x["zamba2"] for x in fs]
    zcfg = dataclasses.replace(configs.get(FSDP_ZAMBA2_ARCH),
                               num_layers=FSDP_ZAMBA2_LAYERS)
    say_fsdp("train-zamba2-fsdp2", zcfg, math.prod(FSDP_ZAMBA2_SHAPE), zs,
             smi, "")
    if not fsdp_ok(zcfg, zs):
        raise AssertionError(f"train-zamba2-fsdp2: check failed (launches "
                             f"{[x['launches'] for x in zs]}, losses "
                             f"{zs[0]['losses']}, float32 "
                             f"{zs[0]['f32_grad_gap']} "
                             f"{zs[0]['f32_param_gap']})")
    CARD_RUNS["fsdp2-zamba2"] = {"counted": zs[0]["counted"],
                                 "peaks": zs[0]["peaks"],
                                 "launches_a_step": zs[0]["launches"][-1]}
    entry["fsdp2_launches"] = [x["launches"] for x in fs]
    CARD_RUNS["fsdp2"] = {"counted": f0["counted"], "peaks": f0["peaks"],
                          "launches_a_step": f0["launches"][-1]}
    return {"ms_a_step": med, "tokens_s": tokens / med * 1e3,
            "reduce_ms": statistics.median(r0["reduce_ms"]),
            "wait_ms": statistics.median(r0["wait_ms"]),
            "peak_gib": [res[r]["peak_gib"] for r in range(DP_WORLD)],
            "b2_a_step": [n / DP_STEPS for n in launches], "wall_s": wall}


def say_fsdp(phase, cfg, tokens, fs, smi, beside):
    """Prints an FSDP run's lines (`fsdp_rank`'s figures of each rank, `fs`;
    `tokens` the global batch's, `beside` follows the peaks)."""
    f0 = fs[0]
    timed_kinds = {k: statistics.median(
        t.get(k, {}).get("transfer", 0.0) for t in f0["timed"])
        for k in ("all-gather", "reduce-scatter")}
    waits = {k: statistics.median(
        t.get(k, {}).get("wait", 0.0) for t in f0["timed"])
        for k in ("all-gather", "reduce-scatter")}
    c1 = f0["counted"][-1]
    lgap32 = abs(f0["f32_loss"] - f0["f32_one_loss"]) / abs(
        f0["f32_one_loss"])
    say(phase, f"{cfg.name} ({widths(cfg)}, bf16) with FSDP over the data "
        f"axis in {DP_WORLD} ranks as ({DP_WORLD}, 1), {f0['split_leaves']} "
        f"leaves split ({f0['split_share']:.4f} of the parameters), "
        f"{tokens // DP_WORLD} tokens a rank, {len(f0['ms'])} steps: ms a "
        f"step (CUDA events on rank 0) " + ", ".join(
            f"{t:.1f}" for t in f0["ms"]) + f"; a step's collectives "
        f"{c1['counts']}, MB " + ", ".join(
            f"{k} {v / 1e6:.1f}" for k, v in c1["bytes"].items() if v)
        + "; the gathers' and reduce-scatters' transfer after a barrier "
        + ", ".join(f"{k} {v:.1f} ms" for k, v in timed_kinds.items())
        + ", wait at it " + ", ".join(f"{k} {v:.1f} ms" for k, v in
                                      waits.items())
        + f" a step (median; gloo through the host: this one-card rig's "
        f"cost, not a link's); peak GiB a rank " + ", ".join(
            f"{max(x['peaks']) / 2 ** 30:.2f}" for x in fs) + beside
        + f"; B2 launches a step a rank " + ", ".join(
            str(x["launches"]) for x in fs) + f" ({fsdp_launches(cfg)} "
        f"expected); losses " + ", ".join(f"{v:.4f}" for v in f0["losses"])
        + f" [{smi}]")
    say(phase, f"float32 step at {TRAIN_F32_SHAPE[1]} x "
        f"{TRAIN_F32_SHAPE[0]}: loss {f0['f32_loss']:.6f} vs one process "
        f"{f0['f32_one_loss']:.6f} (relative gap {lgap32:.2e}, limit "
        f"{TRAIN_LOSS_RTOL:g}); gathered gradient worst leaf max|diff|/"
        f"max|g| {f0['f32_grad_gap'][0]:.2e} ({f0['f32_grad_gap'][1]}; "
        f"limit {GRAD_TOL:g}); params after the step against AdamW fed "
        f"that gradient, worst leaf {f0['f32_param_gap'][0]:.2e} "
        f"({f0['f32_param_gap'][1]}; limit {FSDP_PARAM_TOL:g})")


def fsdp_launches(cfg):
    """B2 launches a train step: one a Mamba2 layer, twice under remat
    "full" (the forward and the recompute)."""
    return (2 if cfg.remat == "full" else 1) * scan_layers(cfg)


def fsdp_ok(cfg, fs):
    """An FSDP run's checks: every rank's B2 launches a step, every loss
    finite, and rank 0's float32 step against one process's."""
    f0 = fs[0]
    lgap32 = abs(f0["f32_loss"] - f0["f32_one_loss"]) / abs(
        f0["f32_one_loss"])
    return (all(n == fsdp_launches(cfg) for x in fs for n in x["launches"])
            and all(math.isfinite(v) for v in f0["losses"])
            and lgap32 <= TRAIN_LOSS_RTOL
            and f0["f32_grad_gap"][0] <= GRAD_TOL
            and f0["f32_param_gap"][0] <= FSDP_PARAM_TOL)


# ---------------------------------------------------------------------------
# Training across processes: mamba2-130m in two model-parallel ranks, and
# qwen3-moe-30b-a3b's experts, heads and vocabulary split over two ranks
# ---------------------------------------------------------------------------

TP_WORLD = 2
# the trainer's CLI of train-mamba2-dp2 with a model axis of 2: both ranks
# take all 8 x 4096 tokens, each its 12 of the 24 heads a block
TP_CLI = DP_CLI + ["--model-axis", str(TP_WORLD)]
# tp2-qwen3moe: qwen3-moe-30b-a3b at full width, cut to 2 of its 48 layers,
# in float32, 2 x 512 tokens; its limits: the loss's relative gap, the
# gathered gradient's max|diff| / max|g| per leaf, grad_norm's relative gap
TP_MOE_ARCH = "qwen3-moe-30b-a3b"
TP_MOE_LAYERS = 2
TP_MOE_SHAPE = (512, 2)            # (seq_len, batch)
TP_MOE_LOSS_RTOL = 1e-5
TP_MOE_GRAD_TOL = 1e-4
TP_MOE_NORM_RTOL = 1e-4


def tp_rank(rank, ckpt):
    """One rank of train-mamba2-tp2, tp2-qwen3moe and serve-mamba2-tp2, in
    a process of its own (`process_group.spawn_ranks`): joins the gloo
    group on cuda:LOCAL_RANK % device_count, runs the trainer's CLI with a
    model axis (`tp_rank_cli`), the float32 MoE check (`tp_moe_check`),
    then serving under the rules (`serve_tp_rank`)."""
    from repro_torch.distributed.process_group import DataParallel

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    group = DataParallel.start("gloo", "cuda")
    try:
        out = tp_rank_cli(ckpt)
        torch.cuda.empty_cache()
        out["moe"] = tp_moe_check(group)
        torch.cuda.empty_cache()
        out["serve"] = serve_tp_rank(group)
        return out
    finally:
        group.close()


def collective_snapshot(group):
    """A copy of `group`'s collective counters (by class: ``bytes``,
    ``counts``), shared by its sub-groups."""
    return {k: dict(v) for k, v in group.collectives.items()}


def collective_diff(after, before):
    """The collectives between two snapshots, with ``total_bytes``, as
    `launch.dryrun` reports them."""
    out = {k: {op: after[k][op] - before[k][op] for op in after[k]}
           for k in ("bytes", "counts")}
    out["total_bytes"] = sum(out["bytes"].values())
    return out


@contextlib.contextmanager
def timing_collectives(groups, now):
    """Every collective (`DataParallel.all_reduce_`, which the all-gathers
    and reduce-scatters go through) on a group of `groups` (a list, which
    may be filled later) timed on the host clock in two parts, the wait at
    a barrier every rank of the group has reached (after this rank's work
    before it, synchronised) and the transfer after it (gloo stages the
    card's buffers through the host), added to now[kind] (``wait``,
    ``transfer`` ms, ``bytes``, ``calls``)."""
    from repro_torch.distributed.process_group import DataParallel

    all_reduce = DataParallel.all_reduce_

    def timed(self, t, op=torch.distributed.ReduceOp.SUM, **kw):
        if self.world == 1 or not any(self is g for g in groups):
            return all_reduce(self, t, op, **kw)
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        torch.distributed.all_reduce(torch.zeros(1, device=self.device),
                                     group=self.pg)            # the barrier
        t1 = time.perf_counter()
        out = all_reduce(self, t, op, **kw)
        torch.cuda.synchronize()
        rec = now.setdefault(kw.get("kind", "all-reduce"), {
            "wait": 0.0, "transfer": 0.0, "bytes": 0, "calls": 0})
        rec["wait"] += (t1 - t0) * 1e3
        rec["transfer"] += (time.perf_counter() - t1) * 1e3
        rec["bytes"] += t.numel() * t.element_size()
        rec["calls"] += 1
        return out

    with patched(DataParallel, "all_reduce_", timed):
        yield


def summed_kinds(now):
    """`timing_collectives`' records of every class added together."""
    out = {"wait": 0.0, "transfer": 0.0, "bytes": 0, "calls": 0}
    for rec in now.values():
        for k in out:
            out[k] += rec[k]
    return out


def tp_rank_cli(ckpt):
    """This rank's run of the CLI (TP_CLI, DP_STEPS steps then a
    checkpoint): B2 launches (counted from 0 just before), peak GiB, wall
    s, each step's ms (CUDA events), and per step the model-axis
    collectives (on the mesh's model group: the models' f and g, the B/C
    gathers, and the sum of the partial gradients and of the norm's
    squares): their count, bytes, and ms (`timing_collectives`); and per
    step the rank's collectives by class (every group's counters) and its
    peak bytes, for dryrun-vs-card."""
    from repro_torch.launch import steps, train

    events, per_step, model, counted, peaks = [], [], [], [], []
    now = {}
    make_step = steps.make_train_step
    running = [0]

    def timed_make_step(cfg, opt_cfg, rules, *a, **kw):
        model.append(rules.mesh.axis_groups[rules.tp_axis])
        world = rules.mesh.process_group
        step = timed_fn(make_step(cfg, opt_cfg, rules, *a, **kw), "train",
                        events)

        def call(*args):
            torch.cuda.synchronize()
            running[0] = max(running[0], torch.cuda.max_memory_allocated())
            torch.cuda.reset_peak_memory_stats()
            before = collective_snapshot(world)
            out = step(*args)
            torch.cuda.synchronize()
            peaks.append(torch.cuda.max_memory_allocated())
            counted.append(collective_diff(collective_snapshot(world),
                                           before))
            per_step.append(summed_kinds(now))
            now.clear()
            return out
        return call

    argv = TP_CLI + ["--steps", str(TRAIN_STEPS), "--stop-after",
                     str(DP_STEPS), "--ckpt-dir", ckpt]
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    ssd.launches = 0
    t0 = time.perf_counter()
    with patched(steps, "make_train_step", timed_make_step), \
            timing_collectives(model, now):
        rc = train.main(argv)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    peak = max(running[0], torch.cuda.max_memory_allocated(), *peaks)
    return {"rc": rc, "launches": ssd.launches, "wall_s": wall,
            "peak_gib": peak / 2 ** 30,
            "step_ms": [s.elapsed_time(e) for _, s, e in events],
            "collectives": per_step, "counted": counted,
            "step_peak_bytes": peaks, "argv": argv}


def tp_moe_check(group):
    """tp2-qwen3moe: qwen3-moe-30b-a3b at full width cut to TP_MOE_LAYERS
    layers, float32, TP_MOE_SHAPE tokens from seed TRAIN_SEED: one train
    step (`make_train_step` with rules) in the two ranks, as (1, 2) on
    the (data, model) mesh: the 128 experts over the model axis (EP), the
    32 q and 4 kv heads, the untied lm_head and the embedding's 151936
    rows.  Against the same step's loss and gradient in one process on
    the card, run first on rank 0 (`steps.loss_and_grads`, what the step
    differentiates, and `global_norm`), its gradient kept on the host and
    its device memory freed before the ranks build theirs (rank 1 waits
    at a barrier).  On rank 0: the loss within TP_MOE_LOSS_RTOL, the
    summed gradient gathered whole within TP_MOE_GRAD_TOL of max|g| per
    leaf, grad_norm within TP_MOE_NORM_RTOL.  Returns the gaps (rank 0),
    the step's ms and both ranks' peak GiB."""
    from repro_torch.configs.base import ShapeConfig
    from repro_torch.data.pipeline import make_batch, rank_batch
    from repro_torch.distributed import ShardingRules
    from repro_torch.distributed.sharding import mesh_coords, shard_of
    from repro_torch.launch import steps
    from repro_torch.launch.mesh import make_host_mesh
    from repro_torch.optim import AdamWConfig, global_norm
    from repro_torch.optim.adamw import zero1_init
    from repro_torch.tree import named_leaves, tree_map

    dev, rank = group.device, group.rank
    cfg = dataclasses.replace(configs.get(TP_MOE_ARCH),
                              num_layers=TP_MOE_LAYERS,
                              param_dtype="float32",
                              activation_dtype="float32")
    shape = ShapeConfig("tp_moe", *TP_MOE_SHAPE, "train")
    torch.cuda.reset_peak_memory_stats()
    one = None
    if rank == 0:
        params = api.init(TRAIN_SEED, cfg, shape, device=dev)
        (loss, _, _), g = steps.loss_and_grads(
            params, cfg, make_batch(cfg, shape, step=0, device=dev))
        one = {"loss": float(loss), "norm": float(global_norm(g)),
               "grads": {k: v.cpu() for k, v in named_leaves(g)},
               "peak_gib": torch.cuda.max_memory_allocated() / 2 ** 30}
        del params, g
        torch.cuda.empty_cache()
    group.max(0.0)                        # rank 1 waits for the card
    torch.cuda.reset_peak_memory_stats()
    mesh = make_host_mesh(model=TP_WORLD, group=group)
    rules = ShardingRules(mesh=mesh, cfg=cfg)
    data = mesh.axis_groups["data"]
    whole = api.init(TRAIN_SEED, cfg, shape, device=dev)
    pspecs = rules.param_pspecs(whole)
    shapes = tree_map(lambda p: tuple(p.shape), whole)
    opt = zero1_init(whole, steps.zero1_specs(rules, whole), mesh, rank)
    coords = mesh_coords(mesh, rank)
    params = tree_map(lambda p, s: shard_of(p, s, coords, mesh), whole,
                      pspecs)
    del whole
    torch.cuda.empty_cache()
    step = steps.make_train_step(cfg, AdamWConfig(warmup_steps=1,
                                                  total_steps=TRAIN_STEPS),
                                 rules)
    summed, sum_grads = [], steps._sum_grads

    def keeping(*a, **kw):
        out = sum_grads(*a, **kw)
        summed.append(out)
        return out

    batch = rank_batch(cfg, shape, 0, data.rank, data.world, device=dev)
    with patched(steps, "_sum_grads", keeping):
        step_ms, (params, opt, m) = cuda_ms(lambda: step(params, opt, batch))
    peak = torch.cuda.max_memory_allocated() / 2 ** 30
    del params, opt
    torch.cuda.empty_cache()
    gathered = group.gather(summed[0], pspecs, mesh, shapes)
    del summed
    out = {"step_ms": step_ms, "peak_gib": peak,
           "loss": float(m["loss"]), "norm": float(m["grad_norm"])}
    if rank == 0:
        gaps = {}
        for k, g in named_leaves(gathered):
            w = one["grads"][k].to(dev)
            gaps[k] = max_rel(g, w)
            del w
        out.update(one_loss=one["loss"], one_norm=one["norm"],
                   one_peak_gib=one["peak_gib"], gaps=gaps)
    del gathered
    torch.cuda.empty_cache()
    return out


# serve-mamba2-tp2: mamba2-130m at full width in bf16 served by
# `GenerationEngine(rules=)` on the (1, 2) mesh of train-mamba2-tp2's
# ranks (12 of the 24 heads a rank): SERVE_TP_REQUESTS requests with
# prompts of SERVE_PROMPT tokens, SERVE_NEW new tokens, one batch; then a
# float32 batch's prefill and SERVE_TP_DECODES decode steps (float32
# caches) against one process's, within SERVE_TP_TOL of max|logits|
SERVE_TP_ARCH = "mamba2-130m"
SERVE_TP_REQUESTS = 8
SERVE_TP_DECODES = 4
SERVE_TP_TOL = 1e-4
SERVE_TP_SHAPE = (8, 1024, 12, 1, 128, 64, 64)   # a rank's B2 call


def serve_requests(cfg, n):
    """`n` requests with prompts of SERVE_PROMPT tokens and SERVE_NEW new
    tokens from SERVE_SEED (serve-mamba2's draw)."""
    rng = np.random.RandomState(SERVE_SEED)
    return [Request(prompt=rng.randint(0, cfg.vocab_size, size=rng.randint(
        SERVE_PROMPT[0], SERVE_PROMPT[1] + 1)).astype(np.int32),
        max_new_tokens=SERVE_NEW) for _ in range(n)]


def rank_shards(whole, rules, mesh, rank):
    """This rank's `shard_of` each leaf of `whole` under the rules."""
    from repro_torch.distributed.sharding import mesh_coords, shard_of
    from repro_torch.tree import tree_map

    coords = mesh_coords(mesh, rank)
    return tree_map(lambda p, sp: shard_of(p, sp, coords, mesh), whole,
                    rules.param_pspecs(whole))


def serve_tp_only(rank, arch, depths, f64_depths=()):
    """A rank of `tools/lm_serve.py --tp`: joins the gloo group on the
    card and runs `serve_tp_rank` for `arch`, then `serve_tp_f32` for
    `arch` cut to each of `depths` layers ({depth: its results} under
    ``depths``), then its float64 pass at each of `f64_depths` layers
    (under ``f64``)."""
    from repro_torch.distributed.process_group import DataParallel
    from repro_torch.launch.mesh import make_host_mesh

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    group = DataParallel.start("gloo", "cuda")
    try:
        out = serve_tp_rank(group, arch)
        cfg = configs.get(arch)
        mesh = make_host_mesh(model=TP_WORLD, group=group)
        reqs = serve_requests(cfg, SERVE_TP_REQUESTS)
        out["depths"] = {d: serve_tp_f32(group, mesh, dataclasses.replace(
            cfg, num_layers=d), reqs) for d in depths}
        out["f64"] = {d: serve_tp_f32(group, mesh, dataclasses.replace(
            cfg, num_layers=d), reqs, "float64") for d in f64_depths}
        return out
    finally:
        group.close()


def serve_tp_rank(group, arch=SERVE_TP_ARCH):
    """serve-mamba2-tp2 in this rank: the engine with rules on the (1, 2)
    mesh, one batch of SERVE_TP_REQUESTS (after a short uncounted warm-up
    batch), the prefill and decode steps timed (CUDA events), B2 counted,
    the model-axis collectives of the decode steps counted and timed
    (`timing_collectives`); then the float32 batch.  On rank 0, one
    process's runs on the whole params (rank 1 waits at a barrier): the
    bf16 tokens and the float32 logits.  Returns rank 0's comparisons and
    every rank's figures."""
    from repro_torch.distributed import ShardingRules
    from repro_torch.launch.mesh import make_host_mesh

    dev, rank = group.device, group.rank
    cfg = configs.get(arch)
    mesh = make_host_mesh(model=TP_WORLD, group=group)
    model = mesh.axis_groups["model"]
    rules = ShardingRules(mesh=mesh, cfg=cfg)
    max_len = serve_max_len(cfg)
    whole = api.init(SERVE_SEED, cfg, device=dev)
    params = rank_shards(whole, rules, mesh, rank)
    reqs = serve_requests(cfg, SERVE_TP_REQUESTS)
    engine = GenerationEngine(params, cfg, max_len=max_len,
                              batch_size=SERVE_TP_REQUESTS, device=dev,
                              rules=rules)
    uncounted(lambda: engine.generate([Request(prompt=r.prompt[:64],
                                               max_new_tokens=4)
                                       for r in reqs]))
    events, now, per_decode = [], {}, []
    timed_steps(engine, events)
    decode = engine._decode

    def counted_decode(*a):
        before = summed_kinds(now)
        out = decode(*a)
        after = summed_kinds(now)
        per_decode.append({k: after[k] - before[k] for k in after})
        return out

    engine._decode = counted_decode
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    ssd.launches = 0
    before = collective_snapshot(group)
    t0 = time.perf_counter()
    with timing_collectives([model], now):
        out = np.stack([r.output for r in engine.generate(reqs)])
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    coll = collective_diff(collective_snapshot(group), before)
    launches = ssd.launches
    pre = [st.elapsed_time(e) for k, st, e in events if k == "prefill"]
    dec = [st.elapsed_time(e) for k, st, e in events if k == "decode"]
    res = {"launches": launches, "prefill_ms": pre,
           "decode_ms": statistics.mean(dec), "decodes": len(dec),
           "wall_s": wall, "collectives": coll, "timed": now,
           "per_decode": {k: statistics.median(d[k] for d in per_decode)
                          for k in per_decode[0]},
           "peak_gib": torch.cuda.max_memory_allocated() / 2 ** 30,
           "plen": max(len(r.prompt) for r in reqs)}
    del engine
    res.update(serve_tp_f32(group, mesh, cfg, reqs))
    if rank == 0:
        one = GenerationEngine(whole, cfg, max_len=max_len,
                               batch_size=SERVE_TP_REQUESTS, device=dev)
        ref_out = np.stack([r.output for r in uncounted(
            lambda: one.generate(serve_requests(cfg, SERVE_TP_REQUESTS)))])
        res["bf16_agree"] = float((ref_out == out).mean())
        res["bf16_first_equal"] = float((ref_out[:, 0] == out[:, 0]).mean())
    group.max(0.0)
    return res


# ROADMAP C10: a float64 run's ranks against one process, at most this
# max|diff| / max|logits| where they differ by float64 rounding alone (the
# float32 gaps scaled by 2^-29 stay near 1e-13)
SERVE_TP_F64_ROUNDING = 1e-9


def serve_tp_f32(group, mesh, cfg, reqs, dtype="float32"):
    """`cfg` in float32 on `mesh` (1, 2): the ranks' prefill of `reqs`
    and SERVE_TP_DECODES decode steps (float32 caches), then on rank 0
    one process's (rank 1 waits at a barrier), and a control's: one
    process whose scan's y moves one float32 ulp.  Returns rank 0's
    max|diff| / max|one process's logits| a step, ranks' and control's,
    and whether the next tokens are equal.  With `dtype` "float64" the
    same in float64 (params, activations and caches; keys ``f64_*``, no
    control), every scan the plain one (`with_plain_scan`: B2 takes no
    float64), and the ranks' shards made one rank at a time, so that the
    card never holds two whole float64 models (21.6 GB each at
    zamba2-2.7b's widths); rank 0 makes the whole model again for one
    process's run once the shards are gone."""
    from repro_torch.distributed import ShardingRules

    dev, rank = group.device, group.rank
    f64 = dtype == "float64"
    rules = ShardingRules(mesh=mesh, cfg=cfg)
    max_len = serve_max_len(cfg)
    cfgx = dataclasses.replace(cfg, param_dtype=dtype,
                               activation_dtype=dtype)
    scanned = with_plain_scan if f64 else (lambda fn: fn())
    whole = None
    for turn in range(group.world):
        if not f64 or turn == rank:
            whole = api.init(SERVE_SEED, cfgx, device=dev)
            params = rank_shards(whole, rules, mesh, rank)
        if f64:
            whole = None
            torch.cuda.empty_cache()
            group.max(0.0)
        else:
            break
    batch = {"tokens": GenerationEngine(
        None, cfgx, max_len, SERVE_TP_REQUESTS, dev)._make_batch(reqs)}
    res = {}

    def steps_logits(p, r):
        prefill = make_prefill_step(cfgx, max_len, r, with_logits=True,
                                    cache_dtype=getattr(torch, dtype))
        decode = make_decode_step(cfgx, r, with_logits=True)
        tok, cache, logits = uncounted(lambda: prefill(p, batch))
        toks, outs = [tok], [logits]
        for _ in range(SERVE_TP_DECODES):
            tok, cache, logits = uncounted(lambda: decode(p, tok, cache))
            toks.append(tok)
            outs.append(logits)
        return [t.cpu() for t in toks], [o.cpu() for o in outs]

    ranks_toks, ranks_logits = scanned(lambda: steps_logits(params, rules))
    del params
    torch.cuda.empty_cache()
    group.max(0.0)
    if rank == 0:
        if whole is None:
            whole = api.init(SERVE_SEED, cfgx, device=dev)
        one_toks, one_logits = scanned(lambda: steps_logits(whole, None))

        def gaps(logits):
            return [float((a - b).abs().max() / b.abs().max())
                    for a, b in zip(logits, one_logits)]

        key = "f64" if f64 else "f32"
        res[f"{key}_gaps"] = gaps(ranks_logits)
        res[f"{key}_tokens_equal"] = all(torch.equal(a, b) for a, b in
                                         zip(ranks_toks, one_toks))
        res[f"{key}_dtype"] = str(ranks_logits[0].dtype)
        if not f64:
            # the control: one process with the scan's y one float32 ulp
            # off
            res["f32_control_gaps"] = gaps(with_scan(
                ulp_scan(), lambda: steps_logits(whole, None))[1])
        res[f"{key}_peak_gib"] = torch.cuda.max_memory_allocated() / 2 ** 30
    del whole
    torch.cuda.empty_cache()
    group.max(0.0)
    return res


def say_serve_tp(phase, cfg, serve, smi):
    """Prints a serve-under-rules run's lines (`serve_tp_rank`'s results
    of each rank), its float32 gaps beside a control's (one process whose
    scan's y moves one float32 ulp), and holds its checks: every rank's B2
    launches one prefill's and the float32 next tokens equal.  The caller
    holds the gaps: serve-mamba2-tp2 the float32 ones, `tools/lm_serve.py
    --tp` a float64 run's.  Returns rank 0's results."""
    from repro_torch.models.mamba2 import dims

    heads = dims(cfg)[1]
    sv = serve[0]
    pd = sv["per_decode"]
    say(phase, f"{cfg.name} ({widths(cfg)}, bf16) served "
        f"by GenerationEngine(rules=) in {TP_WORLD} ranks as (1, "
        f"{TP_WORLD}) ({heads // TP_WORLD} of {heads} heads a rank): "
        f"{SERVE_TP_REQUESTS} requests, padded prompt {sv['plen']}, "
        f"{SERVE_NEW} new tokens; prefill {sv['prefill_ms'][0]:.2f} ms, "
        f"decode {sv['decode_ms']:.3f} ms a step (mean of {sv['decodes']}; "
        f"CUDA events on rank 0); model-axis collectives a decode step "
        f"(median): {pd['calls']:.0f} calls, {pd['bytes'] / 1e6:.3f} MB, "
        f"transfer after a barrier {pd['transfer']:.2f} ms, wait at it "
        f"{pd['wait']:.2f} ms (gloo through the host: this one-card rig's "
        f"cost, not a link's); the whole batch's collectives by class "
        f"{sv['collectives']['counts']} ({sv['collectives']['total_bytes'] / 1e6:.2f} MB); "
        f"B2 launches a rank {[x['launches'] for x in serve]} (one prefill, "
        f"{scan_layers(cfg)} expected at H {heads // TP_WORLD}); peak GiB a "
        f"rank " + ", ".join(f"{x['peak_gib']:.2f}" for x in serve)
        + f"; wall {sv['wall_s']:.2f} s [{smi}]")
    say(phase, f"against one process on the same params: bf16 "
        f"tokens agree {sv['bf16_agree']:.4f} of {SERVE_TP_REQUESTS} x "
        f"{SERVE_NEW} (first token {sv['bf16_first_equal']:.4f}; ROADMAP "
        f"C6: a bf16 model amplifies any change in its scan, so no bound "
        f"holds); float32 batch, prefill and {SERVE_TP_DECODES} decode "
        f"steps' logits max|diff| / max|one process| " + ", ".join(
            f"{g:.2e}" for g in sv["f32_gaps"])
        + f" (limit {SERVE_TP_TOL:g}; the control, one process with the "
        "scan's y one float32 ulp off: " + ", ".join(
            f"{g:.2e}" for g in sv["f32_control_gaps"])
        + f"), next tokens equal {sv['f32_tokens_equal']}")
    if not (all(x["launches"] == scan_layers(cfg) for x in serve)
            and sv["f32_tokens_equal"]):
        raise AssertionError(f"{phase}: check failed (launches "
                             f"{[x['launches'] for x in serve]}, float32 "
                             f"next tokens equal {sv['f32_tokens_equal']})")
    return sv


def phase_train_tp(dev, smi, entry, straight):
    """train-mamba2-tp2: the trainer's CLI started as TP_WORLD processes
    (spawned; rank r on cuda:0 over gloo) with --model-axis 2 for
    mamba2-130m at full width in bf16, 8 x 4096 tokens on both ranks, each
    its 12 heads (B2 at B 8, S 4096, H 12), DP_STEPS steps and a
    checkpoint; that checkpoint resumed in this process (TP 2 -> 1) for
    step DP_STEPS; and, in the same two ranks, tp2-qwen3moe
    (`tp_moe_check`), this process holding no device memory of its own
    meanwhile.  Holds each rank's B2 launches at 2 x 24 a step
    (SSDScanFn, no plain scan), every loss finite, the TP-2 losses of
    steps 0-2 and the resumed loss of step 3 within RESUME_RTOL of the
    straight one-process run of train-mamba2 (`straight`), and
    tp2-qwen3moe's limits.  Prints ms a step (CUDA events on rank 0,
    median of steps 1-2), tokens/s, the model-axis collectives a step
    (count, bytes, transfer after a barrier apart from the wait at it;
    gloo through the host: a cost of this one-card rig, not a link's),
    peak GiB and B2 launches a rank, wall s.  Returns B2's kernels-line
    entry at the model-parallel rank's call (`entry`'s ``tp2_call``, held
    against the plain scan under a gradient in train-mamba2) with this
    run's launches a rank."""
    import tempfile

    from repro_torch.distributed import process_group
    from repro_torch.launch import train

    from repro_torch.models.mamba2 import dims

    phase = "train-mamba2-tp2"
    cfg = configs.get(TRAIN_ARCH)
    heads = dims(cfg)[1]
    want = (2 if cfg.remat == "full" else 1) * cfg.num_layers
    torch.cuda.empty_cache()
    with tempfile.TemporaryDirectory() as tmp:
        ckpt = str(Path(tmp) / "tp")
        t0 = time.perf_counter()
        res = process_group.spawn_ranks(
            tp_rank, TP_WORLD, (ckpt,), timeout=DP_TIMEOUT,
            env={"MASTER_ADDR": "localhost", "MASTER_PORT": str(free_port())})
        wall = time.perf_counter() - t0
        ssd.launches = 0
        rc_res = train.main(TRAIN_CLI + ["--steps", str(TRAIN_STEPS),
                                         "--stop-after", str(DP_STEPS + 1),
                                         "--ckpt-dir", ckpt])
        resumed_launches = ssd.launches
        got = read_losses(ckpt)
    r0 = res[0]
    ms = r0["step_ms"]
    med = statistics.median(ms[1:])
    cli = train.parse_args(TP_CLI)
    tokens = cli.seq_len * cli.batch
    gaps = {k: abs(got[k] - straight[k]) / abs(straight[k]) for k in got}
    finite = all(math.isfinite(v) for v in got.values())
    launches = [res[r]["launches"] for r in range(TP_WORLD)]

    def per_step(r, key):
        return statistics.median(c[key] for c in res[r]["collectives"][1:])

    say(phase, f"CLI in {TP_WORLD} ranks over gloo on one card "
        f"({' '.join(r0['argv'][:-2])}; {widths(cfg)}, bf16; a rank holds "
        f"{heads // TP_WORLD} of the {heads} heads, B and C of the conv "
        f"gathered): {med:.2f} ms a "
        f"step of {tokens} tokens (CUDA events on rank 0, median of steps "
        f"1-{DP_STEPS - 1}; all " + ", ".join(f"{t:.1f}" for t in ms)
        + f"), {tokens / med * 1e3:.0f} tokens/s; model-axis collectives a "
        f"step (gloo through the host: this one-card rig's cost, not a link "
        f"figure; median of steps 1-{DP_STEPS - 1}), by rank: "
        + "; ".join(
            f"rank {r}: {per_step(r, 'calls'):.0f} all-reduces, "
            f"{per_step(r, 'bytes') / 1e9:.3f} GB, transfer after a barrier "
            f"{per_step(r, 'transfer'):.1f} ms, wait at it "
            f"{per_step(r, 'wait'):.1f} ms" for r in range(TP_WORLD))
        + f" (rank 0's transfer, all steps: " + ", ".join(
            f"{c['transfer']:.1f}" for c in r0["collectives"])
        + f"); peak GiB a rank " + ", ".join(
            f"{res[r]['peak_gib']:.2f}" for r in range(TP_WORLD))
        + f"; B2 launches a rank {launches} in {DP_STEPS} steps ({want} a "
        f"step expected); wall {wall:.1f} s for the ranks (start, "
        f"{DP_STEPS} steps, checkpoint, tp2-qwen3moe) [{smi}]")
    say(phase, f"losses TP-2 " + ", ".join(
        f"{got[k]:.4f}" for k in range(DP_STEPS)) + f"; resumed in one "
        f"process (TP 2 -> 1, exit {rc_res}, {resumed_launches} B2 "
        f"launches) step {DP_STEPS}: {got.get(DP_STEPS, float('nan')):.4f}; "
        f"straight one-process " + ", ".join(
            f"{straight[k]:.4f}" for k in range(DP_STEPS + 1))
        + "; relative gaps " + ", ".join(
            f"{gaps[k]:.2e}" for k in sorted(gaps))
        + f" (limit {RESUME_RTOL:g})")
    m = r0["moe"]
    lgap = abs(m["loss"] - m["one_loss"]) / abs(m["one_loss"])
    ngap = abs(m["norm"] - m["one_norm"]) / abs(m["one_norm"])
    worst = max(m["gaps"].items(), key=lambda kv: kv[1])
    say("tp2-qwen3moe", f"{TP_MOE_ARCH} at full width cut to "
        f"{TP_MOE_LAYERS} of 48 layers, float32, {TP_MOE_SHAPE[1]} x "
        f"{TP_MOE_SHAPE[0]} tokens, one train step in {TP_WORLD} ranks "
        f"(experts, heads and vocabulary split) against one process on the "
        f"card: loss {m['loss']:.6f} vs {m['one_loss']:.6f} (relative gap "
        f"{lgap:.2e}, limit {TP_MOE_LOSS_RTOL:g}); grad_norm {m['norm']:.6e} "
        f"vs {m['one_norm']:.6e} (relative gap {ngap:.2e}, limit "
        f"{TP_MOE_NORM_RTOL:g}); gathered gradient max|diff| / max|g| worst "
        f"leaf {worst[0]} {worst[1]:.2e} (limit {TP_MOE_GRAD_TOL:g}); the "
        f"step {m['step_ms']:.1f} ms on rank 0; peak GiB a rank " + ", ".join(
            f"{res[r]['moe']['peak_gib']:.2f}" for r in range(TP_WORLD))
        + f", one process {m['one_peak_gib']:.2f} [{smi}]")
    ok = (all(res[r]["rc"] == 0 for r in range(TP_WORLD)) and rc_res == 0
          and all(n == want * DP_STEPS for n in launches)
          and resumed_launches == want and finite
          and sorted(got) == list(range(DP_STEPS + 1))
          and max(gaps.values()) <= RESUME_RTOL
          and lgap <= TP_MOE_LOSS_RTOL and ngap <= TP_MOE_NORM_RTOL
          and worst[1] <= TP_MOE_GRAD_TOL)
    if not ok:
        raise AssertionError(f"{phase}: check failed (exits "
                             f"{[res[r]['rc'] for r in range(TP_WORLD)]}/"
                             f"{rc_res}, launches {launches}/"
                             f"{resumed_launches}, losses {got}, gaps "
                             f"{gaps}, tp2-qwen3moe loss {lgap:.2e} norm "
                             f"{ngap:.2e} worst {worst})")
    serve = [res[r]["serve"] for r in range(TP_WORLD)]
    sv = say_serve_tp("serve-mamba2-tp2", configs.get(SERVE_TP_ARCH), serve,
                      smi)
    if max(sv["f32_gaps"]) > SERVE_TP_TOL:
        raise AssertionError(f"serve-mamba2-tp2: float32 gaps "
                             f"{sv['f32_gaps']} > {SERVE_TP_TOL:g}")
    CARD_RUNS["tp2"] = {"counted": r0["counted"],
                        "peaks": r0["step_peak_bytes"],
                        "launches_a_step": r0["launches"] / DP_STEPS}
    CARD_RUNS["serve-tp2"] = {**sv, "launches_by_rank": [
        x["launches"] for x in serve]}
    call = entry["tp2_call"]
    return {
        "name": "ssd_scan.ssd_scan (Mamba2 SSD chunked scan) at a "
                "model-parallel rank's call (B 8, S 4096, H 12)",
        "route": "cuda",
        "source": "src/repro_torch/kernels/csrc/ssd_scan.cu",
        "replaces": "src/repro/kernels/ssd_scan.py:49",
        "launches": launches[0],
        "launches_by_rank": launches,
        "max_abs_err": call["max_abs_err"],
        "ms": call["ms"],
        "plain_ms": call["plain_ms"],
        "bound_ms": call["bound_ms"],
        "bound_by": call["bound_by"],
        "library_ms": None,
        "grad_gaps": call["grad_gaps"],
        "ms_a_step": med, "tokens_s": tokens / med * 1e3,
    }


def phase_kernels_ssd_serve_tp2(dev, smi):
    """B2 at a model-parallel serving rank's call (SERVE_TP_SHAPE: 8
    prompts of 1024 tokens at 12 of mamba2-130m's 24 heads), with
    serve-mamba2-tp2's launches a rank (`ssd_call_entry`)."""
    return ssd_call_entry(
        dev, smi, SERVE_TP_SHAPE, "a model-parallel serving rank's call",
        CARD_RUNS["serve-tp2"]["launches_by_rank"],
        "in serve-mamba2-tp2's batch")


def phase_kernels_ssd_fsdp_zamba2(dev, smi):
    """B2 at train-zamba2-fsdp2's call (FSDP_ZAMBA2_SSD_SHAPE: a rank's 1
    x 4096 tokens at zamba2-2.7b's 80 heads), with that step's launches a
    rank (`ssd_call_entry`)."""
    return ssd_call_entry(
        dev, smi, FSDP_ZAMBA2_SSD_SHAPE, "an FSDP rank's call",
        [CARD_RUNS["fsdp2-zamba2"]["launches_a_step"]] * DP_WORLD,
        "a step in train-zamba2-fsdp2")


def ssd_call_entry(dev, smi, shape, where, launches, counted):
    """B2 at `shape` (B, S, H, G, N, P, Q), bf16 x/B/C, float32 y, held
    against ssd_scan_plain (`check_ssd`) and timed, on the schedule
    `ssd.schedule_of` picks.  Returns its kernels-line entry with
    `launches` (each rank's, counted in the run `counted` names)."""
    spec, args, _ = ssd_case(shape, 7, BF16, False, dev)
    launch = lambda: ssd.ssd_scan(spec, *args)  # noqa: E731
    y = uncounted(launch)[0]
    py = ssd.ssd_scan_plain(spec, *args)[0]
    err, rel, _ = check_ssd(f"y at {where}", y, py)
    del y, py
    ms = statistics.median(uncounted(lambda: cuda_ms(launch, reps=5))[0]
                           for _ in range(3))
    plain_ms, _ = cuda_ms(lambda: ssd.ssd_scan_plain(spec, *args))
    cost = ssd.kernel_cost(spec, shape[0], in_dtype=BF16)
    t_bytes = cost["min_bytes"] / HBM_BW * 1e3
    t_tc = cost["needed_flops"] / BF16_TC_PEAK * 1e3
    bound, by = max(t_bytes, t_tc), ("bytes" if t_bytes >= t_tc
                                     else "operations")
    schedule = ssd.schedule_of(spec, BF16)
    say("kernels-ssd", f"ssd_scan at {where} (B,S,H,G,N,P,Q)={shape}, bf16 "
        f"x/B/C, float32 y, {schedule} schedule: max|diff| {err:.3e} "
        f"(/max|plain| {rel:.2e}) against the plain scan; {ms:.3f} ms per "
        f"launch (median of 3 means of 5) vs bound {bound:.4f} ms by {by}; "
        f"plain {plain_ms:.1f} ms; {launches[0]} launches a rank {counted} "
        f"[{smi}]")
    return {
        "name": f"ssd_scan.ssd_scan (Mamba2 SSD chunked scan) at {where} "
                f"(B {shape[0]}, S {shape[1]}, H {shape[2]})",
        "route": "cuda",
        "source": "src/repro_torch/kernels/csrc/ssd_scan.cu",
        "replaces": "src/repro/kernels/ssd_scan.py:49",
        "launches": launches[0],
        "launches_by_rank": launches,
        "max_abs_err": err,
        "ms": ms,
        "plain_ms": plain_ms,
        "bound_ms": bound,
        "bound_by": by,
        "library_ms": None,
        "schedule": schedule,
    }


DRYRUN_PEAK_GAP = 0.25    # |predicted - card| / card, a rank's peak bytes


def serve_prefill_on_card(cfg, dev, plen):
    """serve-mamba2's prefill step on one device at its batch (SERVE_BATCH
    prompts of `plen` tokens, seed SERVE_SEED), after one uncounted
    warm-up: its B2 launches, collectives (none) and peak bytes."""
    from repro_torch.distributed.process_group import collective_counts

    params = api.init(SERVE_SEED, cfg, device=dev)
    rng = np.random.RandomState(SERVE_SEED)
    batch = {"tokens": torch.as_tensor(rng.randint(
        0, cfg.vocab_size, (SERVE_BATCH, plen)).astype(np.int32),
        device=dev)}
    prefill = make_prefill_step(cfg, serve_max_len(cfg))
    uncounted(lambda: prefill(params, batch))
    torch.cuda.synchronize()
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    ssd.launches = 0
    out = prefill(params, batch)
    torch.cuda.synchronize()
    del out
    none = collective_counts()
    return {"counted": [{**none, "total_bytes": 0}],
            "peaks": [torch.cuda.max_memory_allocated()],
            "launches_a_step": ssd.launches}


def phase_dryrun_vs_card(dev, smi):
    """dryrun-vs-card: the port's dry run (`launch.dryrun.lower_cell`, an
    eager trace on ``meta`` over a `RecordingGroup`, no card) of the
    four cells the card has just run: train-mamba2-tp2's step on its
    (1, 2) mesh, train-mamba2-fsdp2's and train-zamba2-fsdp2's on their
    (2, 1) mesh (FSDP), and serve-mamba2's prefill on one device (run
    here once more, counted).  Holds the predicted collectives (by class:
    counts and bytes a rank) equal to the ones the ranks counted in their
    last step, the predicted B2 launches equal to the counted ones a
    step, and the predicted peak a rank within DRYRUN_PEAK_GAP of
    `torch.cuda.max_memory_allocated` over that step.  Also prints the
    predicted peak of train-zamba2-fsdp2's step without FSDP (ZeRO-1
    alone), beside which its FSDP peak stands."""
    from repro_torch.configs.base import ShapeConfig
    from repro_torch.distributed import ShardingRules
    from repro_torch.launch import dryrun, train
    from repro_torch.launch.mesh import make_rank_view

    cfg = configs.get(TRAIN_ARCH)
    cli = train.parse_args(TRAIN_CLI)
    shape = ShapeConfig("train_cli", cli.seq_len, cli.batch, "train")
    tp_view = make_rank_view((1, TP_WORLD), ("data", "model"))
    fs_view = make_rank_view((DP_WORLD, 1), ("data", "model"))
    plen = SERVE_PROMPT[1]
    zcfg = dataclasses.replace(configs.get(FSDP_ZAMBA2_ARCH),
                               num_layers=FSDP_ZAMBA2_LAYERS)
    zshape = ShapeConfig("train_zamba2", *FSDP_ZAMBA2_SHAPE, "train")
    cells = [
        ("train-mamba2-tp2", cfg, shape, tp_view, None, CARD_RUNS["tp2"]),
        ("train-mamba2-fsdp2", cfg, shape, fs_view,
         ShardingRules(mesh=fs_view, cfg=cfg, fsdp=True), CARD_RUNS["fsdp2"]),
        ("train-zamba2-fsdp2", zcfg, zshape, fs_view,
         ShardingRules(mesh=fs_view, cfg=zcfg, fsdp=True),
         CARD_RUNS["fsdp2-zamba2"]),
        ("serve-mamba2 prefill", cfg, ShapeConfig("serve", plen, SERVE_BATCH,
                                                  "prefill"),
         make_rank_view((1, 1), ("data", "model")), None,
         serve_prefill_on_card(cfg, dev, plen)),
    ]
    torch.cuda.empty_cache()
    bad = []
    for name, ccfg, sh, view, rules, run in cells:
        t0 = time.perf_counter()
        trace, meta = dryrun.lower_cell(ccfg, sh, view, rules=rules)
        trace_s = time.perf_counter() - t0
        counted, peak = run["counted"][-1], run["peaks"][-1]
        same = (trace.collectives["counts"] == counted["counts"]
                and trace.collectives["bytes"] == counted["bytes"])
        scans = len(trace.ssd_calls)
        gap = abs(trace.peak_bytes - peak) / peak
        say("dryrun-vs-card", f"{name} ({meta['kind']}, mesh "
            f"{dict(view.shape)}, traced on meta in {trace_s:.1f} s): "
            f"collectives a rank predicted {trace.collectives['counts']} "
            f"({trace.collectives['total_bytes'] / 1e6:.3f} MB), counted "
            f"{counted['counts']} ({counted['total_bytes'] / 1e6:.3f} MB): "
            f"equal {same}; B2 launches predicted {scans}, counted "
            f"{run['launches_a_step']:g}; peak a rank predicted "
            f"{trace.peak_bytes / 2 ** 30:.3f} GiB, card "
            f"{peak / 2 ** 30:.3f} GiB (max_memory_allocated over the "
            f"step; gap {gap:.3f}, limit {DRYRUN_PEAK_GAP}); predicted "
            f"{trace.flops / 1e12:.3f} TFLOP, {trace.bytes_accessed / 1e9:.2f}"
            f" GB accessed (eager, unfused) [{smi}]")
        if not (same and scans == run["launches_a_step"]
                and gap <= DRYRUN_PEAK_GAP):
            bad.append(name)
    zero1, _ = dryrun.lower_cell(zcfg, zshape, fs_view, rules=ShardingRules(
        mesh=fs_view, cfg=zcfg))
    say("dryrun-vs-card", f"train-zamba2-fsdp2's step without FSDP (ZeRO-1 "
        f"alone): peak a rank predicted {zero1.peak_bytes / 2 ** 30:.3f} "
        f"GiB, collectives {zero1.collectives['counts']} "
        f"({zero1.collectives['total_bytes'] / 1e6:.3f} MB)")
    if bad:
        raise AssertionError(f"dryrun-vs-card: {bad} disagree with the card")


def run_path(name, smi, dev):
    """One main path; returns (its kernel entry, its TB run's ms, for
    acoustic the sharded path's and the bf16 tile's kernel entries, and
    its order-4 case's record for the nine-case summary)."""
    fc = full_case(name, dev, time_ms=MAIN_TIME_MS.get(name))
    state, recs32, launches, tb_ms, kept, peak = timed(
        f"main-{name}", phase_main_path, fc, smi)
    extra = []
    if kept is not None:
        four_rows = timed("sharded-acoustic", phase_sharded_acoustic, fc,
                          smi, (state, *kept), tb_ms)
        extra.append(four_rows)
        extra.append(timed("sharded-acoustic-ranks",
                           phase_sharded_acoustic_ranks, fc, smi,
                           (state, *kept), four_rows))
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
              "TB/SB": tb_ms / sb_ms, "half_depth": name in MAIN_TIME_MS}
    bf16, single = timed(f"main-{name}-bf16", phase_main_bf16, fc, smi,
                         state, recs32, tb_ms, peak)
    del recs32
    extra.append(bf16)
    if name == "acoustic":
        extra.append(timed("sharded-acoustic-bf16",
                           phase_sharded_acoustic_bf16, fc, smi, single,
                           tb_ms))
    del single
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


# main paths cut in depth, in simulated ms (the paper's 512 ms
# otherwise): elastic at order 4 runs 256 ms (the same width, plan and
# checks), so that serve-mamba2-tp2, train-mamba2-fsdp2 and
# dryrun-vs-card fit the script's time limit (PERF.md §4, "Depth cuts")
MAIN_TIME_MS = {"elastic": 256.0}
# the bf16 runs of the main paths cut below their float32 runs' depth, in
# simulated ms: TTI at half (nt 118 of 236), to keep the script inside its
# limit (the bf16 phases are cut first; elastic's runs at main-elastic's
# half depth, acoustic's whole: sharded-acoustic-bf16 meets it)
MAIN_BF16_MS = {"tti": 256.0}
SECONDS = {}                          # phase -> seconds
# the ranks' counted steps that dryrun-vs-card predicts: per step the
# collectives by class and the peak bytes, the B2 launches a step
CARD_RUNS = {}


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
        say("paper", f"{r['case']}: nt {r['nt']}"
            + (" (cut depth)" if r.get("half_depth") else "")
            + f", tile {tuple(r['tile'])} "
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
    timed("kernel-vs-plain-bf16-mp", phase_kernel_vs_plain_bf16_mp, dev)
    for name in ("acoustic", "tti", "elastic"):
        timed(f"kernel-vs-first-{name}", phase_kernel_vs_first, name, dev,
              smi)
    say("kernel-vs-plain", f"launches held against the plain version by "
        f"schedule (acoustic, TTI, elastic): {COMPARED}")
    b2 = timed("kernel-vs-plain-ssd", phase_kernel_vs_plain_ssd, dev, smi)
    b2z = timed("kernels-ssd-zamba2", phase_kernels_ssd_zamba2, dev, smi)
    timed("serve-mamba2", phase_serve, "serve-mamba2", dev, smi, b2)
    timed("serve-zamba2", phase_serve, "serve-zamba2", dev, smi, b2z)
    timed("serve-qwen3", phase_serve, "serve-qwen3", dev, smi, None)
    for phase in ("serve-qwen3moe", "serve-whisper", "serve-llava"):
        timed(phase, phase_serve, phase, dev, smi, None)
    trained = timed("train-mamba2", phase_train, dev, smi, b2)
    timed("train-mamba2-dp2", phase_train_dp, dev, smi, b2,
          trained["losses"])
    b2tp = timed("train-mamba2-tp2", phase_train_tp, dev, smi, b2,
                 trained["losses"])
    b2serve = timed("kernels-ssd-serve-tp2", phase_kernels_ssd_serve_tp2,
                    dev, smi)
    b2fsdp = timed("kernels-ssd-fsdp-zamba2", phase_kernels_ssd_fsdp_zamba2,
                   dev, smi)
    timed("dryrun-vs-card", phase_dryrun_vs_card, dev, smi)
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
    entries += [r["kernel_entry"] for r in paper if "kernel_entry" in r]
    for name, order in PAPER_BF16:
        record = next(r for r in paper
                      if (r["physics"], r["order"]) == (name, order))
        entries.append(timed(f"paper-{name}-O{order}-bf16",
                             phase_paper_bf16, name, order, smi, dev,
                             record))
    entries.append(timed("survey-acoustic", phase_survey_acoustic, smi, dev,
                         tb_ms["acoustic"]))
    timed("survey-tti", phase_survey_tti, smi, dev, tb_ms["tti"])
    entries += timed("survey-small", phase_survey_small, smi, dev)
    entries += extra + [b2, b2z, b2tp, b2serve, b2fsdp]
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
