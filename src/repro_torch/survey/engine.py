"""SurveyEngine: shot-parallel execution over the TB stack (port of
`repro.survey.engine`; DESIGN.md §6).

One survey = one model, many independent shots.  The engine amortizes
everything shot-invariant:

  plan      ONE autotune sweep per configuration via the plan cache
            (`survey/plan_cache.py`) — never per shot, never per bucket.
  build     ONE executable per (physics, bucket shape): shots are bucketed
            by padded (nsrc, nrec) (`survey/shots.py`), and a bucket's
            executable holds its kernel specs, table caps and the shared
            padded params, and runs a batch of `bucket_cap` shots through
            `kernels/ops.tb_propagate_prepared` — one kernel launch per
            time tile for the whole batch (the reference's `jax.jit` of
            `jax.vmap`).  Partial batches are padded with silent null shots,
            so every launch of a bucket has the same shapes.
  transfer  receiver traces are double-buffered: batch i's traces are
            copied to pinned host memory on a side stream while batch i+1
            is dispatched, and collected only after that.

Host-side per-shot work (the paper's §II precompute + per-tile table
binning) is numpy on the host; the batch's tables are staged in pinned
memory and copied without blocking, so nothing in the dispatch loop waits
for the card.

All static shapes derive from the bucket key alone: a window holds at most
all of a shot's affected points (<= footprint * nsrc_pad, footprint =
(2r)**3 for the interpolation radius r — 8 for the default trilinear
kernel) and a tile at most all receiver gather entries
(<= footprint * nrec_pad).  The extra slots carry weight 0.
"""
from __future__ import annotations

import dataclasses
import math
import time
from typing import Dict, List, NamedTuple, Optional, Sequence, Tuple, Union

import numpy as np
import torch

from repro_torch._device import as_tensor, resolve_device
from repro_torch.core import interp as interp_mod
from repro_torch.core import sources as src_mod
from repro_torch.core.grid import Grid
from repro_torch.core.temporal_blocking import TBPlan
from repro_torch.kernels import ops as ops_mod
from repro_torch.kernels import stencil_tb as ker
from repro_torch.kernels import tb_physics as phys
from repro_torch.survey.plan_cache import (CacheInfo, PlanCache,
                                           cached_plan_for_physics,
                                           default_cache)
from repro_torch.survey.shots import Shot, Survey, bucket_shots
from repro_torch.telemetry import metrics as _tm
from repro_torch.telemetry import spans as _spans


class _ShotArrays(NamedTuple):
    """Per-shot operands of `ops.tb_propagate_prepared` (host tensors; the
    batch builder stacks them along a new leading shot axis)."""

    src_dcmp: torch.Tensor
    src_tab: src_mod.TileSourceTable
    rec_tab: src_mod.TileReceiverTable
    rsrc_tab: Optional[src_mod.TileSourceTable]
    rrec_tab: Optional[src_mod.TileReceiverTable]


class SurveyResult(NamedTuple):
    """Traces per shot (survey order) + throughput/caching statistics.

    traces: list of (nt, nrec) host arrays ((nt, nrec, 2) for elastic),
            one per shot, cropped to the shot's ACTUAL receiver count.
    stats:  the `RUN_STATS_KEYS` of the reference.
    wavefields: final state tuples per shot (tensors on the engine's
            device) when requested, else None.
    """

    traces: List[np.ndarray]
    stats: dict
    wavefields: Optional[list] = None


# The public contract of `SurveyEngine.run(...).stats`: the reference's
# set, key for key.
RUN_STATS_KEYS = frozenset({
    "route", "physics", "executor", "shots",
    "seconds", "cold_seconds", "warm_seconds",
    "plan_seconds", "compile_seconds",
    "shots_per_s", "mpoints_per_s",
    "buckets", "batches", "bucket_cap", "bucket_keys",
    "interp", "footprint", "plan", "cache", "traces_per_bucket",
    "metrics",
})


def batch_bytes(physics: phys.TBPhysics, spec: ker.TBKernelSpec,
                rspec: Optional[ker.TBKernelSpec]) -> Tuple[int, int]:
    """(shared, per shot) device bytes a survey batch needs beside the model
    and the zero state: shared, the padded params of the main and the
    remainder tile and the kernel's copies of each
    (`stencil_tb.launch_shared_bytes`, which the engine makes once an
    executable); per shot, its state, padded state, launch outputs and
    scratch (`stencil_tb.launch_bytes`).  The tables, a few MB a shot,
    are not counted."""
    nx, ny, nz = spec.nx, spec.ny, spec.nz
    itemsize = spec.dtype.itemsize

    def padded(s):
        return (nx + 2 * s.halo) * (ny + 2 * s.halo) * nz * itemsize

    shared = sum(len(physics.param_fields) * padded(s)
                 + ker.launch_shared_bytes(s, physics)
                 for s in (spec, rspec) if s is not None)
    per_shot = (len(physics.state_fields)
                * (nx * ny * nz * itemsize + padded(spec))
                + ker.launch_bytes(spec, physics))
    return shared, per_shot


def free_device_bytes(device: torch.device) -> int:
    """Bytes a new block can be given on `device`: the device's free memory
    (`torch.cuda.mem_get_info`) and the caching allocator's segments that
    hold no live block, which it releases before it gives up
    (`torch.cuda.memory_snapshot`).  Free memory inside a segment that
    also holds a live tensor does not count: the allocator cannot join it
    with other memory into a larger block."""
    free, _ = torch.cuda.mem_get_info(device)
    index = (device.index if device.index is not None
             else torch.cuda.current_device())
    whole = sum(seg["total_size"] for seg in torch.cuda.memory_snapshot()
                if seg.get("device", index) == index
                and seg["allocated_size"] == 0 and seg["active_size"] == 0)
    return free + whole


def _default_tiles(nx: int, ny: int) -> Tuple[int, ...]:
    """Candidate tiles that divide the grid."""
    cands = tuple(t for t in (4, 8, 16, 32, 64, 128)
                  if nx % t == 0 and ny % t == 0)
    return cands or (nx,)


@dataclasses.dataclass
class _Executable:
    """One bucket's runnable: its kernel specs (caps from the bucket key),
    the shared padded params and the kernel's copies of them
    (`stencil_tb.param_copies`, None where the launch takes none), the
    kernel's scratch for both tiles (the engine's, None for the plain
    executor), and the batched tile loop."""

    spec: ker.TBKernelSpec
    rspec: Optional[ker.TBKernelSpec]
    param_pads: tuple
    rparam_pads: Optional[tuple]
    param_copies: Optional[torch.Tensor]
    rparam_copies: Optional[torch.Tensor]
    scratch: Optional[torch.Tensor]
    nrec_pad: int
    dispatches: int = 0

    def __call__(self, engine: "SurveyEngine", batch: _ShotArrays):
        self.dispatches += 1
        B = batch.src_dcmp.shape[0]
        zero = tuple(z.expand(B, *z.shape) for z in engine._zero_state)
        return ops_mod.tb_propagate_prepared(
            engine.physics, engine.nt, self.spec, self.rspec, zero,
            self.param_pads, self.rparam_pads, batch.src_dcmp,
            batch.src_tab, batch.rec_tab, batch.rsrc_tab, batch.rrec_tab,
            self.nrec_pad, executor=engine.executor,
            param_copies=self.param_copies,
            rparam_copies=self.rparam_copies, scratch=self.scratch)


class SurveyEngine:
    """Build-once, run-many multi-shot executor for one physics/model.

    Args:
      physics:    "acoustic" | "tti" | "elastic".
      grid:       the shared FD grid.
      params:     physics.param_fields -> (nx, ny, nz) model arrays or
                  tensors (shared by every shot — a survey is one model).
      nt:         timesteps per shot (uniform across the survey).
      dt:         timestep.
      order:      space order.
      executor:   "cuda" (`stencil_tb.tb_time_tile`: the CUDA kernel on a
                  card) or "torch" (its plain version); default "cuda" on
                  a card and "torch" on the CPU.
      plan:       a TBPlan to skip planning; default consults the plan
                  cache (ONE sweep per configuration).
      plan_cache: PlanCache instance (default: the process-wide cache).
      bucket_cap: shots per batch — every dispatch has exactly this many
                  (partial batches pad with null shots).  On a card, a cap
                  whose batch does not fit the free device memory raises,
                  at construction (`_check_memory`).
      interp:     an `interp.InterpSpec`, or a kernel name ("linear" /
                  "sinc") resolved with `interp_order` by `interp.spec_for`;
                  every precompute and all bucket caps derive from it.
      interp_order: support radius for a string `interp`.
      device:     where the survey runs (default "cuda", which raises
                  without a card; pass "cpu" to run on the CPU).
    """

    def __init__(self, physics: str, grid: Grid, params, nt: int,
                 dt: float, order: int = 4, executor: Optional[str] = None,
                 plan: Optional[TBPlan] = None,
                 plan_cache: Optional[PlanCache] = None,
                 bucket_cap: int = 4, plan_kwargs: Optional[dict] = None,
                 interp: Union[str, interp_mod.InterpSpec] = "linear",
                 interp_order: Optional[int] = None, device="cuda"):
        self.device = resolve_device(device)
        if executor is None:
            executor = "cuda" if self.device.type == "cuda" else "torch"
        if executor not in ops_mod.EXECUTORS:
            raise ValueError(f"unknown executor {executor!r}; expected one "
                             f"of {tuple(ops_mod.EXECUTORS)}")
        self.interp = (interp if isinstance(interp, interp_mod.InterpSpec)
                       else interp_mod.spec_for(interp, interp_order))
        self._footprint = self.interp.footprint(3)
        self.physics = phys.PHYSICS[physics]
        self.physics_name = physics
        self.grid = grid
        self.shape = tuple(grid.shape)
        self.params = {f: as_tensor(params[f], self.device)
                       for f in self.physics.param_fields}
        # a host copy of the model for the per-shot injection scale, so
        # preparing a shot never waits for the card
        self._host_params = {f: p.cpu() for f, p in self.params.items()}
        self.nt = int(nt)
        self.dt = float(dt)
        self.order = int(order)
        self.executor = executor
        self.bucket_cap = int(bucket_cap)
        if self.bucket_cap < 1:
            raise ValueError("bucket_cap must be >= 1")
        self.cache = plan_cache or default_cache()
        self.cache_info: Optional[CacheInfo] = None
        self.plan_entry: Optional[dict] = None
        # planning is cold time: the first run() claims it
        t_plan = time.perf_counter()
        if plan is None:
            kw = {"tiles": _default_tiles(*self.shape[:2]),
                  "depths": (1, 2, 4, 8), **(plan_kwargs or {})}
            extra = {"grid_shape": list(self.shape),
                     "use": "survey-single-device"}
            if self.device.type == "cuda":
                # a plan whose batch does not fit the card is no candidate
                total = torch.cuda.get_device_properties(
                    self.device).total_memory
                extra["device_bytes"] = int(total)
                kw["feasible"] = lambda p: self._fits(p, total)
            with _spans.span("survey.sweep", physics=physics):
                plan, self.plan_entry, self.cache_info = \
                    cached_plan_for_physics(
                        physics, self.shape[2], self.order, cache=self.cache,
                        key_extra=extra, **kw)
        else:
            with _spans.span("survey.sweep", physics=physics, skipped=True):
                pass
        self._plan_seconds = time.perf_counter() - t_plan
        self._plan_claimed = False
        self.plan = plan
        self.metrics = _tm.MetricsRegistry()
        self._zero_state = tuple(
            torch.zeros(self.shape, dtype=torch.float32, device=self.device)
            for _ in self.physics.state_fields)
        self._execs: Dict[Tuple[int, int], _Executable] = {}
        self._param_pads: Dict[int, tuple] = {}
        self._param_copies: Dict[int, Optional[torch.Tensor]] = {}
        self.trace_counts: Dict[Tuple[int, int], int] = {}
        # (device ms of the batch, device idle ms before it) per batch of
        # the last run, from CUDA events; empty on the CPU
        self.batch_times: List[Tuple[float, float]] = []
        self._side = (torch.cuda.Stream(self.device)
                      if self.device.type == "cuda" else None)
        # the kernel's scratch, made once by `_check_memory` and shared by
        # the buckets' executables (they run one after another on one
        # stream, and their specs differ only in table caps)
        self._scratch: Optional[torch.Tensor] = None
        if self.device.type == "cuda":
            self._check_memory()

    # --- static shapes from the bucket key ---------------------------------

    def _caps(self, key: Tuple[int, int]) -> Tuple[int, int, int]:
        """(npts_cap, src_cap, rec_cap): the worst case over ANY shot of
        this bucket shape."""
        nsrc_pad, nrec_pad = key
        npts_cap = self._footprint * nsrc_pad
        return npts_cap, npts_cap, self._footprint * nrec_pad

    def _specs(self, key: Tuple[int, int], plan: Optional[TBPlan] = None):
        plan = self.plan if plan is None else plan
        _, src_cap, rec_cap = self._caps(key)
        spec = ops_mod.make_spec(self.shape, plan, self.order, self.dt,
                                 self.grid.spacing, src_cap, rec_cap,
                                 physics=self.physics)
        rem = self.nt % spec.T
        rspec = None
        if rem > 0:
            rplan = dataclasses.replace(plan, T=rem)
            rspec = ops_mod.make_spec(self.shape, rplan, self.order, self.dt,
                                      self.grid.spacing, src_cap, rec_cap,
                                      physics=self.physics)
        return spec, rspec

    def _pads_for(self, halo: int):
        if halo not in self._param_pads:
            self._param_pads[halo] = tuple(
                ops_mod.pad_xy(self.params[f], halo, "edge")
                for f in self.physics.param_fields)
        return self._param_pads[halo]

    def _copies_for(self, spec: ker.TBKernelSpec):
        """The kernel's copies of the params padded for `spec`, made once
        (None for the plain executor or a launch that takes none)."""
        if spec.halo not in self._param_copies:
            self._param_copies[spec.halo] = (
                ker.param_copies(spec, self.physics, self._pads_for(spec.halo))
                if self.executor == "cuda" else None)
        return self._param_copies[spec.halo]

    def _batch_need(self, plan: TBPlan) -> int:
        """Device bytes a batch of `bucket_cap` shots needs at `plan`
        (`batch_bytes`)."""
        shared, per_shot = batch_bytes(self.physics,
                                       *self._specs((1, 1), plan))
        return shared + self.bucket_cap * per_shot

    def _fits(self, plan: TBPlan, budget: int) -> bool:
        try:
            return self._batch_need(plan) <= budget
        except ValueError:          # a tile that does not divide the grid
            return False

    def _check_memory(self):
        """Raise if one batch of `bucket_cap` shots cannot fit the card's
        memory, so a survey never fails halfway for want of memory: with
        the allocator's cache emptied, the batch's bytes (`batch_bytes`)
        against the memory a block can still be given
        (`free_device_bytes`); then the kernel's scratch, the batch's
        largest block, is made at once, and if the allocator cannot give
        it, this raises the same."""
        self._scratch = None
        torch.cuda.empty_cache()
        need = self._batch_need(self.plan)
        free = free_device_bytes(self.device)
        refuse = ValueError(
            f"bucket_cap={self.bucket_cap}: a batch of {self.physics_name}"
            f" {self.shape} with plan {self.plan.to_dict()} needs "
            f"{need / 2 ** 30:.2f} GiB of device memory, "
            f"{free / 2 ** 30:.2f} GiB is free; lower bucket_cap")
        if need > free:
            raise refuse
        if self.executor == "cuda":
            try:
                self._scratch = ker.make_scratch(
                    self._specs((1, 1)), self.physics, self.bucket_cap,
                    self.device)
            except torch.cuda.OutOfMemoryError:
                raise refuse from None

    # --- host-side per-shot precompute (paper §II) --------------------------

    def _prep_shot(self, shot: Shot, key: Tuple[int, int],
                   spec, rspec) -> _ShotArrays:
        npts_cap, src_cap, rec_cap = self._caps(key)
        cpu = "cpu"          # built on the host; `_stack_batch` moves them
        g = src_mod.precompute(src_mod.SparseOperator(shot.src_coords),
                               self.grid, shot.wavelet, interp=self.interp,
                               device=cpu)
        gr = src_mod.precompute_receivers(
            src_mod.SparseOperator(shot.rec_coords), self.grid,
            interp=self.interp, device=cpu)
        scale = np.asarray(
            self.physics.inject_scale(self._host_params, g, self.dt),
            np.float32)
        dcmp = np.zeros((self.nt, npts_cap), np.float32)
        dcmp[:, :g.npts] = g.src_dcmp.numpy()[:self.nt]

        def tabs(s):
            st = src_mod.tile_source_tables(
                g, self.shape, s.tile, s.halo, scale=scale, cap=src_cap,
                include_halo=s.T > 1, device=cpu)
            rt = src_mod.tile_receiver_tables(gr, self.shape, s.tile,
                                              s.halo, cap=rec_cap, device=cpu)
            return st, rt

        src_tab, rec_tab = tabs(spec)
        rsrc_tab = rrec_tab = None
        if rspec is not None:
            rsrc_tab, rrec_tab = tabs(rspec)
        return _ShotArrays(torch.from_numpy(dcmp), src_tab, rec_tab,
                           rsrc_tab, rrec_tab)

    def _stack_batch(self, preps: List[_ShotArrays], pad_to: int
                     ) -> _ShotArrays:
        """Stack per-shot operands along a new shot axis and move them to
        the device; partial batches replicate the last shot with a ZEROED
        wavelet table (a silent shot — its outputs are computed and
        discarded).  On a card the stack is staged in pinned memory and
        copied without blocking the host."""
        short = pad_to - len(preps)
        if short > 0:
            null = preps[-1]._replace(
                src_dcmp=torch.zeros_like(preps[-1].src_dcmp))
            preps = preps + [null] * short
        on_card = self.device.type == "cuda"

        def move(t):
            if on_card:
                t = t.pin_memory()
            return t.to(self.device, non_blocking=on_card)

        def stack(field):
            if field[0] is None:
                return None
            if isinstance(field[0], torch.Tensor):
                return move(torch.stack(field))
            return type(field[0])(*map(move, ops_mod.stack_tables(field)))

        return _ShotArrays(*(stack(f) for f in zip(*preps)))

    # --- the per-bucket executable ------------------------------------------

    def _executable(self, key: Tuple[int, int]) -> _Executable:
        if key not in self._execs:
            spec, rspec = self._specs(key)
            self._execs[key] = _Executable(
                spec, rspec, self._pads_for(spec.halo),
                self._pads_for(rspec.halo) if rspec is not None else None,
                self._copies_for(spec),
                self._copies_for(rspec) if rspec is not None else None,
                self._scratch, key[1])
            # one build per bucket: the count the reference keeps per jit
            # trace
            self.trace_counts[key] = self.trace_counts.get(key, 0) + 1
        return self._execs[key]

    # --- readback ----------------------------------------------------------

    def _start_readback(self, recs: torch.Tensor):
        """Start copying a batch's traces to the host; returns what
        `_finish_readback` needs.  On a card the copy runs on a side stream
        into pinned memory, after an event recorded behind the batch's
        last launch, and `record_stream` keeps `recs` alive until then."""
        if self._side is None:
            return recs, None
        done = torch.cuda.Event()
        done.record()
        self._side.wait_event(done)
        with torch.cuda.stream(self._side):
            host = torch.empty(recs.shape, dtype=recs.dtype,
                               pin_memory=True)
            host.copy_(recs, non_blocking=True)
            copied = torch.cuda.Event()
            copied.record(self._side)
        recs.record_stream(self._side)
        return host, copied

    @staticmethod
    def _finish_readback(readback) -> np.ndarray:
        host, copied = readback
        if copied is not None:
            copied.synchronize()
        return host.numpy()

    # --- run ---------------------------------------------------------------

    def run(self, survey: Union[Survey, Sequence[Shot]],
            return_wavefields: bool = False) -> SurveyResult:
        """Execute every shot; returns traces in survey order.

        Dispatch is pipelined: batch i+1's tables are built on the host
        and its launches queued while batch i computes, and batch i's
        traces are collected only after that.
        """
        shots = list(survey.shots if isinstance(survey, Survey) else survey)
        for s in shots:
            if s.nt != self.nt:
                raise ValueError(f"shot {s.shot_id} has nt={s.nt}, engine "
                                 f"built for nt={self.nt}")
        t_start = time.perf_counter()
        buckets = bucket_shots(shots)
        traces: List[Optional[np.ndarray]] = [None] * len(shots)
        fields: List = [None] * len(shots)
        pending = None  # (indices, readback, device state)
        n_batches = 0
        compile_seconds = 0.0  # wall of each bucket's first dispatch
        events = []            # (start, end) CUDA events per batch

        def collect(p):
            idxs, readback, st = p
            with _spans.span("survey.readback", shots=len(idxs)):
                host = self._finish_readback(readback)
            for row, i in enumerate(idxs):
                tr = host[row, :, :shots[i].nrec]  # crop the bucket padding
                if self.physics.rec_channels == 1:
                    tr = tr[..., 0]
                traces[i] = tr
                if return_wavefields:
                    fields[i] = tuple(f[row] for f in st)

        for key, bucket in buckets.items():
            ex = self._executable(key)
            for lo in range(0, len(bucket), self.bucket_cap):
                chunk = bucket.shots[lo:lo + self.bucket_cap]
                idxs = bucket.indices[lo:lo + self.bucket_cap]
                with _spans.span("survey.prep", bucket=key, n=len(chunk)):
                    preps = [self._prep_shot(s, key, ex.spec, ex.rspec)
                             for s in chunk]
                    if self._side is not None:
                        start = torch.cuda.Event(enable_timing=True)
                        start.record()
                    batch = self._stack_batch(preps, self.bucket_cap)
                first = ex.dispatches == 0
                t0 = time.perf_counter()
                state_b, recs_b = ex(self, batch)
                d = time.perf_counter() - t0
                if self._side is not None:
                    end = torch.cuda.Event(enable_timing=True)
                    end.record()
                    events.append((start, end))
                _spans.add_span("survey.dispatch", t0, d, bucket=key)
                if first:
                    # the first dispatch of a bucket includes its kernel's
                    # build (nvcc) on first use
                    compile_seconds += d
                    _spans.add_span("survey.compile", t0, d, bucket=key)
                    self.metrics.histogram("survey.compile_s").observe(d)
                else:
                    self.metrics.histogram("survey.dispatch_s").observe(d)
                readback = self._start_readback(recs_b)
                n_batches += 1
                if pending is not None:
                    collect(pending)
                # the batch's final state stays alive only if asked for
                pending = (idxs, readback,
                           state_b if return_wavefields else None)
                del state_b, recs_b
        if pending is not None:
            collect(pending)
        seconds = time.perf_counter() - t_start
        _spans.add_span("survey.run", t_start, seconds, shots=len(shots))

        self.batch_times = []
        for i, (start, end) in enumerate(events):
            end.synchronize()
            gap = events[i - 1][1].elapsed_time(start) if i else 0.0
            self.batch_times.append((start.elapsed_time(end), gap))
            self.metrics.histogram("survey.batch_ms").observe(
                self.batch_times[-1][0])
            if i:
                self.metrics.histogram("survey.idle_ms").observe(gap)

        plan_seconds = 0.0 if self._plan_claimed else self._plan_seconds
        self._plan_claimed = True
        cold_seconds = plan_seconds + compile_seconds
        warm_seconds = max(seconds - compile_seconds, 1e-12)

        n = len(shots)
        pts = float(math.prod(self.shape)) * self.nt * n
        self.metrics.counter("survey.shots").inc(n)
        self.metrics.counter("survey.batches").inc(n_batches)
        stats = {
            "route": "batched",
            "physics": self.physics_name, "executor": self.executor,
            "shots": n, "seconds": seconds,
            "cold_seconds": cold_seconds, "warm_seconds": warm_seconds,
            "plan_seconds": plan_seconds,
            "compile_seconds": compile_seconds,
            "shots_per_s": n / warm_seconds,
            "mpoints_per_s": pts / warm_seconds / 1e6,
            "buckets": len(buckets), "batches": n_batches,
            "bucket_cap": self.bucket_cap,
            "bucket_keys": [list(k) for k in buckets],
            "interp": self.interp.to_dict(),
            "footprint": self._footprint,
            "plan": self.plan.to_dict(),
            "cache": {"sweeps": self.cache.sweeps,
                      **({"key": self.cache_info.key,
                          "hit": self.cache_info.hit}
                         if self.cache_info else {})},
            "traces_per_bucket": {str(k): v
                                  for k, v in self.trace_counts.items()},
            "metrics": self.metrics.snapshot(),
        }
        return SurveyResult(traces=traces, stats=stats,
                            wavefields=fields if return_wavefields else None)


    # --- the mesh route: shot after shot through the sharded layer --------

    def run_sharded(self, survey: Union[Survey, Sequence[Shot]],
                    dist_plan) -> SurveyResult:
        """Run the survey's shots one by one through
        `distributed.halo.sharded_tb_propagate` on `dist_plan`'s mesh —
        domain-parallel per shot instead of shot-parallel, for models too
        large for one card.  The sharded layer sizes its table caps from
        each shot's geometry, so shots are not batched here; traces come
        back in survey order, as from `run`.  On a rank's view of a mesh
        (`launch.mesh.make_rank_mesh`) every rank of its group calls this
        with the same survey: each runs every shot on its own shard, and
        every rank gets every shot's traces."""
        from repro_torch.distributed.halo import sharded_tb_propagate

        shots = list(survey.shots if isinstance(survey, Survey) else survey)
        if dist_plan.physics.name != self.physics.name:
            raise ValueError(f"dist_plan is for {dist_plan.physics.name}, "
                             f"engine for {self.physics.name}")
        t_start = time.perf_counter()
        traces: List[np.ndarray] = []
        for s in shots:
            if s.nt != self.nt:
                raise ValueError(f"shot {s.shot_id} has nt={s.nt}, "
                                 f"engine built for nt={self.nt}")
            g = src_mod.precompute(
                src_mod.SparseOperator(s.src_coords), self.grid, s.wavelet,
                interp=self.interp, device=self.device)
            gr = src_mod.precompute_receivers(
                src_mod.SparseOperator(s.rec_coords), self.grid,
                interp=self.interp, device=self.device)
            with _spans.span("survey.sharded_shot", shot=s.shot_id) as sp:
                _, rec = sharded_tb_propagate(
                    dist_plan, self.nt, self._zero_state, self.params, g=g,
                    receivers=gr)
                sp.sync(rec)
            tr = rec.cpu().numpy()
            traces.append(tr[..., 0] if self.physics.rec_channels == 1
                          else tr)
        seconds = time.perf_counter() - t_start
        n = len(shots)
        pts = float(np.prod(self.shape)) * self.nt * n
        stats = {
            "route": "sharded", "physics": self.physics_name,
            "shots": n, "seconds": seconds,
            "shots_per_s": n / seconds if seconds else float("inf"),
            "mpoints_per_s": pts / seconds / 1e6 if seconds else 0.0,
            "mesh": dict(dist_plan.mesh.shape),
            "ranks": (1 if dist_plan.mesh.process_group is None
                      else dist_plan.mesh.process_group.world),
            "outer_T": dist_plan.T, "inner": dist_plan.inner,
            "cache": {"sweeps": self.cache.sweeps},
        }
        return SurveyResult(traces=traces, stats=stats)


__all__ = ["RUN_STATS_KEYS", "SurveyEngine", "SurveyResult",
           "batch_bytes", "free_device_bytes"]
