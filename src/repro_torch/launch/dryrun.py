"""The dry run (port of `repro.launch.dryrun`): the language models' cells
traced on one rank's view of the production meshes, and the stencil's
plan report.

For every (architecture x input shape) cell the reference lowers and
compiles the real train_step / serve_step against ShapeDtypeStructs on a
512-device host mesh and reads XLA's `memory_analysis`, `cost_analysis`
and the collectives of the partitioned HLO.  Torch has neither analysis
(DESIGN.md §3), so the port runs the real step once, eagerly, on
``meta`` tensors (shapes and dtypes, no data, nothing allocated), as rank
0 of the mesh:

  * the single-pod production mesh  (16, 16)       = 256 devices
  * the multi-pod production mesh   (2, 16, 16)    = 512 devices

over a `distributed.process_group.RecordingGroup` (`launch.mesh.
make_rank_view`): no process runs; each collective of the rank's step
records its class and the bytes of its result on the rank.  The rank
holds its shards of the params, of the optimizer state and of the batch
or cache (`ShardingRules`' specs over `models.api`'s ``meta`` trees), and
the step is the one the launchers run (`launch.steps`).  Per cell:

  * ``flops``: `torch.utils.flop_counter.FlopCounterMode` over the step,
    plus kernel B2's `kernel_cost` at each SSD scan (`kernels.ssd_scan`'s
    ``meta`` route counts the kernel's work, not its plain version's);
  * ``bytes_accessed``: every aten op's inputs and outputs (views and
    copies from the host excluded), plus B2's bytes: eager, unfused
    traffic, an upper bound of what a fused program moves, not XLA's
    count;
  * ``collectives``: ``bytes``, ``counts`` and ``total_bytes`` by class;
  * ``memory``: ``argument_size_in_bytes`` and ``output_size_in_bytes``
    (the step's inputs and outputs, each storage once) and
    ``peak_bytes``, the most tensor bytes alive at once during the step
    (storages tracked as they are made and freed; a view or an in-place
    write adds nothing), and ``fits_h100``: the peak within the card's
    80 GB.

Usage (no card; nothing is allocated):
  python -m repro_torch.launch.dryrun --arch qwen3-1.7b --shape train_4k
  python -m repro_torch.launch.dryrun --all --both-meshes --out dry.json
"""
from __future__ import annotations

import argparse
import dataclasses
import json
import os
import time
import traceback
import weakref
from typing import Optional

import torch
from torch.utils._python_dispatch import TorchDispatchMode
from torch.utils._pytree import tree_leaves as _pytree_leaves
from torch.utils.flop_counter import FlopCounterMode

from repro_torch.configs.base import ModelConfig, ShapeConfig
from repro_torch.distributed.process_group import (COLLECTIVE_OPS,
                                                   collective_summary)

H100_BYTES = 80 * 10 ** 9          # the card's device memory

# The reference's `_shape_bytes` and `collective_bytes` parse the
# partitioned HLO for the collectives' result shapes.  The port has no
# HLO: the recorder counts each collective as the step runs it (class and
# result bytes a rank, `process_group.DataParallel.collectives`), and
# `analyze` reports those sums under the reference's keys.


# ---------------------------------------------------------------------------
# The stencil's plan report
# ---------------------------------------------------------------------------

def stencil_plan_report(physics: str, nz: int, order: int,
                        block, plan_cache=None, interp=None,
                        **plan_kwargs) -> dict:
    """Joint two-level TB plan selection for one per-shard stencil block
    (DESIGN.md §4).

    Runs `core.temporal_blocking.plan_hierarchy` (outer exchange depth x
    inner (tile, T) x overlapped-vs-serialized exchange, under the
    mesh-aware cost model) behind the survey plan cache
    (`survey/plan_cache.py`): a repeated cell answers from the cache, and
    the report's ``cache`` field records the key and hit/miss.  Records
    what the executor will do plus the per-field exchange-byte saving
    against the uniform-depth baseline and the window saving of the
    time-nested schedule against the flat plan at the same exchange depth.
    Consumed by `launch/stencil_dist.py --dryrun`.

    `interp` (a `core.interp.InterpSpec`; default multilinear) annotates
    the report: the ``interp`` field records the kernel, radius, and
    (2r)**3 footprint that size the sparse-point tables.  ``last_drift``
    is the last saved drift report's summary (`telemetry.drift`), None
    until one exists.  The hardware figures of the sweep default to the
    H100's (`autotune_plan`); with the reference's passed in
    `plan_kwargs` the report equals the reference's.
    """
    from repro_torch.core import interp as interp_mod
    from repro_torch.core.temporal_blocking import PHYSICS_COSTS, TBPlan
    from repro_torch.survey.plan_cache import cached_plan_hierarchy
    from repro_torch.telemetry import drift as drift_mod

    ispec = interp_mod.LINEAR if interp is None else interp
    hier, entry, info = cached_plan_hierarchy(physics, nz, order, block,
                                              cache=plan_cache,
                                              **plan_kwargs)
    uni = hier.exchange_bytes_uniform(nz)
    pf = hier.exchange_bytes(nz)
    fields = PHYSICS_COSTS[physics].fields
    flat_vmem = TBPlan(hier.inner.tile, hier.outer_T,
                       hier.inner.radius).vmem_bytes(nz, fields)
    return {
        "physics": physics, "order": order, "block": list(block), "nz": nz,
        "outer": {"T": hier.outer_T, "halo": hier.halo,
                  "overlap": hier.overlap,
                  "field_depths": list(hier.field_depths)},
        "inner": {"tile": list(hier.inner.tile), "T": hier.inner.T,
                  "passes": -(-hier.outer_T // hier.inner.T),
                  "grid": [block[0] // hier.inner.tile[0],
                           block[1] // hier.inner.tile[1]]},
        "exchange_bytes": int(pf),
        "exchange_bytes_uniform": int(uni),
        "exchange_saving": round(1.0 - pf / uni, 4) if uni else 0.0,
        "vmem_bytes": int(hier.vmem_bytes(nz, fields)),
        "vmem_bytes_flat": int(flat_vmem),
        "model": {k: entry[k] for k in
                  ("compute_s", "memory_s", "comm_s", "split_s", "cost_s")
                  if k in entry},
        "cache": {"key": info.key, "hit": info.hit},
        "interp": {**ispec.to_dict(), "footprint": ispec.footprint(3)},
        "last_drift": drift_mod.last_drift(),
    }


# ---------------------------------------------------------------------------
# Counting a traced step
# ---------------------------------------------------------------------------

def _tensors(tree) -> list:
    return [t for t in _pytree_leaves(tree) if isinstance(t, torch.Tensor)]


def storage_bytes(tree) -> int:
    """The bytes of the storages of `tree`'s tensors, each once."""
    seen = {}
    for t in _tensors(tree):
        s = t.untyped_storage()
        seen[id(s)] = s.nbytes()
    return sum(seen.values())


class StepCounter(TorchDispatchMode):
    """Counts what runs under it: every aten op's input and output bytes
    in `bytes_accessed` (views excluded: they move nothing; and copies
    between devices, rope's host frequencies to the card: not device
    memory traffic), and the
    tensor bytes alive: each storage made is counted once, from its
    first op to its release (a weakref on the storage), `live` now and
    `peak` the most.  `hold(tree)` counts a tree made before (the step's
    arguments) as alive."""

    def __init__(self):
        super().__init__()
        self.bytes_accessed = 0
        self.live = 0
        self.peak = 0
        self._refs = {}

    def hold(self, tree):
        for t in _tensors(tree):
            self._track(t)

    def _track(self, t):
        s = t.untyped_storage()
        key = id(s)
        if key in self._refs:
            return
        n = s.nbytes()
        self._refs[key] = weakref.ref(s, lambda _, k=key, n=n:
                                      self._free(k, n))
        self.live += n
        self.peak = max(self.peak, self.live)

    def _free(self, key, n):
        if self._refs.pop(key, None) is not None:
            self.live -= n

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        out = func(*args, **(kwargs or {}))
        ins, outs = _tensors((args, kwargs)), _tensors(out)
        devices = {t.device for t in ins + outs}
        if not func.is_view and len(devices) == 1:
            self.bytes_accessed += sum(t.numel() * t.element_size()
                                       for t in ins + outs)
        for t in _tensors(out):
            self._track(t)
        return out


@dataclasses.dataclass
class CellTrace:
    """What one traced step measured (the port's counterpart of the
    reference's compiled executable, which `analyze` reads)."""

    flops: float
    bytes_accessed: float
    collectives: dict
    argument_bytes: int
    output_bytes: int
    peak_bytes: int
    ssd_calls: list


def trace_step(fn, args, group) -> CellTrace:
    """fn(*args) once under the counters, `group` (the mesh's world
    recorder or process group) counting the collectives from zero; every
    SSD scan on ``meta`` adds B2's `kernel_cost`."""
    from repro_torch.distributed.process_group import collective_counts
    from repro_torch.kernels import ssd_scan as ssd

    fresh = collective_counts()
    if group is not None:
        for k in fresh:
            group.collectives[k].update(fresh[k])
    ssd.meta_calls.clear()
    counter = StepCounter()
    counter.hold(args)
    args_bytes = storage_bytes(args)
    flop_mode = FlopCounterMode(display=False)
    with flop_mode, counter:
        out = fn(*args)
    calls = list(ssd.meta_calls)
    ssd.meta_calls.clear()
    coll = (collective_summary(group.collectives) if group is not None
            else collective_summary(fresh))
    return CellTrace(
        flops=float(flop_mode.get_total_flops()
                    + sum(c["needed_flops"] for c in calls)),
        bytes_accessed=float(counter.bytes_accessed
                             + sum(c["min_bytes"] for c in calls)),
        collectives=coll, argument_bytes=args_bytes,
        output_bytes=storage_bytes(out), peak_bytes=counter.peak,
        ssd_calls=calls)


# ---------------------------------------------------------------------------
# Cells
# ---------------------------------------------------------------------------

def build_rules(cfg: ModelConfig, mesh, multi_pod: bool):
    """The reference's rules: data over ("pod", "data") on the multi-pod
    mesh, else "data"; FSDP where `needs_fsdp` (its 16 GiB default)."""
    from repro_torch.distributed.sharding import ShardingRules, needs_fsdp

    dp_axes = ("pod", "data") if multi_pod else ("data",)
    tp = mesh.shape["model"]
    return ShardingRules(mesh=mesh, cfg=cfg, dp_axes=dp_axes, tp_axis="model",
                         fsdp=needs_fsdp(cfg, tp))


def _shards(tree, specs, mesh, rank: int):
    """This rank's `shard_of` each leaf (``meta``: shapes only)."""
    from repro_torch.distributed.sharding import mesh_coords, shard_of
    from repro_torch.tree import tree_map

    coords = mesh_coords(mesh, rank)
    return tree_map(lambda t, s: shard_of(t, s, coords, mesh), tree, specs)


def _rows(batch: dict, rules, rank: int) -> dict:
    """This rank's rows of a global batch under `rules.batch_pspecs`."""
    from repro_torch.distributed.sharding import mesh_coords, shard_slices

    specs = rules.batch_pspecs(batch)
    coords = mesh_coords(rules.mesh, rank)
    return {k: v[shard_slices(v.shape, specs[k], coords, rules.mesh)]
            for k, v in batch.items()}


def _prompt(cfg: ModelConfig, shape: ShapeConfig) -> dict:
    """A one-token prompt batch (the vlm's with its image positions, the
    encdec's with seq_len encoder frames), whose prefill makes the cache
    a decode cell reads."""
    from repro_torch.models import api

    prompt = api.input_specs(cfg, dataclasses.replace(shape, kind="prefill"))
    prompt["tokens"] = prompt["tokens"][:, :1]
    return prompt


def lower_cell(cfg: ModelConfig, shape: ShapeConfig, mesh,
               multi_pod: bool = False, rules=None):
    """Trace one cell on rank 0 of `mesh` (a `launch.mesh.make_rank_view`
    mesh, or any mesh over a process group); returns (CellTrace, meta).
    `rules` defaults to `build_rules`'.  The rank's params, optimizer
    state and batch are its shards on ``meta``; a decode cell's cache is
    what the rank's prefill step makes of a one-token prompt (outside the
    counts), so its layout is the one the decode step reads."""
    from repro_torch.launch.steps import (make_prefill_step, make_train_step,
                                          serve_step, zero1_specs)
    from repro_torch.models import api
    from repro_torch.optim import AdamWConfig
    from repro_torch.optim.adamw import zero1_init

    rules = rules or build_rules(cfg, mesh, multi_pod)
    group = mesh.process_group
    rank = group.rank
    whole = api.param_specs(cfg, shape)
    params = _shards(whole, rules.param_pspecs(whole), mesh, rank)
    batch = api.input_specs(cfg, shape)

    if shape.kind == "train":
        opt = zero1_init(whole, zero1_specs(rules, whole), mesh, rank)
        del whole
        step = make_train_step(cfg, AdamWConfig(), rules)
        trace = trace_step(step, (params, opt, _rows(batch, rules, rank)),
                           group)
        return trace, {"kind": "train_step"}
    del whole
    if shape.kind == "prefill":
        step = make_prefill_step(cfg, max_len=shape.seq_len, rules=rules)
        return trace_step(step, (params, batch), group), \
            {"kind": "prefill_step"}
    _, cache = make_prefill_step(cfg, shape.seq_len, rules)(
        params, _prompt(cfg, shape))
    trace = trace_step(serve_step(cfg, rules),
                       (params, batch["tokens"], cache), group)
    return trace, {"kind": "serve_step"}


def analyze(trace: CellTrace) -> dict:
    """The reference's record keys from a traced step."""
    return {
        "memory": {"argument_size_in_bytes": trace.argument_bytes,
                   "output_size_in_bytes": trace.output_bytes,
                   "peak_bytes": trace.peak_bytes},
        "fits_h100": trace.peak_bytes <= H100_BYTES,
        "flops": trace.flops,
        "bytes_accessed": trace.bytes_accessed,
        "collectives": trace.collectives,
        "ssd_scans": len(trace.ssd_calls),
    }


def with_depth(cfg: ModelConfig, k: int) -> ModelConfig:
    """Reduced-depth variant with k 'depth units' (see depth_units)."""
    if cfg.family == "hybrid":
        return dataclasses.replace(cfg, num_layers=cfg.shared_attn_every * k)
    if cfg.family == "encdec":
        return dataclasses.replace(cfg, num_layers=2 * k,
                                   num_decoder_layers=2 * k)
    return dataclasses.replace(cfg, num_layers=2 * k)


def depth_units(cfg: ModelConfig) -> int:
    if cfg.family == "hybrid":
        return cfg.num_layers // cfg.shared_attn_every
    return cfg.num_layers // 2


def roofline_measure(cfg: ModelConfig, shape: ShapeConfig, mesh,
                     multi_pod: bool) -> dict:
    """Per-step FLOPs / bytes / collectives from two reduced-depth traces
    and the linear extrapolation cost(k) = c0 + k c_unit, the reference's
    measure and keys.  The reference needs it because XLA's cost analysis
    counts a loop body once; an eager trace counts every layer, so here
    it is a check: on homogeneous layers it equals the full-depth
    trace."""
    meas = {}
    for k in (1, 2):
        trace, _ = lower_cell(with_depth(cfg, k), shape, mesh, multi_pod)
        a = analyze(trace)
        meas[k] = {
            "flops": a["flops"],
            "bytes_accessed": a["bytes_accessed"],
            "collective_bytes": a["collectives"]["total_bytes"],
            "collectives": a["collectives"]["bytes"],
        }
    units = depth_units(cfg)

    def extrap(key):
        f1, f2 = meas[1][key], meas[2][key]
        return f1 + (units - 1) * (f2 - f1)

    coll = {}
    for op in COLLECTIVE_OPS:
        b1 = meas[1]["collectives"].get(op, 0)
        b2 = meas[2]["collectives"].get(op, 0)
        coll[op] = b1 + (units - 1) * (b2 - b1)
    return {
        "units": units,
        "per_unit_flops": meas[2]["flops"] - meas[1]["flops"],
        "flops": extrap("flops"),
        "bytes_accessed": extrap("bytes_accessed"),
        "collective_bytes": extrap("collective_bytes"),
        "collectives": coll,
        "raw": meas,
    }


def run_cell(arch: str, shape_name: str, multi_pod: bool,
             mesh=None, roofline: bool = False,
             remat: Optional[str] = None) -> dict:
    """One cell's record: the reference's keys; ``compile_s`` is the
    trace's seconds."""
    from repro_torch import configs
    from repro_torch.launch import mesh as mesh_lib
    from repro_torch.models import runtime

    cfg = configs.get(arch)
    if remat:
        cfg = dataclasses.replace(cfg, remat=remat)
    shape = configs.SHAPES[shape_name]
    rec = {"arch": arch, "shape": shape_name,
           "multi_pod": multi_pod, "kind": shape.kind}
    if shape_name == "long_500k" and cfg.family not in ("ssm", "hybrid"):
        rec["status"] = "skipped"
        rec["reason"] = ("long_500k needs sub-quadratic attention; "
                         f"{arch} is pure full attention (DESIGN.md §5)")
        return rec
    mesh = mesh or mesh_lib.make_rank_view(multi_pod=multi_pod)
    t0 = time.time()
    try:
        # memory-bounded attention schedule for long-context cells
        qc = 1024 if shape.seq_len >= 8192 else 0
        # shard-local MoE dispatch groups = DP degree
        dp = 1
        for a in ("pod", "data"):
            dp *= mesh.shape.get(a, 1)
        with runtime.attn_q_chunk(qc), runtime.moe_dp_groups(dp):
            trace, meta = lower_cell(cfg, shape, mesh, multi_pod)
            rec["attn_q_chunk"] = qc
            rec["moe_dp_groups"] = dp
            rec.update(meta)
            rec.update(analyze(trace))
            rec["fsdp"] = build_rules(cfg, mesh, multi_pod).fsdp
            rec["status"] = "ok"
            rec["compile_s"] = round(time.time() - t0, 2)
            rec["devices"] = mesh_lib.mesh_size(mesh)
            rec["model_params"] = cfg.param_count()
            rec["active_params"] = cfg.active_param_count()
            if roofline:
                rec["roofline"] = roofline_measure(cfg, shape, mesh,
                                                   multi_pod)
    except Exception as e:
        rec["status"] = "error"
        rec["error"] = f"{type(e).__name__}: {e}"
        rec["traceback"] = traceback.format_exc()[-4000:]
    return rec


def main(argv=None):
    from repro_torch import configs
    from repro_torch.launch import mesh as mesh_lib

    ap = argparse.ArgumentParser(
        description="trace each cell's step on rank 0 of the production "
                    "meshes, on meta tensors: needs no card, allocates "
                    "nothing")
    ap.add_argument("--arch", default=None)
    ap.add_argument("--shape", default=None)
    ap.add_argument("--all", action="store_true")
    ap.add_argument("--multipod", action="store_true")
    ap.add_argument("--both-meshes", action="store_true")
    ap.add_argument("--roofline", action="store_true",
                    help="add the depth-1/2 extrapolated accounting per cell")
    ap.add_argument("--remat", default=None,
                    choices=["full", "dots", "none"],
                    help="override the activation-checkpoint policy")
    ap.add_argument("--out", default=None)
    args = ap.parse_args(argv)

    archs = configs.ARCHS if (args.all or args.arch is None) \
        else [args.arch]
    shapes = list(configs.SHAPES) if (args.all or args.shape is None) \
        else [args.shape]
    meshes = [False, True] if args.both_meshes else [args.multipod]

    results = []
    for mp in meshes:
        mesh = mesh_lib.make_rank_view(multi_pod=mp)
        for arch in archs:
            for shape in shapes:
                rec = run_cell(arch, shape, mp, mesh=mesh,
                               roofline=args.roofline, remat=args.remat)
                results.append(rec)
                status = rec["status"]
                extra = ""
                if status == "ok":
                    coll = rec["collectives"]["total_bytes"]
                    extra = (f" flops={rec['flops']:.3e}"
                             f" coll={coll:.3e}B"
                             f" peak={rec['memory']['peak_bytes']:.3e}B"
                             f" t={rec['compile_s']}s")
                elif status == "error":
                    extra = " " + rec["error"][:120]
                print(f"[{'multi' if mp else 'single'}] {arch} x {shape}: "
                      f"{status}{extra}", flush=True)
                if args.out:
                    outdir = os.path.dirname(os.path.abspath(args.out))
                    os.makedirs(outdir, exist_ok=True)
                    with open(args.out, "w") as f:
                        json.dump(results, f, indent=1)
                if status == "ok":
                    print("   memory:", rec["memory"], flush=True)

    n_ok = sum(r["status"] == "ok" for r in results)
    n_skip = sum(r["status"] == "skipped" for r in results)
    n_err = sum(r["status"] == "error" for r in results)
    print(f"dry-run complete: {n_ok} ok, {n_skip} skipped, {n_err} errors")
    return 1 if n_err else 0


__all__ = ["COLLECTIVE_OPS", "CellTrace", "H100_BYTES", "StepCounter",
           "analyze", "build_rules", "depth_units", "lower_cell", "main",
           "roofline_measure", "run_cell", "stencil_plan_report",
           "storage_bytes", "trace_step", "with_depth"]

if __name__ == "__main__":
    raise SystemExit(main())
