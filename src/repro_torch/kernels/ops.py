"""Drivers of the temporally-blocked kernel (port of `repro.kernels.ops`).

`acoustic_tb_propagate`, `tti_tb_propagate` and `elastic_tb_propagate` are
the production entry points: the outer time-tile loop of the paper's
Listing 6 (depth-T time tiles plus one shallower ``nt % T`` remainder
tile, one kernel launch each), with the per-tile source/receiver tables
precomputed once on the host from the paper's grid-aligned structures.
`acoustic_sb_propagate` (T = 1) is the spatially-blocked baseline the
paper compares against.

The driver is split at the host/device boundary as in the reference:
`_tb_propagate` builds the tables; `tb_propagate_prepared` runs the tile
loop on tensors.  The tile loop runs a batch of B shots at once (the
survey engine's bucket; a single propagation is B = 1): state, source
values and tables carry a leading shot axis, the padded params are shared.
Each time tile runs through one of two executors with the same window
schedule: ``"cuda"`` (`stencil_tb.tb_time_tile`: one CUDA kernel launch
for the batch on a card, its plain version on CPU tensors) or ``"torch"``
(`stencil_tb.tb_time_tile_plain`, the plain version everywhere).
"""
from __future__ import annotations

import dataclasses
from typing import Dict, Optional, Tuple

import torch
import torch.nn.functional as F

from repro_torch._device import as_tensor, resolve_device
from repro_torch.core import sources as src_mod
from repro_torch.core.propagators import elastic, tti
from repro_torch.core.temporal_blocking import TBPassGeom, TBPlan
from repro_torch.kernels import stencil_tb as ker
from repro_torch.kernels import tb_physics as phys
from repro_torch.telemetry import spans as _spans

# executor name -> time-tile function (same window schedule)
EXECUTORS = {"cuda": ker.tb_time_tile, "torch": ker.tb_time_tile_plain}


def pad_xy(a: torch.Tensor, h: int, mode: str) -> torch.Tensor:
    """Pad the x and y axes of a (..., nx, ny, nz) tensor by `h`: zeros
    ("constant") or copies of the edge values ("edge", numpy's mode of
    that name)."""
    if mode == "constant":
        return F.pad(a, (0, 0, h, h, h, h))
    if mode == "edge":
        nx, ny = a.shape[-3], a.shape[-2]
        ix = torch.arange(-h, nx + h, device=a.device).clamp(0, nx - 1)
        iy = torch.arange(-h, ny + h, device=a.device).clamp(0, ny - 1)
        return a.index_select(-3, ix).index_select(-2, iy)
    raise ValueError(f"unknown pad mode {mode!r}")


def stack_tables(tabs):
    """Per-shot tables of one shape (a list of `TileSourceTable` or of
    `TileReceiverTable`) as one table whose fields carry a leading shot
    axis."""
    return type(tabs[0])(*(torch.stack(f) for f in zip(*tabs)))


def _dummy_tables(B: int, ntiles: int, T: int, dev):
    coords = torch.zeros((B, ntiles, 1, 3), dtype=torch.int32, device=dev)
    vals = torch.zeros((B, ntiles, T, 1), dtype=torch.float32, device=dev)
    return coords, vals


def build_tables(spec: ker.TBKernelSpec,
                 g: Optional[src_mod.GriddedSources],
                 receivers: Optional[src_mod.GriddedReceivers],
                 params: Dict[str, torch.Tensor],
                 physics: phys.TBPhysics = phys.ACOUSTIC,
                 src_cap: Optional[int] = None,
                 rec_cap: Optional[int] = None):
    """Host-side precompute of the per-tile tables (paper §II.A).

    `params` maps physics.param_fields names to the (unpadded) model
    tensors; the physics supplies the per-point injection factor.
    `src_cap`/`rec_cap` bound entries per tile; None auto-sizes, a too-small
    cap raises the overflow error naming the tile and the required cap.
    The tables land on the device of the params.

    Returns (src_tab | None, rec_tab | None).
    """
    shape = (spec.nx, spec.ny, spec.nz)
    dev = params[physics.param_fields[0]].device
    src_tab = rec_tab = None
    if g is not None:
        scale = physics.inject_scale(params, g, spec.dt)
        src_tab = src_mod.tile_source_tables(g, shape, spec.tile, spec.halo,
                                             scale=scale, cap=src_cap,
                                             include_halo=spec.T > 1,
                                             device=dev)
    if receivers is not None:
        rec_tab = src_mod.tile_receiver_tables(receivers, shape, spec.tile,
                                               spec.halo, cap=rec_cap,
                                               device=dev)
    return src_tab, rec_tab


def _src_vals_for_tile(src_dcmp: torch.Tensor, src_tab, t0: int, T: int):
    """(B, ntiles, T, cap) injection values for the time tile starting at
    t0 (contiguous, as the kernel takes them), from `src_dcmp`
    (B, nt, npts) and a table with a leading shot axis."""
    B = src_dcmp.shape[0]
    vals = src_dcmp[:, t0:t0 + T]                          # (B, T, npts)
    safe_sid = src_tab.sid.clamp(min=0).long()             # (B, ntiles, cap)
    ntiles, cap = safe_sid.shape[1:]
    idx = safe_sid.reshape(B, 1, ntiles * cap).expand(B, vals.shape[1], -1)
    sv = vals.gather(2, idx).reshape(B, -1, ntiles, cap)   # (B, T, ...)
    return (sv.permute(0, 2, 1, 3)
            * src_tab.scale[:, :, None, :]).contiguous()


def combine_rec_partials(rec_part: torch.Tensor, rec_tab, nrec: int):
    """(B, ntx, nty, T, capr, nchan) partials -> (B, T, nrec, nchan)
    samples (segment sum over receiver ids with `index_add_`, each shot's
    ids offset into its own segment; paper Fig. 3b).  The sum is taken in
    float64 and rounded once to the partials' dtype: a receiver's partials
    (one a grid point it reads, at most 8) sum exactly there unless they
    span more than 2^42 (bf16) or 2^26 (float32), so the samples do not
    hang on the order in which a card's atomic adds land (in bf16 they
    did, by a few bf16 spacings from run to run)."""
    B, ntx, nty, T, capr, nchan = rec_part.shape
    rid = rec_tab.rid.long()                               # (B, ntiles, capr)
    shot = torch.arange(B, device=rid.device)[:, None, None]
    ids = (torch.where(rid < 0, nrec, rid) + shot * (nrec + 1)).reshape(-1)
    vals = rec_part.reshape(B, ntx * nty, T, capr, nchan)
    vals = vals.permute(0, 1, 3, 2, 4).reshape(-1, T, nchan)
    seg = torch.zeros((B * (nrec + 1), T, nchan), dtype=torch.float64,
                      device=rec_part.device).index_add_(0, ids, vals.double())
    return seg.reshape(B, nrec + 1, T, nchan)[:, :nrec].permute(
        0, 2, 1, 3).to(rec_part.dtype)


def tile_operands(spec: ker.TBKernelSpec, state, src_dcmp, src_tab,
                  rec_tab, t0: int):
    """What one time tile starting at step t0 hands the kernel for a batch
    of shots (`state` fields (B, nx, ny, nz), `src_dcmp` (B, nt, npts),
    tables with a leading shot axis): (zero-padded state, src_coords,
    src_vals, rec_coords, rec_w) — dummy one-slot tables stand in for
    missing sources or receivers."""
    ntx, nty = spec.ntiles
    ntiles = ntx * nty
    B = state[0].shape[0]
    dev = state[0].device
    if src_tab is not None:
        s_coords = src_tab.coords
        s_vals = _src_vals_for_tile(src_dcmp, src_tab, t0, spec.T)
    else:
        s_coords, s_vals = _dummy_tables(B, ntiles, spec.T, dev)
    s_vals = s_vals.to(spec.dtype)
    if rec_tab is not None:
        r_coords, r_w = rec_tab.coords, rec_tab.weight
    else:
        r_coords, _ = _dummy_tables(B, ntiles, 1, dev)
        r_w = torch.zeros((B, ntiles, 1), dtype=torch.float32, device=dev)
    r_w = r_w.to(spec.dtype)
    state_pads = tuple(pad_xy(f, spec.halo, "constant") for f in state)
    return state_pads, s_coords, s_vals, r_coords, r_w


def _run_time_tile(spec: ker.TBKernelSpec, physics: phys.TBPhysics,
                   carry: list, param_pads, src_dcmp, src_tab, rec_tab,
                   t0: int, nrec: int, executor: str, param_copies=None,
                   scratch=None):
    """One time tile from the state in `carry`, a one-element list that is
    emptied once the state is zero-padded: the launch then does not hold
    the unpadded state beside its padded copy and its outputs (the
    caller's first state stays, held by the caller)."""
    # a no-op unless telemetry is enabled; names the region on a
    # torch.profiler timeline and records its host (enqueue) time
    with _spans.annotate("ops.tile_pass", T=spec.T, tile=spec.tile,
                         executor=executor):
        state = carry.pop()
        B, dev = state[0].shape[0], state[0].device
        state_pads, s_coords, s_vals, r_coords, r_w = tile_operands(
            spec, state, src_dcmp, src_tab, rec_tab, t0)
        del state
        new_state, rec_part = EXECUTORS[executor](
            spec, physics, state_pads, param_pads, s_coords, s_vals,
            r_coords, r_w, param_copies=param_copies, scratch=scratch)
        if rec_tab is not None:
            rec = combine_rec_partials(rec_part, rec_tab, nrec)
        else:
            rec = torch.zeros((B, spec.T, 0, physics.rec_channels),
                              dtype=spec.dtype, device=dev)
    return new_state, rec


def make_spec(shape: Tuple[int, int, int], plan: TBPlan, order: int,
              dt: float, spacing: Tuple[float, float, float],
              src_cap: int, rec_cap: int, dtype=torch.float32,
              physics: phys.TBPhysics = phys.ACOUSTIC) -> ker.TBKernelSpec:
    return ker.TBKernelSpec(
        nx=shape[0], ny=shape[1], nz=shape[2], tile=plan.tile, T=plan.T,
        order=order, dt=float(dt), spacing=tuple(float(s) for s in spacing),
        src_cap=src_cap, rec_cap=rec_cap, dtype=dtype,
        step_radius=physics.step_radius(order),
        rec_channels=physics.rec_channels)


def make_inner_spec(block: Tuple[int, int], nz: int,
                    inner_tile: Tuple[int, int], T: int, order: int,
                    dt: float, spacing: Tuple[float, float, float],
                    src_cap: int, rec_cap: int, dtype,
                    physics: phys.TBPhysics) -> ker.TBKernelSpec:
    """Kernel spec for the inner trapezoid of one shard: the shard's
    (bx, by) block plays the kernel's grid and the shard's exchanged halo
    its zero padding; the kernel's grid is `block / inner_tile` tiles, each
    a window `inner_tile + 2 * T * r_step` wide, sliced at the same
    `(ti * tx, tj * ty)` origin from every field and the shard's domain
    mask."""
    bx, by = block
    tx, ty = inner_tile
    if bx % tx or by % ty:
        raise ValueError(f"inner tile {inner_tile} must divide the shard "
                         f"block {block}")
    return ker.TBKernelSpec(
        nx=bx, ny=by, nz=nz, tile=(tx, ty), T=T, order=order, dt=float(dt),
        spacing=tuple(float(s) for s in spacing), src_cap=src_cap,
        rec_cap=rec_cap, dtype=dtype, step_radius=physics.step_radius(order),
        rec_channels=physics.rec_channels)


def pass_inner_spec(geom: TBPassGeom, nz: int, order: int, dt: float,
                    spacing: Tuple[float, float, float], src_cap: int,
                    rec_cap: int, dtype,
                    physics: phys.TBPhysics) -> ker.TBKernelSpec:
    """Kernel spec for one pass of the time-nested inner schedule: its grid
    is the shard block plus the halo still valid after the pass
    (`geom.d_out`, rounded up to the inner tile), its halo the pass's
    consumption `geom.T * r_step` — so the window, and the kernel's
    scratch, are sized by the pass, whatever the exchange depth."""
    return make_inner_spec(geom.grid, nz, geom.tile, geom.T, order, dt,
                           spacing, src_cap, rec_cap, dtype, physics)


def prepare_tiles(plan: TBPlan, physics: phys.TBPhysics,
                  field: torch.Tensor, params: Dict[str, torch.Tensor],
                  g: Optional[src_mod.GriddedSources],
                  receivers: Optional[src_mod.GriddedReceivers],
                  order: int, dt: float,
                  spacing: Tuple[float, float, float]):
    """Host-side setup of depth-plan.T time tiles of one shot on `field`'s
    grid, dtype and device: (spec with caps sized to the tables,
    src_tab | None, rec_tab | None, edge-padded param tuple); the tables
    carry a leading shot axis of 1, as `tb_propagate_prepared` takes
    them."""
    shape, dtype = tuple(field.shape), field.dtype
    spec = make_spec(shape, plan, order, dt, spacing, 1, 1, dtype, physics)
    # the tables depend on tile/halo/dt only, so the caps come from them
    src_tab, rec_tab = build_tables(spec, g, receivers, params, physics)
    spec = dataclasses.replace(
        spec, src_cap=src_tab.cap if src_tab is not None else 1,
        rec_cap=rec_tab.coords.shape[1] if rec_tab is not None else 1)
    param_pads = tuple(pad_xy(params[f], spec.halo, "edge")
                       for f in physics.param_fields)
    src_tab, rec_tab = (None if t is None else stack_tables([t])
                        for t in (src_tab, rec_tab))
    return spec, src_tab, rec_tab, param_pads


def tb_propagate_prepared(physics: phys.TBPhysics, nt: int,
                          spec: ker.TBKernelSpec,
                          rspec: Optional[ker.TBKernelSpec],
                          state: Tuple[torch.Tensor, ...],
                          param_pads, rparam_pads,
                          src_dcmp: torch.Tensor, src_tab, rec_tab,
                          rsrc_tab, rrec_tab, nrec: int,
                          executor: str = "cuda", param_copies=None,
                          rparam_copies=None, scratch=None):
    """The device-side core of `_tb_propagate`: the loop over depth-T time
    tiles plus the shallower `nt % T` remainder tile, after all host-side
    table binning, for a batch of B shots — one kernel launch per time
    tile for the whole batch.  `state` fields are (B, nx, ny, nz),
    `src_dcmp` (B, nt, npts), the tables carry a leading shot axis
    (`stack_tables`), and the param pads are shared by the shots.
    `rspec` is None when `nt % spec.T == 0`.  `param_copies` /
    `rparam_copies` are the kernel's copies of the param pads for `spec` /
    `rspec` (`stencil_tb.param_copies`): a caller that runs many
    propagations on one model makes them once; otherwise they are made
    here, once for the loop, the remainder's after the main tiles' are
    let go.  `scratch` is the kernel's working memory for both tiles
    (`stencil_tb.make_scratch`), which a survey engine owns; otherwise it
    is made here before the first launch and freed with the loop.
    `propagation_bytes` counts what a propagation holds at its peak.

    Returns (final state tuple (B, nx, ny, nz) each, recs
    (B, nt, nrec, rec_channels)); recs are shaped (B, nt, 0, chan) when no
    receiver tables were bound.
    """
    n_main = nt // spec.T
    rem = nt - n_main * spec.T
    if (rem > 0) != (rspec is not None):
        raise ValueError(f"nt={nt} with T={spec.T} needs "
                         f"{'a' if rem else 'no'} remainder spec")
    if executor == "cuda" and param_copies is None and n_main:
        param_copies = ker.param_copies(spec, physics, param_pads)
    if executor == "cuda" and scratch is None and (n_main or rem):
        scratch = ker.make_scratch((spec if n_main else None, rspec),
                                   physics, state[0].shape[0],
                                   state[0].device)
    carry = [tuple(state)]
    recs = []
    for i in range(n_main):
        new, rec = _run_time_tile(spec, physics, carry, param_pads,
                                  src_dcmp, src_tab, rec_tab, i * spec.T,
                                  nrec, executor, param_copies, scratch)
        carry.append(new)
        recs.append(rec)
        del new                       # the carry holds the only reference
    if rem > 0:
        param_copies = None
        if executor == "cuda" and rparam_copies is None:
            rparam_copies = ker.param_copies(rspec, physics, rparam_pads)
        new, rec = _run_time_tile(rspec, physics, carry, rparam_pads,
                                  src_dcmp, rsrc_tab, rrec_tab,
                                  n_main * spec.T, nrec, executor,
                                  rparam_copies, scratch)
        carry.append(new)
        recs.append(rec)
    if not recs:
        return carry[0], torch.zeros((state[0].shape[0], 0, nrec,
                                      physics.rec_channels),
                                     dtype=spec.dtype,
                                     device=state[0].device)
    return carry[0], torch.cat(recs, dim=1)


def propagation_bytes(physics: phys.TBPhysics, shape: Tuple[int, int, int],
                      nt: int, plan: TBPlan, order: int,
                      dtype=torch.float32) -> int:
    """Device bytes a single-shot propagation (`_tb_propagate` on the
    ``"cuda"`` executor) holds at its peak, from sizes: the state it is
    given and the params, the edge-padded params of the main and the
    remainder tile, the kernel's scratch (one block for both,
    `stencil_tb.make_scratch`) and, during the larger of the two tiles,
    the kernel's copies of that tile's params, the zero-padded state and
    the launch's outputs.  The tables and the receiver partials' caps
    (a few MB) are left out.  The grid fits the card when this is below
    its free memory."""
    nx, ny, nz = shape
    item = torch.tensor([], dtype=dtype).element_size()
    ns, npar = len(physics.state_fields), len(physics.param_fields)
    specs = [make_spec(shape, dataclasses.replace(plan, T=T), order, 1.0,
                       (1.0,) * 3, 1, 1, dtype, physics)
             for T in ((plan.T,) if nt >= plan.T else ()) + (
                 (nt % plan.T,) if nt % plan.T else ())]

    def padded(s):
        return (nx + 2 * s.halo) * (ny + 2 * s.halo) * nz * item

    scratch = max(ker.scratch_bytes(s, physics, 1) for s in specs)
    held = (ns + npar) * nx * ny * nz * item + scratch
    held += sum(npar * padded(s) for s in specs)
    return held + max(ker.launch_shared_bytes(s, physics) + ns * padded(s)
                      + ker.launch_bytes(s, physics)
                      - ker.scratch_bytes(s, physics, 1) for s in specs)


def _tb_propagate(physics: phys.TBPhysics, nt: int,
                  state: Tuple[torch.Tensor, ...],
                  params: Dict[str, torch.Tensor],
                  g: Optional[src_mod.GriddedSources],
                  receivers: Optional[src_mod.GriddedReceivers],
                  plan: TBPlan, order: int, dt,
                  spacing: Tuple[float, float, float],
                  executor: str = "cuda"):
    """Propagate nt timesteps of `physics` with the temporally-blocked
    kernel: time tiles of depth plan.T, then a remainder tile of depth
    nt % T — `tb_propagate_prepared` on a batch of one shot.  `state` is
    ordered as physics.state_fields; `params` maps physics.param_fields to
    (nx, ny, nz) tensors, on the state's device.

    Returns (final state tuple, rec (nt, nrec, rec_channels) | None).
    """
    if g is not None and g.nt < nt:
        raise ValueError(f"source wavelets cover {g.nt} steps < nt={nt}")
    args = (physics, state[0], params, g, receivers, order, float(dt),
            spacing)
    with _spans.span("ops.tables", physics=physics.name, nt=nt, T=plan.T):
        spec, src_tab, rec_tab, param_pads = prepare_tiles(plan, *args)
        rspec = rsrc_tab = rrec_tab = rparam_pads = None
        if nt % plan.T:
            # the remainder tile's tables differ: its halo is shallower
            rspec, rsrc_tab, rrec_tab, rparam_pads = prepare_tiles(
                dataclasses.replace(plan, T=nt % plan.T), *args)
    nrec = receivers.num if receivers is not None else 0
    src_dcmp = (g.src_dcmp if g is not None
                else torch.zeros((max(nt, 1), 1), dtype=state[0].dtype,
                                 device=state[0].device))

    with _spans.span("ops.propagate", physics=physics.name, nt=nt,
                     T=spec.T, executor=executor) as sp:
        carry, recs = tb_propagate_prepared(
            physics, nt, spec, rspec, tuple(f[None] for f in state),
            param_pads, rparam_pads, src_dcmp[None], src_tab, rec_tab,
            rsrc_tab, rrec_tab, nrec, executor=executor)
        sp.sync((carry, recs))
    carry = tuple(f[0] for f in carry)
    return carry, (recs[0] if receivers is not None else None)


# ---------------------------------------------------------------------------
# Entry points
# ---------------------------------------------------------------------------

def _propagate_on(physics: phys.TBPhysics, nt: int, state, params, g,
                  receivers, plan: TBPlan, order: int, dt, spacing,
                  executor: Optional[str], device):
    """`_tb_propagate` of `physics` with the fields (numpy arrays or
    tensors, `state` ordered as physics.state_fields, `params` a mapping
    over physics.param_fields) and the sparse structures moved to
    `device`.  `executor` defaults to ``"cuda"`` on a card and ``"torch"``
    on the CPU."""
    dev = resolve_device(device)
    if executor is None:
        executor = "cuda" if dev.type == "cuda" else "torch"
    if executor not in EXECUTORS:
        raise ValueError(f"unknown executor {executor!r}; "
                         f"expected one of {tuple(EXECUTORS)}")
    state = tuple(as_tensor(a, dev) for a in state)
    params = {f: as_tensor(params[f], dev) for f in physics.param_fields}
    g = g.to(dev) if g is not None else None
    receivers = receivers.to(dev) if receivers is not None else None
    return _tb_propagate(physics, nt, state, params, g, receivers, plan,
                         order, dt, spacing, executor=executor)


def acoustic_tb_propagate(nt: int, u0, u1, m, damp,
                          g: Optional[src_mod.GriddedSources],
                          receivers: Optional[src_mod.GriddedReceivers],
                          plan: TBPlan, order: int, dt,
                          spacing: Tuple[float, float, float],
                          executor: Optional[str] = None,
                          device="cuda"):
    """Acoustic TB propagation.  Returns ((u_prev, u), rec (nt, nrec) | None).

    The fields (numpy arrays or tensors) are moved to `device` (default
    ``"cuda"``, which raises without a card).  `executor` defaults to
    ``"cuda"`` on a card and ``"torch"`` on the CPU.  Semantics identical
    to `kernels.ref.acoustic_reference` (tested).
    """
    (u0n, u1n), recs = _propagate_on(
        phys.ACOUSTIC, nt, (u0, u1), {"m": m, "damp": damp}, g, receivers,
        plan, order, dt, spacing, executor, device)
    if recs is not None:
        recs = recs[..., 0]
    return (u0n, u1n), recs


def tti_tb_propagate(nt: int, state, params,
                     g: Optional[src_mod.GriddedSources],
                     receivers: Optional[src_mod.GriddedReceivers],
                     plan: TBPlan, order: int, dt,
                     spacing: Tuple[float, float, float],
                     executor: Optional[str] = None, device="cuda"):
    """TTI TB propagation from a `tti.TTIState` with `tti.TTIParams`
    (numpy arrays or tensors, moved to `device` as in
    `acoustic_tb_propagate`).

    Returns (TTIState, rec (nt, nrec) | None) matching
    `kernels.ref.tti_reference` (tested)."""
    final, recs = _propagate_on(
        phys.TTI, nt, tti.TTIState(*state), tti.TTIParams(*params)._asdict(),
        g, receivers, plan, order, dt, spacing, executor, device)
    if recs is not None:
        recs = recs[..., 0]
    return tti.TTIState(*final), recs


def elastic_tb_propagate(nt: int, state, params,
                         g: Optional[src_mod.GriddedSources],
                         receivers: Optional[src_mod.GriddedReceivers],
                         plan: TBPlan, order: int, dt,
                         spacing: Tuple[float, float, float],
                         executor: Optional[str] = None, device="cuda"):
    """Elastic TB propagation from an `elastic.ElasticState` with
    `elastic.ElasticParams` (moved to `device` as in
    `acoustic_tb_propagate`).

    Returns (ElasticState, rec (nt, nrec, 2) | None) — channels are (vz,
    pressure proxy), matching `kernels.ref.elastic_reference` (tested)."""
    final, recs = _propagate_on(
        phys.ELASTIC, nt, elastic.ElasticState(*state),
        elastic.ElasticParams(*params)._asdict(), g, receivers, plan, order,
        dt, spacing, executor, device)
    return elastic.ElasticState(*final), recs


def acoustic_sb_propagate(nt: int, u0, u1, m, damp, g, receivers,
                          tile: Tuple[int, int], order: int, dt, spacing,
                          executor: Optional[str] = None, device="cuda"):
    """The paper's baseline: spatially-blocked only (T = 1)."""
    plan = TBPlan(tile=tile, T=1, radius=order // 2)
    return acoustic_tb_propagate(nt, u0, u1, m, damp, g, receivers, plan,
                                 order, dt, spacing, executor=executor,
                                 device=device)
