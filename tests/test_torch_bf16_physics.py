"""The port's TTI and elastic temporally-blocked paths in bf16, and the
sharded pass in bf16, on the CPU (the plain versions of kernels B1b-bf16
and B1c-bf16; the CUDA kernels themselves are held to these plain versions
on the card by `chip_smoke.py`).

(a) `ops.tti_tb_propagate` / `ops.elastic_tb_propagate` with bf16 state
    and params against the reference's bf16 TB (`executor="jnp"`,
    and the Pallas kernel in interpret mode for one case a physics) on
    `test_torch_case.MULTI_CASES` at nt 4 (two tiles of T = 2) and nt 5 (a
    remainder tile).  The port computes in float32 and rounds once a store
    (`stencil_tb.window_tile_plain`); the reference computes op by op in
    bf16 (ROADMAP C2).  Their gap, max|diff| / max|float32| per field and
    receiver channel, is held under the measured worst rounded up to the
    next power of two (as `tests/test_torch_ops.py::
    test_bf16_gap_to_reference_bf16` holds acoustic's), and the port is no
    farther from the float32 run than the reference's bf16 is, in every
    field and channel (it holds in every case measured).
(b) The sharded pass in bf16 (`distributed.halo.sharded_tb_propagate`,
    the plain pass with the shards' domain masks: kernel B1c-bf16's
    function) against the single-device bf16 run of the same plan: on a
    2x2 and a 2x1 `ShardMesh` in one process, and in two ``gloo`` ranks
    one shard each (`_torch_halo_workers.halo_ranks`): the fields and the
    traces bit-equal, the receiver weights in bf16 in both (a pass hands
    its kernel the weights in the state's dtype, as the single-device
    tables hold them).
(c) The sizing of bf16 TTI and elastic launches: `launch_plan` picks the
    float32 schedule, `kernel_cost`'s least bytes are half of float32's,
    `_scratch_elems` keeps the z-streamed and B5 schedules' float32 scratch
    and prices the first schedule's bf16 and float32 windows, and
    `ops.propagation_bytes` takes the storage dtype's bytes where the
    fields are in it and float32's where the kernel keeps copies.
(d) The receivers' segment sum (`ops.combine_rec_partials`) does not hang
    on the order of its entries: it sums in float64 and rounds once, so
    the same partials in another order (as a card's atomic adds may land,
    or as the sharded pass lays them out) give the same samples bit for
    bit, in bf16 and in float32.
"""
import dataclasses
import types

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core.temporal_blocking import TBPlan as JPlan
from repro.kernels import tb_physics as jphys
from repro_torch.core import temporal_blocking as ttb
from repro_torch.distributed import halo as H
from repro_torch.kernels import ops, stencil_tb as ker, tb_physics as tphys
from repro_torch.launch import mesh as mesh_lib

import _torch_halo_workers as W
from _torch_dp_workers import run_ranks
from test_torch_case import MULTI_CASES, port_sparse
from test_torch_halo import CPU, _case
from test_torch_multiphysics import JAX, PORT, _jax_inputs, _plan

BF16 = torch.bfloat16
TILE, T = (6, 6), 2
# max|port bf16 - reference bf16| / max|float32| per field and receiver
# channel, measured: TTI 1.67e-2 (nt 4), 1.58e-2 (nt 5); elastic 1.12e-2,
# 1.50e-2; the Pallas interpret runs equal the jnp ones
GAP_CASES = [("tti", 4, "jnp", 2 ** -5), ("tti", 5, "jnp", 2 ** -5),
             ("tti", 4, "pallas", 2 ** -5),
             ("elastic", 4, "jnp", 2 ** -6), ("elastic", 5, "jnp", 2 ** -6),
             ("elastic", 4, "pallas", 2 ** -6)]
SHARD_SHAPE = (32, 32, 16)
# physics, mesh, T, inner tile (None: the shard block), inner T, nt
SHARD_CASES = [("acoustic", (2, 2), 4, (16, 16), 4, 7),
               ("tti", (2, 2), 2, (8, 8), 2, 5),
               ("elastic", (2, 2), 2, (8, 8), 1, 5),
               ("tti", (2, 1), 2, None, None, 3)]
RANK_CASES = [("acoustic", 4, 7), ("tti", 2, 5), ("elastic", 2, 5)]
TIMEOUT = 240.0


def _bf16(arrays):
    return tuple(torch.from_numpy(np.asarray(a)).to(BF16) for a in arrays)


def _channels(names, fields, rec):
    """(name, float64 array) of every field and receiver channel."""
    rec = np.asarray(rec, np.float64)
    rec = rec[..., None] if rec.ndim == 2 else rec
    return ([(n, np.asarray(a, np.float64)) for n, a in zip(names, fields)]
            + [(f"rec[{k}]", rec[..., k]) for k in range(rec.shape[-1])])


def _as_np(t):
    return (t.float() if t.dtype == BF16 else t).numpy()


@pytest.mark.parametrize("physics,nt,route,bound", GAP_CASES)
def test_bf16_gap_to_reference_bf16(physics, nt, route, bound):
    c = MULTI_CASES[physics](nt=nt)
    g, gr = port_sparse(c)
    plan = _plan(physics, c.order, TILE, T)
    propagate = PORT[physics][0]
    f, frec = propagate(nt, c.state, c.params, g, gr, plan, c.order, c.dt,
                        c.spacing, device="cpu")
    b, brec = propagate(nt, _bf16(c.state), _bf16(c.params), g, gr, plan,
                        c.order, c.dt, c.spacing, device="cpu")
    assert b[0].dtype == brec.dtype == BF16
    state_t, params_t, jpropagate, _ = JAX[physics]
    state, params, jg, jgr = _jax_inputs(c, True)
    j, jrec = jpropagate(
        nt, state_t(*(a.astype(jnp.bfloat16) for a in state)),
        params_t(*(a.astype(jnp.bfloat16) for a in params)), jg, jgr,
        JPlan(tile=TILE, T=T, radius=jphys.PHYSICS[physics].step_radius(4)),
        c.order, c.dt, c.spacing, executor=route)
    names = state_t._fields
    f32 = _channels(names, [_as_np(a) for a in f], _as_np(frec))
    port = _channels(names, [_as_np(a) for a in b], _as_np(brec))
    ref = _channels(names, [np.asarray(a.astype(jnp.float32)) for a in j],
                    np.asarray(jrec.astype(jnp.float32)))
    for (name, w), (_, p), (_, r) in zip(f32, port, ref):
        scale = np.abs(w).max()
        assert np.all(np.isfinite(p)), name
        gap = np.abs(p - r).max() / scale
        assert gap <= bound, f"{physics} nt={nt} {name}: {gap:.3e}"
        assert np.abs(p - w).max() <= np.abs(r - w).max(), \
            f"{physics} nt={nt} {name}: the port is farther from float32"


def _single_device(physics, nt, state, params, g, gr, tile, T_depth, dt,
                   spacing):
    p = tphys.PHYSICS[physics]
    plan = ttb.TBPlan(tile, T_depth, p.step_radius(4))
    if physics == "acoustic":
        (u0, u1), rec = ops.acoustic_tb_propagate(
            nt, *state, *params, g, gr, plan, 4, dt, spacing, device="cpu")
        return (u0, u1), rec
    return PORT[physics][0](nt, state, params, g, gr, plan, 4, dt, spacing,
                            device="cpu")


def _held(physics, fields, rec, sst, srec, what):
    """Fields and traces bit-equal."""
    p = tphys.PHYSICS[physics]
    for f, a, b in zip(p.state_fields, fields, sst):
        np.testing.assert_array_equal(a, b, err_msg=f"{what} {f}")
    got = dict(_channels((), (), rec))
    for name, want in _channels((), (), srec):
        np.testing.assert_array_equal(got[name], want,
                                      err_msg=f"{what} {name}")


@pytest.mark.parametrize("case", SHARD_CASES)
def test_sharded_bf16_matches_single_device_bf16(case):
    physics, pgrid, T_depth, tile, inner_T, nt = case
    p = tphys.PHYSICS[physics]
    c, state, params = _case(physics, SHARD_SHAPE, nt=nt, seed=4)
    g, gr = port_sparse(c)
    bst, bpr = _bf16(state), _bf16(params)
    plan = H.DistTBPlan(
        mesh=mesh_lib.ShardMesh(pgrid, devices=CPU), grid_shape=SHARD_SHAPE,
        physics=p, order=4, T=T_depth, dt=c.dt, spacing=c.spacing,
        inner="torch",
        inner_plan=(ttb.TBPlan(tile, inner_T, p.step_radius(4))
                    if tile else None))
    st, rec = H.sharded_tb_propagate(plan, nt, bst,
                                     dict(zip(p.param_fields, bpr)), g, gr)
    assert st[0].dtype == rec.dtype == BF16
    sst, srec = _single_device(physics, nt, bst, bpr, g, gr,
                               tile or plan.block, T_depth, c.dt, c.spacing)
    _held(physics, [_as_np(a) for a in st], _as_np(rec),
          [_as_np(a) for a in sst], _as_np(srec), f"{physics} {pgrid}")


_runs = {}


@pytest.fixture
def ranks_out(tmp_path):
    """Two gloo ranks, a 2x1 mesh one shard a rank, each RANK_CASES case
    in bf16 (`_torch_halo_workers.propagation_case`, flat passes)."""
    if "out" not in _runs:
        cases = []
        for physics, T_depth, nt in RANK_CASES:
            c, state, params = _case(physics, SHARD_SHAPE, nt=nt, seed=4)
            g, gr = port_sparse(c)
            cases.append(("propagation", (0, 1), (
                physics, (2, 1), SHARD_SHAPE, T_depth, None, None, nt, {},
                c.dt, _bf16(state), _bf16(params), g, gr)))
        _runs["out"] = run_ranks(W.halo_ranks, 2, str(tmp_path / "rdzv"),
                                 (cases,), timeout=TIMEOUT)
    return _runs["out"]


@pytest.mark.parametrize("n", range(len(RANK_CASES)))
def test_sharded_bf16_ranks_match_single_device_bf16(ranks_out, n):
    physics, T_depth, nt = RANK_CASES[n]
    c, state, params = _case(physics, SHARD_SHAPE, nt=nt, seed=4)
    g, gr = port_sparse(c)
    bst, bpr = _bf16(state), _bf16(params)
    res = [ranks_out[r][n] for r in (0, 1)]
    assert res[1]["fields"] is None
    np.testing.assert_array_equal(res[0]["rec"], res[1]["rec"])
    block = (SHARD_SHAPE[0] // 2, SHARD_SHAPE[1])
    sst, srec = _single_device(physics, nt, bst, bpr, g, gr, block, T_depth,
                               c.dt, c.spacing)
    _held(physics, res[0]["fields"], res[0]["rec"],
          [_as_np(a) for a in sst], _as_np(srec), f"{physics} ranks")
    assert all(r["rows"] and set(r["rows"]) == {1} for r in res)


def _spec(physics, T_depth, tile, order, dtype, caps=(4, 8)):
    p = tphys.PHYSICS[physics]
    return ops.make_spec((512, 512, 512),
                         ttb.TBPlan(tile, T_depth, p.step_radius(order)),
                         order, 1.0, (10.0,) * 3, *caps, dtype, p)


# (physics, T, tile, order, schedule): the bf16 paths' launches at 512^3
# (main-*-bf16 on the z-streamed schedule, the order-8 paper plans on B5)
# and launches on the first schedule (TTI's where no sub-tile is worth it)
SIZING = [("tti", 4, (32, 32), 4, "z-streamed"),
          ("elastic", 4, (32, 32), 4, "z-streamed"),
          ("tti", 2, (64, 64), 8, "cluster"),
          ("elastic", 2, (64, 64), 8, "cluster"),
          ("tti", 1, (4, 2), 8, "first"),
          ("elastic", 1, (32, 32), 4, "first")]


@pytest.mark.parametrize("physics,T_depth,tile,order,name", SIZING)
def test_bf16_launch_sizing(physics, T_depth, tile, order, name):
    p = tphys.PHYSICS[physics]
    s32 = _spec(physics, T_depth, tile, order, torch.float32)
    s16 = _spec(physics, T_depth, tile, order, BF16)
    plan = ker.launch_plan(s16, p)
    assert plan == ker.launch_plan(s32, p)
    assert ker.schedule_name(plan) == name
    c32, c16 = ker.kernel_cost(s32, p), ker.kernel_cost(s16, p)
    assert c16["min_bytes"] == c32["min_bytes"] / 2
    assert c16["needed_flops"] == c32["needed_flops"]
    e32, p32, d32 = ker._scratch_elems(s32, p)
    e16, p16, d16 = ker._scratch_elems(s16, p)
    ntx, nty = s16.ntiles
    wx, wy, nz = s16.window
    if name == "first":
        assert d16 == BF16 and p16 == 0
        # the storage windows in bf16 (elastic's with a spare that aligns
        # the rest), the float32 ones (TTI's three inner derivatives,
        # elastic's three unrounded velocities) at 4 bytes
        f32_windows = 3
        state_windows = {"tti": 4, "elastic": 10}[physics]
        assert e16 * 2 == ntx * nty * wx * wy * nz * (
            2 * state_windows + 4 * f32_windows)
    else:
        assert (e16, p16, d16) == (e32, p32, d32) == (e16, p16,
                                                      torch.float32)
    assert ker.scratch_bytes(s16, p, 2) == 2 * e16 * d16.itemsize
    assert ker.launch_shared_bytes(s16, p) == ker.launch_shared_bytes(s32, p)


@pytest.mark.parametrize("physics,T_depth,tile,order,name", SIZING[:4])
def test_propagation_bytes_bf16(physics, T_depth, tile, order, name):
    """`ops.propagation_bytes` in bf16: float32's less half of what is
    stored in the fields' dtype (the state and params, their padded copies
    and the launch's outputs and partials); the kernel's float32 scratch
    and param copies priced the same in both."""
    p = tphys.PHYSICS[physics]
    shape, nt = (512, 512, 512), 2 * T_depth + 1
    plan = ttb.TBPlan(tile, T_depth, p.step_radius(order))
    b32 = ops.propagation_bytes(p, shape, nt, plan, order)
    b16 = ops.propagation_bytes(p, shape, nt, plan, order, BF16)
    ns, npar = len(p.state_fields), len(p.param_fields)
    vol = np.prod(shape)
    specs = [_spec(physics, t, tile, order, torch.float32, (1, 1))
             for t in (T_depth, 1)]      # the caps propagation_bytes takes

    def padded(s):
        return (shape[0] + 2 * s.halo) * (shape[1] + 2 * s.halo) * shape[2]

    def stored(s):             # the larger tile's elements in the dtype
        ntx, nty = s.ntiles
        return (ns * padded(s) + ns * vol
                + ntx * nty * s.T * s.rec_cap * p.rec_channels)

    big = max(specs, key=lambda s: (ker.launch_shared_bytes(s, p)
                                    + ker.launch_bytes(s, p)
                                    - ker.scratch_bytes(s, p, 1)
                                    + ns * 4 * padded(s)))
    elems = (ns + npar) * vol + sum(npar * padded(s) for s in specs) \
        + stored(big)
    assert b32 - b16 == 2 * elems
    assert b16 < b32


def _combined(entries, rid, ntx, nty):
    """`ops.combine_rec_partials` of table entries (n, T, chan) with
    receiver ids `rid` (n,), laid out as ntx x nty tiles of n / (ntx nty)
    slots."""
    n, T_depth, chan = entries.shape
    capr = n // (ntx * nty)
    part = entries.reshape(ntx, nty, capr, T_depth, chan).permute(
        0, 1, 3, 2, 4)[None].contiguous()
    tab = types.SimpleNamespace(rid=torch.from_numpy(
        rid.reshape(1, ntx * nty, capr)))
    return ops.combine_rec_partials(part, tab, int(rid.max()) + 1)


@pytest.mark.parametrize("dtype", [BF16, torch.float32])
def test_combine_rec_partials_is_order_free(dtype):
    rng = np.random.RandomState(11)
    ntx, nty, capr, T_depth, chan, nrec = 4, 3, 6, 2, 2, 7
    n = ntx * nty * capr
    # each receiver's 8 grid points in slots scattered over the tiles, the
    # other slots empty (-1); partials of magnitudes 1e-3..1e2
    rid = np.full(n, -1, np.int32)
    rid[rng.permutation(n)[:8 * nrec]] = np.repeat(np.arange(nrec), 8)
    vals = rng.randn(n, T_depth, chan) * 10.0 ** rng.randint(
        -3, 3, size=(n, T_depth, chan))
    entries = torch.from_numpy(vals).to(dtype)
    got = _combined(entries, rid, ntx, nty)
    assert got.dtype == dtype and got.shape == (1, T_depth, nrec, chan)
    # each sample: the float64 sum of its partials, rounded once
    ent64 = entries.double().numpy()
    want = np.stack([ent64[rid == r].sum(0) for r in range(nrec)], 1)
    np.testing.assert_array_equal(
        got[0].double().numpy(),
        torch.from_numpy(want).to(dtype).double().numpy())
    for seed in range(4):
        perm = np.random.RandomState(seed).permutation(n)
        again = _combined(entries[perm], rid[perm], ntx, nty)
        assert torch.equal(again, got), f"order {seed}"
