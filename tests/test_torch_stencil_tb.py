"""The port's TB time tile (CPU: the plain version) against the Pallas
kernel `repro.kernels.stencil_tb.tb_time_tile` in interpret mode, on
identical pads and tables (tolerance of the reference kernel tests:
rtol 2e-4, atol 1e-6)."""
import numpy as np
import jax.numpy as jnp
import pytest
import torch

from repro.core import sources as JS
from repro.core.grid import Grid as JGrid
from repro.core.temporal_blocking import TBPlan as JPlan
from repro.kernels import ops as jops, stencil_tb as jker, \
    tb_physics as jphys
from repro_torch import interop
from repro_torch.kernels import stencil_tb as tker, tb_physics as tphys
from test_torch_case import acoustic_case
from test_torch_cluster import _choice

RTOL, ATOL = 2e-4, 1e-6


def _inputs(c, tile, T, sources=True):
    """Reference spec, pads and per-tile inputs of one time tile at t0=1."""
    grid = JGrid(shape=c.shape, spacing=c.spacing)
    params = {"m": jnp.asarray(c.m), "damp": jnp.asarray(c.damp)}
    plan = JPlan(tile=tile, T=T, radius=c.order // 2)
    spec = jops.make_spec(c.shape, plan, c.order, c.dt, c.spacing, 1, 1)
    g = JS.precompute(JS.SparseOperator(c.src), grid, c.wav)
    gr = JS.precompute_receivers(JS.SparseOperator(c.rec), grid)
    st, rt = jops.build_tables(spec, g if sources else None,
                               gr if sources else None, params)
    ntiles = spec.ntiles[0] * spec.ntiles[1]
    if sources:
        spec = jops.make_spec(c.shape, plan, c.order, c.dt, c.spacing,
                              st.cap, rt.coords.shape[1])
        sc, sv = st.coords, jops._src_vals_for_tile(g.src_dcmp, st, 1, T)
        rc, rw = rt.coords, rt.weight
    else:
        sc, sv = jops._dummy_tables(ntiles, T)
        rc, rw = jnp.zeros((ntiles, 1, 3), jnp.int32), jnp.zeros((ntiles, 1))
    h = spec.halo
    pads = [jops._pad_xy(jnp.asarray(a), h, "constant")
            for a in (c.u0, c.u1)]
    ppads = [jops._pad_xy(params[f], h, "edge") for f in ("m", "damp")]
    return spec, pads, ppads, (sc, sv.astype(jnp.float32), rc,
                               rw.astype(jnp.float32)), st, rt


def _port_spec(spec):
    return tker.TBKernelSpec(
        nx=spec.nx, ny=spec.ny, nz=spec.nz, tile=spec.tile, T=spec.T,
        order=spec.order, dt=spec.dt, spacing=spec.spacing,
        src_cap=spec.src_cap, rec_cap=spec.rec_cap,
        step_radius=spec.step_radius, rec_channels=spec.rec_channels)


def _t(a):
    return torch.from_numpy(np.array(a))


@pytest.mark.parametrize("T,tile,order,shape,sources", [
    (2, (8, 8), 4, (16, 16, 12), True),
    (3, (16, 8), 2, (16, 16, 10), True),
    (1, (8, 8), 8, (16, 8, 9), True),
    (2, (8, 8), 4, (16, 16, 12), False),
])
def test_time_tile_matches_pallas_interpret(T, tile, order, shape, sources):
    c = acoustic_case(shape=shape, order=order, nt=6, nsrc=1, nrec=2)
    spec, pads, ppads, tabs, _, _ = _inputs(c, tile, T, sources)
    (j0, j1), jrec = jker.tb_time_tile(spec, jphys.ACOUSTIC, pads, ppads,
                                       *tabs, interpret=True)
    tspec = _port_spec(spec)
    # one shot: a shot axis of 1 on the state, the tables and the outputs
    targs = ((_t(pads[0])[None], _t(pads[1])[None]),
             (_t(ppads[0]), _t(ppads[1])), *(_t(a)[None] for a in tabs))
    before = tker.launches
    (t0, t1), trec = tker.tb_time_tile(tspec, tphys.ACOUSTIC, *targs)
    assert tker.launches == before        # CPU tensors: the plain version
    for a, b in ((t0, j0), (t1, j1), (trec, jrec)):
        assert tuple(a.shape) == (1,) + tuple(b.shape)
        np.testing.assert_allclose(a[0].numpy(), np.asarray(b), rtol=RTOL,
                                   atol=ATOL)
    (p0, p1), prec = tker.tb_time_tile_plain(tspec, tphys.ACOUSTIC, *targs)
    for a, b in ((p0, t0), (p1, t1), (prec, trec)):
        assert torch.equal(a, b)


def test_interop_tables_feed_the_port():
    """The reference's tables cross through `interop` unchanged."""
    c = acoustic_case()
    spec, _, _, _, st, rt = _inputs(c, (8, 8), 2)
    ts, tr = interop.tile_tables_from_numpy(st, rt, device="cpu")
    for x, y in zip(ts + tr, st + rt):
        np.testing.assert_array_equal(x.numpy(), np.asarray(y))
    assert ts.coords.dtype == torch.int32 and tr.weight.dtype == torch.float32
    assert interop.tile_tables_from_numpy(device="cpu") == (None, None)


def test_spec_geometry_and_cost():
    jspec = jker.TBKernelSpec(nx=64, ny=64, nz=64, tile=(32, 32), T=4,
                              order=4, dt=1e-3, spacing=(10.0,) * 3,
                              src_cap=8, rec_cap=8)
    spec = _port_spec(jspec)
    assert (spec.halo, spec.window, spec.ntiles) == \
        (jspec.halo, jspec.window, jspec.ntiles)
    assert spec.window_bytes() == jspec.vmem_bytes()
    cost = tker.kernel_cost(spec)
    jcost = jker.kernel_cost(jspec)
    assert cost["useful_flops"] == jcost["useful_flops"]
    assert cost["hbm_bytes"] == jcost["hbm_bytes"]
    assert cost["min_bytes"] == 64 ** 3 * 6 * 4
    assert cost["flops"] > cost["useful_flops"] > 0
    assert cost["needed_flops"] == cost["useful_flops"]
    with pytest.raises(ValueError):
        _ = tker.TBKernelSpec(nx=10, ny=8, nz=4, tile=(4, 4), T=1, order=2,
                              dt=1e-3, spacing=(1.0,) * 3, src_cap=1,
                              rec_cap=1).ntiles


def _spec(physics, shape, tile, T, order):
    from repro_torch.core.temporal_blocking import TBPlan
    from repro_torch.kernels import ops
    return ops.make_spec(shape, TBPlan(tile, T, physics.step_radius(order)),
                         order, 1e-3, (10.0,) * 3, 1, 1, physics=physics)


@pytest.mark.parametrize("name,tile,T,order,want", [
    # the main plans fit a block whole (csrc/stencil_tb*.cu's notes)
    ("acoustic", (32, 32), 4, 4, (32, 32, 217728)),
    ("elastic", (32, 32), 4, 4, (32, 32, 163840)),
    # TTI: phase B's first pass (rings of Dx~p, Dz~r and two planes of
    # Dy~p over 60^2) outgrows phase A's (rings of p, r over 64^2)
    ("tti", (32, 32), 4, 4, (32, 32, 201600)),
    # deeper or wider stencils take the largest sub-tile that fits
    ("acoustic", (32, 32), 4, 8, (16, 16, 224000)),
    ("elastic", (16, 16), 4, 8, (8, 8, 207360)),
    # TTI's phase A rings then outgrow phase B's: 10 planes of p and r
    # over 48^2
    ("tti", (32, 32), 2, 8, (16, 16, 184320)),
    ("tti", (32, 32), 1, 12, (16, 16, 179200)),
])
def test_stream_plan_picks_the_largest_fitting_subtile(name, tile, T, order,
                                                       want):
    p = tphys.PHYSICS[name]
    spec = _spec(p, (64, 64, 16), tile, T, order)
    assert tker.stream_plan(spec, p) == want
    assert want[2] <= tker._STREAM_SMEM
    # the next larger candidates do not fit
    bx, by, _ = want
    for cand in ((2 * bx, by), (bx, 2 * by)):
        if tile[0] % cand[0] == 0 and tile[1] % cand[1] == 0:
            assert tker._stream_smem(p, spec, *cand) > tker._STREAM_SMEM


@pytest.mark.parametrize("name,T,order", [("acoustic", 4, 16),
                                          ("tti", 4, 8), ("tti", 2, 12)])
def test_stream_plan_refuses_what_fits_no_subtile(name, T, order):
    p = tphys.PHYSICS[name]
    with pytest.raises(ValueError, match="1x1 sub-tile"):
        tker.stream_plan(_spec(p, (64, 64, 16), (8, 8), T, order), p)


def test_tti_stream_smem_counts_its_rings():
    """TTI's block: rings of 2R + 2 planes (the 2R + 1 z taps and the
    plane in flight) of p and r over the block window, or of Dx~p and
    Dz~r over the window less R beside two planes of Dy~p, and at least
    the write-back's 16 warp tiles of 32 x 33 floats."""
    p = tphys.TTI
    # order 4 (R = 2), T = 1: H = 4; sub-tile 8 x 16 -> window 16 x 24
    spec = _spec(p, (64, 64, 16), (8, 16), 1, 4)
    assert tker._stream_smem(p, spec, 8, 16) == max(
        4 * 2 * 6 * 16 * 24, 4 * 14 * 12 * 20, 67584) == 67584
    # order 8 (R = 4), T = 1: H = 8; sub-tile 32 x 32 -> window 48 x 48
    spec = _spec(p, (64, 64, 16), (32, 32), 1, 8)
    assert tker._stream_smem(p, spec, 32, 32) == 4 * 2 * 10 * 48 * 48 \
        == 184320
    assert tker._stream_smem(p, spec, 32, 32) > 4 * 22 * 40 * 40


def _launch_sizes(p, spec, nx):
    """(scratch, shared) bytes of one shot of a launch by its schedule:
    the first schedule's tile windows (2 acoustic, 7 TTI, 9 elastic) and
    no copies; the z-major copies of the state and the params, and the
    block windows (none for acoustic; 7 TTI, over regions of its block
    window; 9 elastic) of the z-streamed one; B5's copies and whole spec
    windows (7 TTI, 9 elastic) a tile; B6's copies alone."""
    h, nz = spec.halo, spec.nz
    tx, ty = spec.tile
    plan = tker.launch_plan(spec, p)
    windows = {"acoustic": 2, "tti": 7, "elastic": 9}[p.name]
    if plan is None:
        return ((nx // tx) * (nx // ty) * windows * (tx + 2 * h)
                * (ty + 2 * h) * nz * 4, 0)
    vol = (nx + 2 * h) ** 2 * nz
    if isinstance(plan, tker.WavePlan):        # B6: the copies alone
        return (len(p.state_fields) * vol * 4,
                len(p.param_fields) * vol * 4)
    if isinstance(plan, tker.ClusterPlan):
        return ((len(p.state_fields) * vol + (nx // tx) * (nx // ty)
                 * windows * (tx + 2 * h) * (ty + 2 * h) * nz) * 4,
                len(p.param_fields) * vol * 4)
    bx, by, _ = plan
    r = spec.radius
    windows = {"acoustic": 0,
               # p, r twice over margin 2r; the three inner derivatives
               # over margin r
               "tti": (4 * (bx + 2 * h - 4 * r) * (by + 2 * h - 4 * r)
                       + 3 * (bx + 2 * h - 2 * r) * (by + 2 * h - 2 * r)),
               "elastic": 9 * (bx + 2 * h) * (by + 2 * h)}[p.name]
    return ((len(p.state_fields) * vol
             + (nx // bx) * (nx // by) * windows * nz) * 4,
            len(p.param_fields) * vol * 4)


@pytest.mark.parametrize("name", ["acoustic", "tti", "elastic"])
def test_launch_bytes_follow_the_kernels(name):
    """One shot's device bytes: outputs and partials, and the scratch of
    the schedule the launch takes — at T = 2, order 4 the acoustic launch
    streams (only the z-major copies of its two padded state fields, no
    window scratch), TTI (halo 8) streams too (the copies of its four
    state fields and 7 block windows), the elastic one (halo 8) takes the
    first schedule (9 tile windows); the params' copies are
    `launch_shared_bytes` (none for the first schedule)."""
    p = tphys.PHYSICS[name]
    spec = _spec(p, (64, 64, 16), (16, 16), 2, 4)
    assert (tker.launch_plan(spec, p) is None) == (name == "elastic")
    base = len(p.state_fields) * 64 * 64 * 16 * 4 \
        + 16 * 2 * 1 * p.rec_channels * 4
    scratch, shared = _launch_sizes(p, spec, 64)
    assert tker.launch_bytes(spec, p) == base + scratch
    assert tker.launch_shared_bytes(spec, p) == shared


# (physics, space order, T) -> the schedule a launch at 512^3, tile 32
# takes: the z-streamed sub-tile, ("B5", cluster size), ("B6", cluster
# size, planes a step), or None for the first schedule — where each was
# measured the faster, or is the only one that runs (PERF.md)
CHOICES = [
    ("acoustic", 4, 1, None),                 # halo 2: first faster
    ("acoustic", 4, 2, (32, 32)),
    ("acoustic", 4, 4, (32, 32)),
    ("acoustic", 8, 1, (32, 32)),
    ("acoustic", 8, 2, (32, 32)),             # halo 8: z-streamed faster
    # from halo 12 the cluster-shared z-wavefront, the fewest blocks a
    # cluster whose parts fit, at the most planes a step that fit, where
    # that is at most 4 blocks
    ("acoustic", 8, 4, ("B6", 4, 2)),         # z-streamed 16x16 slower
    ("acoustic", 12, 2, ("B6", 2, 1)),        # z-streamed 32x16 slower
    ("acoustic", 12, 4, None),                # no sub-tile fits; B6's 16
                                              # blocks a cluster slower
    ("acoustic", 4, 16, None),                # no sub-tile fits
    ("elastic", 4, 1, None),                  # halo 4 and 8: first faster
    ("elastic", 4, 2, None),
    ("elastic", 8, 1, None),
    ("elastic", 12, 1, (32, 32)),
    ("elastic", 4, 4, (32, 32)),
    # order 8 and up from halo 16: the cluster-shared trapezoid, one
    # block a tile (256 tiles fill the card)
    ("elastic", 8, 2, ("B5", 1)),             # z-streamed 32x32 slower
    ("elastic", 12, 2, ("B5", 1)),
    ("elastic", 8, 4, ("B5", 1)),
    ("elastic", 12, 4, ("B5", 1)),
    ("tti", 4, 1, (32, 32)),                  # streamed even at depth 1
    ("tti", 4, 2, (32, 32)),
    ("tti", 4, 4, (32, 32)),
    ("tti", 8, 1, (32, 32)),
    ("tti", 8, 2, ("B5", 1)),                 # z-streamed 16x16 slower
    ("tti", 8, 4, ("B5", 1)),
    ("tti", 12, 1, (16, 16)),                 # overhang 6.25
    ("tti", 12, 2, ("B5", 1)),
    ("tti", 12, 4, ("B5", 1)),
]


@pytest.mark.parametrize("name,order,T,want", CHOICES)
def test_launch_plan_takes_the_measured_schedule(name, order, T, want):
    p = tphys.PHYSICS[name]
    spec = _spec(p, (512, 512, 512), (32, 32), T, order)
    plan = tker.launch_plan(spec, p)
    assert _choice(plan) == want
    scratch, shared = _launch_sizes(p, spec, 512)
    assert tker.launch_shared_bytes(spec, p) == shared
    assert tker.launch_bytes(spec, p) - scratch == (
        len(p.state_fields) * 512 ** 3 + 256 * T * p.rec_channels) * 4


def test_tti_design_bytes_count_the_phase_areas():
    """`design_bytes` of the main TTI plan (512^3, tile 32, T = 4, order
    4: R = 2, halo 16, 256 blocks of a 64^2 window), counted by hand: the
    z-major copies (4 state + 6 param fields, padded to 544^2, read in
    float32 and written in float32), then per block and plane the 8
    passes, phase n over the region of margin 2n (64^2, 60^2, ..., 32^2):
    phase A taps p and r over the previous region and reads theta and phi
    and writes Dx~p, Dy~p, Dz~r over its own; phase B taps the three over
    the previous region and reads 6 params and 4 state fields and writes
    p and r over its own; and the write-back reads and writes the 4
    fields' 32^2 centre."""
    p = tphys.TTI
    spec = _spec(p, (512, 512, 512), (32, 32), 4, 4)
    assert tker.launch_plan(spec, p)[:2] == (32, 32)
    copies = 10 * 544 * 544 * 512 * (4 + 4)
    phase_a = (2 * 4096 + 5 * 3600) + (2 * 3136 + 5 * 2704) \
        + (2 * 2304 + 5 * 1936) + (2 * 1600 + 5 * 1296)
    phase_b = (3 * 3600 + 12 * 3136) + (3 * 2704 + 12 * 2304) \
        + (3 * 1936 + 12 * 1600) + (3 * 1296 + 12 * 1024)
    assert (phase_a, phase_b) == (69952, 125376)
    per_block = 4 * 512 * (phase_a + phase_b + 2 * 4 * 32 * 32)
    assert tker.design_bytes(spec, p) == copies + 256 * per_block
    assert round(tker.design_bytes(spec, p) / 1e9, 1) == 118.8
