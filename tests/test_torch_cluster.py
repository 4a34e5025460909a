"""The cluster-shared trapezoid (B5) of the TTI and elastic TB kernels and
the cluster-shared z-wavefront (B6) of the acoustic one: their host side,
which the CPU can check (`stencil_tb.pass_chunks`, `cluster_plan`,
`chunk_table`, `wave_plan`, `wave_rect`, `wave_smem`, `redundancy`,
`launch_plan`'s choice and the bytes a launch and a propagation hold).
The kernels themselves run only on the card (`tests/test_torch_cuda.py`,
marked `cuda`)."""
import re
from pathlib import Path

import numpy as np
import pytest

from repro_torch.core.temporal_blocking import TBPlan
from repro_torch.kernels import ops, stencil_tb as ker, tb_physics as phys

CSRC = Path(ker.__file__).resolve().parent / "csrc"


def _spec(physics, shape, tile, T, order):
    return ops.make_spec(shape, TBPlan(tile, T, physics.step_radius(order)),
                         order, 1e-3, (10.0,) * 3, 1, 1, physics=physics)


# (physics, shape, tile, T, order, cluster): the paper's 512^3 cases at the
# tiles B5 runs (128 x 128, 128 x 64 and 32 x 32, the default cluster and
# the non-portable 16) and small grids of the card tests, where a part is
# a few points
PLANS = [(name, (512, 512, 64), tile, T, order, c)
         for name in ("tti", "elastic")
         for order, T in ((8, 4), (12, 4), (12, 2), (8, 2))
         for tile, c in (((128, 128), None), ((128, 64), None),
                         ((32, 32), None), ((128, 128), 16))] + [
    (name, shape, tile, T, order, None)
    for name in ("tti", "elastic")
    for shape, tile, T, order in (((64, 64, 24), (32, 32), 4, 8),
                                  ((64, 64, 24), (32, 32), 4, 12),
                                  ((160, 160, 64), (80, 80), 4, 8),
                                  ((160, 160, 64), (80, 80), 4, 12),
                                  ((16, 24, 33), (8, 8), 4, 4),
                                  ((16, 16, 13), (8, 8), 1, 16))]


def _region(spec, n):
    """(x0, y0, h, w) of pass n's region: the window less n R a side."""
    wx, wy, _ = spec.window
    m = n * spec.radius
    return m, m, wx - 2 * m, wy - 2 * m


@pytest.mark.parametrize("name,shape,tile,T,order,cluster", PLANS)
def test_pass_chunks_cover_each_region_once_and_fit(name, shape, tile, T,
                                                    order, cluster):
    """Every pass's chunks cover its region exactly once; each chunk's seam
    (R points around it) lies in the previous pass's region and its load
    rectangle in the window; each fits a block's shared memory; every
    block has a part of every pass, the largest within 25% of the mean."""
    p = phys.PHYSICS[name]
    spec = _spec(p, shape, tile, T, order)
    plan = ker.cluster_plan(spec, p, cluster)
    R = spec.radius
    wx, wy, _ = spec.window
    assert len(plan.chunks) == 2 * T
    assert plan.smem <= ker._STREAM_SMEM
    for n, per_block in enumerate(plan.chunks, 1):
        assert len(per_block) == plan.cluster
        rx, ry, rh, rw = _region(spec, n)
        px, py, ph, pw = _region(spec, n - 1)
        seen = set()
        for chunks in per_block:
            for x0, y0, h, w in chunks:
                pts = {(x, y) for x in range(x0, x0 + h)
                       for y in range(y0, y0 + w)}
                assert not pts & seen
                seen |= pts
                assert px <= x0 - R and x0 + h + R <= px + ph
                assert py <= y0 - R and y0 + w + R <= py + pw
                lx, ly, lh, lw = ker.chunk_load(R, x0, y0, h, w)
                assert ly % 4 == 0 and lw % 4 == 0
                assert 0 <= ly <= y0 - R and y0 + w + R <= ly + lw <= wy
                assert (lx, lh) == (x0 - R, h + 2 * R)
                assert ker.chunk_smem(p, R, n, lh, lw) <= plan.smem
        assert seen == {(x, y) for x in range(rx, rx + rh)
                        for y in range(ry, ry + rw)}
        areas = [sum(h * w for _, _, h, w in b) for b in per_block]
        assert min(areas) > 0
        assert max(areas) <= 1.25 * (sum(areas) / len(areas))


def test_chunk_smem_is_the_kernels_formula():
    """`chunk_smem` by hand, and the .cu files' own formulas: TTI's phase A
    (odd passes) holds rings of 2R + 2 planes of p and r, phase B rings of
    Dx~p and Dz~r and two planes of Dy~p; elastic's phase V rings of txz,
    tyz, tzz and two planes each of txx, tyy, txy, phase S rings of the
    three velocities; at least 16 warp tiles of 32 x 33 floats."""
    tti, el = phys.TTI, phys.ELASTIC
    assert ker.chunk_smem(tti, 4, 1, 50, 52) == 4 * 2 * 10 * 50 * 52
    assert ker.chunk_smem(tti, 4, 2, 50, 52) == 4 * 22 * 50 * 52
    assert ker.chunk_smem(tti, 6, 4, 36, 48) == 4 * 30 * 36 * 48
    assert ker.chunk_smem(el, 4, 1, 38, 36) == 4 * (3 * 10 + 6) * 38 * 36
    assert ker.chunk_smem(el, 6, 2, 30, 32) == 4 * 3 * 14 * 30 * 32
    assert ker.chunk_smem(el, 1, 2, 10, 12) == 67584 == 4 * 16 * 32 * 33
    for src in ("stencil_tb_tti.cu", "stencil_tb_elastic.cu"):
        assert "4LL * planes * lh * lw" in (CSRC / src).read_text()
    assert "n % 2 ? 2 * ring : 2 * ring + 2" in \
        (CSRC / "stencil_tb_tti.cu").read_text()
    assert "n % 2 ? 3 * ring + 6 : 3 * ring" in \
        (CSRC / "stencil_tb_elastic.cu").read_text()
    header = (CSRC / "tb_cluster.cuh").read_text()
    assert re.search(r"\*ly = \(y0 - R\) >> 2 << 2;", header)
    assert re.search(r"\*lw = \(\(y0 \+ w \+ R \+ 3\) >> 2 << 2\) - \*ly;",
                     header)


@pytest.mark.parametrize("tile,T,order,want", [
    # the tile's trapezoid computed once: the Motivation's factors
    ((128, 128), 4, 8, 1.51), ((128, 128), 4, 12, 1.81),
    ((128, 128), 2, 12, 1.31),
    ((128, 64), 4, 8, 1.79), ((128, 64), 4, 12, 2.29),
    ((128, 64), 2, 12, 1.48),
    ((32, 32), 4, 8, 3.84), ((32, 32), 4, 12, 6.09),
])
def test_redundancy_factors(tile, T, order, want):
    """Points B5 computes a pass over the tile's points, and the first
    schedule's (the whole window every pass: 9x at tile 32, halo 32; 16x
    at halo 48)."""
    for p in (phys.TTI, phys.ELASTIC):
        spec = _spec(p, (512, 512, 64), tile, T, order)
        assert round(ker.redundancy(spec, p, ker.cluster_plan(spec, p)),
                     2) == want
        wx, wy, _ = spec.window
        assert ker.redundancy(spec, p, None) == wx * wy / (tile[0] * tile[1])
    spec = _spec(phys.TTI, (512, 512, 64), (32, 32), 4, 8)
    assert ker.redundancy(spec, phys.TTI, None) == 9.0
    spec = _spec(phys.TTI, (512, 512, 64), (32, 32), 4, 12)
    assert ker.redundancy(spec, phys.TTI, None) == 16.0


def _choice(plan):
    """A `launch_plan` result as the tests name it: None (first
    schedule), the z-streamed sub-tile (bx, by), ("B5", cluster) or ("B6",
    cluster, planes a step)."""
    if isinstance(plan, ker.ClusterPlan):
        return ("B5", plan.cluster)
    if isinstance(plan, ker.WavePlan):
        return ("B6", plan.cluster, plan.planes)
    return None if plan is None else plan[:2]


# acoustic (order, T, tile) -> the B6 launch `launch_plan` takes at 512^3
# (from order 8 at halo 12, where the fewest blocks a cluster whose parts
# fit, at the most planes a step that fit, are at most 4); elsewhere the
# schedules it had (at tiles 64 and up B6 would take 8 or 16 blocks, or
# no parts fit a block)
ACOUSTIC_B6 = {(8, 4, (32, 32)): ("B6", 4, 2),
               (12, 2, (32, 32)): ("B6", 2, 1)}


@pytest.mark.parametrize("name", ["acoustic", "tti", "elastic"])
@pytest.mark.parametrize("order", [4, 8, 12])
@pytest.mark.parametrize("T", [1, 2, 4])
@pytest.mark.parametrize("tile,cluster", [((128, 128), 16),
                                          ((128, 64), 16), ((64, 64), 2),
                                          ((32, 32), 1)])
def test_launch_plan_takes_b5_at_orders_8_and_12(name, order, T, tile,
                                                 cluster):
    """At 512^3 B5 runs TTI and elastic from order 8 at halo 16 (T = 2 and
    4), with the cluster `cluster_size` gives (16 blocks a tile at 16 and
    32 tiles, 2 at 64, 1 at 256); B6 runs acoustic from order 8 at halo 12
    where its parts fit clusters of at most 4 blocks (`ACOUSTIC_B6`);
    order 4, depth 1 and the other acoustic
    launches keep the schedules they had (`stencil_tb.launch_plan` without
    B5 or B6)."""
    p = phys.PHYSICS[name]
    spec = _spec(p, (512, 512, 512), tile, T, order)
    plan = ker.launch_plan(spec, p)
    if name != "acoustic" and order >= 8 and T >= 2:
        assert _choice(plan) == ("B5", cluster)
        return
    if name == "acoustic" and (order, T, tile) in ACOUSTIC_B6:
        assert _choice(plan) == ACOUSTIC_B6[order, T, tile]
        return
    assert not isinstance(plan, (ker.ClusterPlan, ker.WavePlan))
    if spec.halo < ker._KERNELS[name].stream_from_halo:
        assert plan is None
        return
    try:
        bx, by, smem = ker.stream_plan(spec, p)
    except ValueError:
        assert plan is None
        return
    h = spec.halo
    fits = (bx + 2 * h) * (by + 2 * h) <= ker._MAX_OVERHANG * bx * by
    assert plan == ((bx, by, smem) if fits else None)


def test_cluster_size_fills_the_card_in_the_fewest_waves():
    """Blocks a cluster: the size whose launch of one row ends soonest by
    the H100's clusters at once (132, 66, 30, 15, 7 of 1, 2, 4, 8, 16
    blocks): at 64 tiles 2 (one wave of 128 blocks; 4 would take 3 waves
    of 30), at 16 or 32 tiles 16, at 256 tiles 1 (2 a cluster ties: two
    waves either way); never more than a tile's parts can take."""
    p = phys.TTI
    for tile, want in (((128, 128), 16), ((128, 64), 16), ((64, 64), 2),
                       ((32, 32), 1), ((256, 128), 8)):
        assert ker.cluster_size(_spec(p, (512, 512, 64), tile, 4, 8)) == want
    assert ker.cluster_size(_spec(p, (160, 160, 64), (80, 80), 4, 8)) == 16
    # a 2 x 4 tile takes at most 8 one-point parts, a 1 x 4 tile 4
    assert ker.cluster_size(_spec(p, (8, 8, 8), (2, 4), 1, 4)) == 8
    assert ker.cluster_size(_spec(p, (8, 8, 8), (1, 4), 1, 4)) == 4
    with pytest.raises(ValueError, match="multiple of 4"):
        ker.cluster_plan(_spec(p, (8, 8, 8), (4, 2), 1, 4), p)
    with pytest.raises(ValueError, match="no cluster-shared"):
        ker.cluster_plan(_spec(phys.ACOUSTIC, (64, 64, 8), (32, 32), 4, 12),
                         phys.ACOUSTIC)


def test_chunk_table_layout():
    """The kernel's table: 2T * cluster + 1 starts (block b's chunks of
    pass n between start[(n - 1) C + b] and the next), then the chunks'
    (x0, y0, h, w) in that order."""
    p = phys.ELASTIC
    spec = _spec(p, (64, 64, 24), (32, 32), 4, 8)
    plan = ker.cluster_plan(spec, p)
    host, dev = ker.chunk_table(plan, "cpu")
    C, npass = plan.cluster, 2 * spec.T
    starts = host[:npass * C + 1].tolist()
    chunks = host[npass * C + 1:].reshape(-1, 4).tolist()
    assert starts[0] == 0 and len(chunks) == starts[-1]
    for n in range(npass):
        for b in range(C):
            i, j = starts[n * C + b], starts[n * C + b + 1]
            assert [tuple(c) for c in chunks[i:j]] == list(plan.chunks[n][b])
    assert dev.tolist() == host.tolist()
    assert ker.chunk_table(plan, "cpu")[0] is host       # made once


def test_scratch_and_propagation_bytes_count_b5():
    """A B5 launch's scratch is the z-major copies of its state and 7 (TTI)
    or 9 (elastic) whole spec windows a tile, float32, and the params'
    copies are its shared bytes; `ops.propagation_bytes` counts them:
    TTI order 8 at 512^3, tile 128, T = 4 (halo 32), nt 261 (a depth-1
    remainder, z-streamed: halo 8), by hand."""
    p = phys.TTI
    n, field = 512, 512 ** 3 * 4
    plan = TBPlan((128, 128), 4, 8)
    spec = ops.make_spec((n,) * 3, plan, 8, 1.0, (1.0,) * 3, 1, 1, physics=p)
    rspec = ops.make_spec((n,) * 3, TBPlan((128, 128), 1, 8), 8, 1.0,
                          (1.0,) * 3, 1, 1, physics=p)
    assert isinstance(ker.launch_plan(spec, p), ker.ClusterPlan)
    assert ker.schedule_name(ker.launch_plan(rspec, p)) == "z-streamed"

    def padded(h):
        return (n + 2 * h) ** 2 * n * 4

    windows = 16 * 7 * 192 * 192 * n * 4
    scratch = ker.scratch_bytes(spec, p, 1)
    assert scratch == 4 * padded(32) + windows
    assert ker.launch_shared_bytes(spec, p) == 6 * padded(32)
    assert ker.launch_bytes(spec, p) == 4 * field + 16 * 4 * 1 * 4 + scratch
    assert scratch >= ker.scratch_bytes(rspec, p, 1)
    want = (10 * field + 6 * padded(32) + 6 * padded(8) + scratch
            + 6 * padded(32) + 4 * padded(32) + 4 * field + 16 * 4 * 4)
    assert ops.propagation_bytes(p, (n,) * 3, 261, plan, 8) == want
    # the elastic order-12 case at T = 4 now fits a card (94.77 GiB on the
    # first schedule at tile 32)
    assert ops.propagation_bytes(phys.ELASTIC, (n,) * 3, 459,
                                 TBPlan((128, 128), 4, 12), 12) < 50 * 2 ** 30


def test_design_bytes_count_the_chunks_loads():
    """`design_bytes` of a B5 launch: the z-major copies, then per spec
    tile and pass the tap fields over each chunk's load rectangle (elastic
    phase V: the six stresses; S: the three velocities) and the pointwise
    reads and writes over the region (V: 3 velocities, 2 params, 3 writes;
    S: 6 stresses, 3 params, 6 writes), and the write-back of the state's
    centre."""
    p = phys.ELASTIC
    spec = _spec(p, (64, 64, 24), (32, 32), 4, 8)
    plan = ker.launch_plan(spec, p)
    R, nz = spec.radius, 24
    vol = 128 * 128 * nz
    copies = 13 * vol * 8
    per_tile = 0
    for n in range(1, 9):
        taps, points = ((6, 8), (3, 15))[1 - n % 2]
        seam = sum(lh * lw for b in plan.chunks[n - 1] for ch in b
                   for _, _, lh, lw in [ker.chunk_load(R, *ch)])
        per_tile += taps * seam + points * (96 - 8 * n) ** 2
    per_tile = 4 * nz * (per_tile + 2 * 9 * 32 * 32)
    assert ker.design_bytes(spec, p) == copies + 4 * per_tile


@pytest.mark.parametrize("physics", ["acoustic", "tti", "elastic"])
@pytest.mark.parametrize("order", [8, 12])
def test_reduced_paper_case_tb_at_depth_4_matches_reference(physics, order):
    """The deep halos B5 and B6 run on the card (T = 4: halo 32 and 48 for
    TTI and elastic, 16 and 24 for acoustic), through the port's CPU path
    (`*_tb_propagate` on 2 x 2 tiles, a full tile and a remainder), against
    the reference's Listing-1 propagation (`repro.kernels.ref`) on the same
    reduced paper case, at the reduced cases' tolerance
    (`tests/test_torch_paper.py`)."""
    import jax.numpy as jnp

    from repro.core import sources as JS
    from repro.core.grid import Grid as JGrid
    from repro.kernels import ref as jref
    from repro_torch.configs import paper_stencil as tps
    from repro_torch.core import sources as TS
    from repro_torch.core.grid import Grid as TGrid
    from test_torch_case import FIELD_RTOL, assert_fields_close, \
        trace_channels
    from test_torch_paper import JAX_TYPES, PORT_TB, _paper_inputs

    case = tps.reduced_case(physics, order, n=16,
                            time_ms=8.0 if physics == "tti" else 5.5)
    state, params, dt, src, wav, rec = _paper_inputs(case)
    nt = case.nt(dt)
    assert nt > 4 and nt % 4                   # a full tile and a remainder
    p = phys.PHYSICS[physics]
    plan = TBPlan((8, 8), 4, p.step_radius(order))
    assert plan.halo == 4 * p.step_radius(order)
    tgrid = TGrid(case.shape, case.spacing)
    g = TS.precompute(TS.SparseOperator(src), tgrid, wav, device="cpu")
    gr = TS.precompute_receivers(TS.SparseOperator(rec), tgrid,
                                 device="cpu")
    tstate, trec = PORT_TB[physics](nt, state, params, g, gr, plan, order,
                                    dt, case.spacing, device="cpu")
    jgrid = JGrid(case.shape, case.spacing)
    st_t, par_t = JAX_TYPES[physics]
    jst = st_t(*(jnp.asarray(a) for a in state))
    jpar = par_t(*(jnp.asarray(a) for a in params))
    # the acoustic oracle takes its fields one by one
    fields = (*jst, *jpar) if physics == "acoustic" else (jst, jpar)
    jstate, jrec = getattr(jref, f"{physics}_reference")(
        nt, *fields, dt, case.spacing, order,
        g=JS.precompute(JS.SparseOperator(src), jgrid, wav),
        receivers=JS.precompute_receivers(JS.SparseOperator(rec), jgrid))
    names = p.state_fields
    for n, a, b in zip(names, tstate, jstate):
        np.testing.assert_allclose(a.numpy(), np.asarray(b), rtol=2e-4,
                                   atol=1e-5, err_msg=n)
    assert_fields_close(zip(names, (a.numpy() for a in tstate), jstate),
                        FIELD_RTOL, f"{case.name}")
    np.testing.assert_allclose(trec.numpy(), np.asarray(jrec), rtol=2e-4,
                               atol=1e-5)
    assert_fields_close(trace_channels(trec.numpy(), jrec), FIELD_RTOL,
                        f"{case.name} traces")
    assert float(np.abs(np.asarray(jrec)).max()) > 0


# ---------------------------------------------------------------------------
# B6: the acoustic kernel's cluster-shared z-wavefront
# ---------------------------------------------------------------------------

AC = phys.ACOUSTIC

# (shape, tile, T, order, cluster): the paper's 512^3 acoustic cases at the
# tiles the sweep times, with every cluster size (those whose parts do not
# fit a block are checked to be refused), and the card tests' grids
WAVE_PLANS = [((512, 512, 64), tile, T, order, c)
              for order in (8, 12) for T in (2, 3, 4)
              for tile in ((32, 32), (64, 64), (128, 64))
              for c in (1, 2, 4, 8, 16)] + [
    ((64, 64, 24), (32, 32), 4, 8, None), ((64, 64, 24), (32, 32), 4, 12,
                                          None),
    ((64, 64, 24), (32, 32), 2, 8, 8), ((160, 160, 64), (32, 32), 4, 12,
                                        None)]


def _owner(plan, wx, wy):
    """The block owning each window point by the cut lines alone."""
    owner = np.full((wx, wy), -1)
    px, py = plan.parts
    for a in range(px):
        for b in range(py):
            owner[plan.xcuts[a]:plan.xcuts[a + 1],
                  plan.ycuts[b]:plan.ycuts[b + 1]] = a * py + b
    return owner


@pytest.mark.parametrize("shape,tile,T,order,cluster", WAVE_PLANS)
def test_wave_parts_cover_each_level_once(shape, tile, T, order, cluster):
    """B6's parts: at every level j the blocks' own rectangles cover the
    region of margin j r exactly once, each block's lies in its part by
    the cut lines (one partition for every level), every block has points
    of every level, and the largest block's shared bytes fit.  A cluster
    whose parts cannot fit is refused: each of its grids has a part
    narrower than r, a cut outside the tile, or a block beyond shared
    memory."""
    spec = _spec(AC, shape, tile, T, order)
    wx, wy, _ = spec.window
    R = spec.radius
    try:
        plan = ker.wave_plan(spec, AC, cluster)
    except ValueError:
        for px in (d for d in range(1, cluster + 1) if cluster % d == 0):
            try:
                xc = ker.wave_cuts(wx, spec.halo, R, T, px)
                yc = ker.wave_cuts(wy, spec.halo, R, T, cluster // px)
            except ValueError:
                continue
            assert ker.wave_smem(T, R, wx, wy, xc, yc) > ker._STREAM_SMEM
        return
    # two planes a step where they fit, else one
    assert plan.planes == 2 or ker.wave_smem(
        T, R, wx, wy, plan.xcuts, plan.ycuts, 2) > ker._STREAM_SMEM
    px, py = plan.parts
    assert px * py == plan.cluster
    assert cluster in (None, plan.cluster)
    owner = _owner(plan, wx, wy)
    for j in range(T + 1):
        count = np.zeros((wx, wy), int)
        for a in range(px):
            for b in range(py):
                x0, y0, h, w = ker.wave_rect(plan.xcuts, plan.ycuts, a, b, j,
                                             R, wx, wy)
                assert h > 0 and w > 0
                count[x0:x0 + h, y0:y0 + w] += 1
                assert (owner[x0:x0 + h, y0:y0 + w] == a * py + b).all()
        m = j * R
        region = np.zeros((wx, wy), bool)
        region[m:wx - m, m:wy - m] = True
        assert (count[region] == 1).all() and (count[~region] == 0).all()
    assert plan.smem == ker.wave_smem(T, R, wx, wy, plan.xcuts, plan.ycuts,
                                      plan.planes)
    assert plan.smem <= ker._STREAM_SMEM


@pytest.mark.parametrize("shape,tile,T,order,cluster",
                         [c for c in WAVE_PLANS if c[3] == 8 or c[2] == 2])
def test_wave_seams_lie_in_the_neighbours_parts(shape, tile, T, order,
                                                cluster):
    """Each block's ring of level j (< T) holds exactly what level j + 1's
    points tap, its own points of level j + 1 widened by r (x and y taps;
    the z taps and u_prev, level j + 2's, are its own points); what it
    does not own there, its seam, lies in the parts of the eight blocks
    around it, each of which owns those points at level j."""
    spec = _spec(AC, shape, tile, T, order)
    try:
        plan = ker.wave_plan(spec, AC, cluster)
    except ValueError:
        return
    wx, wy, _ = spec.window
    R = spec.radius
    px, py = plan.parts
    owner = _owner(plan, wx, wy)
    xc, yc = plan.xcuts, plan.ycuts
    for j in range(T):
        for a in range(px):
            for b in range(py):
                lx, ly, lh, lw = ker.wave_rect(xc, yc, a, b, j, R, wx, wy,
                                               ring=True)
                ox, oy, oh, ow = ker.wave_rect(xc, yc, a, b, j + 1, R, wx,
                                               wy)
                assert (lx, ly, lh, lw) == (ox - R, oy - R, oh + 2 * R,
                                            ow + 2 * R)
                mx, my, mh, mw = ker.wave_rect(xc, yc, a, b, j, R, wx, wy)
                assert lx <= mx and mx + mh <= lx + lh
                assert ly <= my and my + mw <= ly + lw
                seam = owner[lx:lx + lh, ly:ly + lw]
                mine = seam == a * py + b
                for n in np.unique(seam[~mine]):
                    na, nb = divmod(int(n), py)
                    assert max(abs(na - a), abs(nb - b)) == 1
                # every seam point is a point of level j (owned there)
                m = j * R
                assert m <= lx and lx + lh <= wx - m
                assert m <= ly and ly + lw <= wy - m


def test_wave_smem_is_the_kernels_formula():
    """`wave_smem` by hand and the .cu file's own formula: tile 32, T = 2,
    order 8 (r = 4, halo 8, window 48) on 2 x 1 parts cut at 24: a block's
    level-0 ring 28 x 48 points of 2r + 3 = 11 planes at one plane a step
    (level 2 reads it as u_prev), 2r + 6 = 14 at two, its level-1 ring
    24 x 40 of 2r + 2 = 10 or 2r + 4 = 12 planes, and the staging of its
    16 x 32 centre, 8 planes of u_T and of u_{T-1} at a pitch of 516
    floats."""
    spec = _spec(AC, (512, 512, 64), (32, 32), 2, 8)
    plan = ker.wave_plan(spec, AC, 2, 1)
    assert (plan.parts, plan.xcuts, plan.ycuts) == ((2, 1), (0, 24, 48),
                                                    (0, 48))
    assert ker.wave_rect(plan.xcuts, plan.ycuts, 0, 0, 0, 4, 48, 48,
                         ring=True) == (0, 0, 28, 48)
    assert ker.wave_rect(plan.xcuts, plan.ycuts, 1, 0, 1, 4, 48, 48,
                         ring=True) == (20, 4, 24, 40)
    assert ker.wave_rect(plan.xcuts, plan.ycuts, 0, 0, 2, 4, 48, 48) == \
        (8, 8, 16, 32)
    assert (ker.wave_slots(4, 0, 2), ker.wave_slots(4, 1, 2)) == (11, 10)
    assert (ker.wave_slots(4, 0, 2, 2), ker.wave_slots(4, 1, 2, 2)) == \
        (14, 12)
    want = 4 * (11 * 28 * 48 + 10 * 24 * 40 + 2 * 8 * 516)
    assert plan.smem == ker.wave_smem(2, 4, 48, 48, (0, 24, 48),
                                      (0, 48)) == want == 130560
    two = ker.wave_plan(spec, AC, 2, 2)
    assert (two.parts, two.xcuts, two.planes) == ((2, 1), (0, 24, 48), 2)
    assert two.smem == 4 * (14 * 28 * 48 + 12 * 24 * 40 + 2 * 8 * 516) \
        == 154368
    # two planes a step need an even radius of at least 4
    with pytest.raises(ValueError, match="planes a step"):
        ker.wave_plan(_spec(AC, (512, 512, 64), (32, 32), 2, 10), AC, 4, 2)
    src = (CSRC / "stencil_tb.cu").read_text()
    for line in ("return j + 2 <= T ? 2 * r + 3 * K : 2 * r + 2 * K;",
                 "const int s = ring ? r : 0, m = j * r;",
                 "const int x0 = imax(w.xc[a] - s, m), "
                 "x1 = imin(w.xc[a + 1] + s, wx - m);",
                 "f += (long long)wave_slots(r, j, T, w.planes) * q.h * q.w;",
                 "|| (w.planes == 2 && (r % 2 || r < 4)) || r < WAVE_MIN_R",
                 "return f + 2LL * OUT_CHUNK * stage_pitch(c.h, c.w);",
                 "return (bx * by + 31) / 32 * 32 + 4;",
                 "#define OUT_CHUNK 8"):
        assert line in src, line
    assert ker._OUT_CHUNK == 8


@pytest.mark.parametrize("tile,T,order,want", [
    # each level once a tile: the factors B6 brings, against today's
    ((64, 64), 4, 8, 1.43), ((64, 64), 4, 12, 1.69),
    ((64, 64), 2, 12, 1.21), ((128, 128), 4, 12, 1.31),
    ((128, 128), 4, 8, 1.20), ((32, 32), 4, 8, 1.97),
    ((32, 32), 4, 12, 2.62),
])
def test_wave_redundancy_factors(tile, T, order, want):
    """Points B6 computes a step over the tile's points (its levels once a
    spec tile), where its parts fit a block and where they do not (the
    factor of the shape alone), beside the schedules it replaces at tile
    32, T = 4: z-streamed 16 x 16 at order 8 (3.375), the first schedule
    at order 12 (the whole 80^2 window, 6.25)."""
    spec = _spec(AC, (512, 512, 64), tile, T, order)
    try:
        plan = ker.wave_plan(spec, AC)
    except ValueError:
        plan = ker.WavePlan(16, (4, 4), (), (), 0)      # the type alone
    assert round(ker.redundancy(spec, AC, plan), 2) == want
    s8 = _spec(AC, (512, 512, 64), (32, 32), 4, 8)
    assert ker.redundancy(s8, AC, ker.stream_plan(s8, AC)) == 3.375
    s12 = _spec(AC, (512, 512, 64), (32, 32), 4, 12)
    assert ker.redundancy(s12, AC, None) == 6.25


def test_scratch_and_propagation_bytes_count_no_level_windows():
    """A B6 launch's scratch is the z-major copies of its two state fields
    alone (every level stays in shared memory), its shared bytes the
    params' two copies; `ops.propagation_bytes` counts them: order 12 at
    512^3, tile 32, T = 2 (halo 12), nt 459 (a depth-1 remainder,
    z-streamed at halo 6, whose copies are smaller), by hand."""
    n, field = 512, 512 ** 3 * 4
    plan = TBPlan((32, 32), 2, 6)
    spec = ops.make_spec((n,) * 3, plan, 12, 1.0, (1.0,) * 3, 1, 1,
                         physics=AC)
    rspec = ops.make_spec((n,) * 3, TBPlan((32, 32), 1, 6), 12, 1.0,
                          (1.0,) * 3, 1, 1, physics=AC)
    assert isinstance(ker.launch_plan(spec, AC), ker.WavePlan)
    assert ker.schedule_name(ker.launch_plan(rspec, AC)) == "z-streamed"

    def padded(h):
        return (n + 2 * h) ** 2 * n * 4

    scratch = ker.scratch_bytes(spec, AC, 1)
    assert scratch == 2 * padded(12)
    assert ker.scratch_bytes(spec, AC, 3) == 3 * scratch
    assert ker.launch_shared_bytes(spec, AC) == 2 * padded(12)
    assert ker.launch_bytes(spec, AC) == 2 * field + 256 * 2 * 4 + scratch
    assert ker.scratch_bytes(rspec, AC, 1) == 2 * padded(6)
    want = (4 * field + scratch + 2 * padded(12) + 2 * padded(6)
            + 2 * padded(12) + 2 * padded(12) + 2 * field + 256 * 2 * 4)
    assert ops.propagation_bytes(AC, (n,) * 3, 459, plan, 12) == want


def test_wave_design_bytes_count_the_parts_loads():
    """`design_bytes` of a B6 launch: the z-major copies (four fields read
    and written as float32), then per spec tile u over every part's
    level-0 ring rectangle (the seams loaded twice), u_prev at level 1 and
    m and damp at every level over its region, and the write-back of
    u_{T-1} and u_T's centre: (64, 64, 24), tile 32, T = 4, order 8 on 2 x
    2 parts of its 64^2 window cut at 32 (rings of 36^2 at level 0)."""
    spec = _spec(AC, (64, 64, 24), (32, 32), 4, 8)
    plan = ker.launch_plan(spec, AC)
    assert isinstance(plan, ker.WavePlan)
    assert (plan.parts, plan.xcuts) == ((2, 2), (0, 32, 64))
    nz = 24
    copies = 4 * 96 * 96 * nz * 8
    lv = [(32 + 2 * (16 - 4 * j)) ** 2 for j in range(5)]
    assert lv[1:] == [56 ** 2, 48 ** 2, 40 ** 2, 32 ** 2]
    per_tile = 4 * nz * (4 * 36 * 36 + lv[1] + 2 * sum(lv[1:])) \
        + 2 * 4 * 32 * 32 * nz
    assert ker.design_bytes(spec, AC) == copies + 4 * per_tile
