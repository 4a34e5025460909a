"""The port's survey engine (`repro_torch.survey`) against the JAX
package's (`repro.survey`), on `tests/test_survey.py`'s small cases.

The same numpy model and shots go to both: the port's `SurveyEngine.run`
on the CPU (the kernels' plain versions) against the reference's
`SurveyEngine.run(executor="jnp")`, for acoustic, TTI and elastic in SI
units (`launch.stencil_survey.build_model`).  NT = 3 with T = 2, so the
remainder tile runs; one bucket pads nsrc 3 to 4 (a zero-amplitude
source) and one batch is partial (a null shot).  Tolerance: that file's
``5e-4 * max|ref| + 1e-6``, and each receiver channel and field within
`test_torch_case.FIELD_RTOL` of its own scale.
"""
import os
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest

from repro.core.temporal_blocking import TBPlan as JPlan
from repro.survey import PlanCache as JCache, RUN_STATS_KEYS as J_KEYS, \
    SurveyEngine as JEngine, bucket_shots as j_bucket_shots
from repro.survey.shots import Shot as JShot, pad_count as j_pad_count
from repro_torch.core.grid import Grid
from repro_torch.core.temporal_blocking import TBPlan
from repro_torch.kernels import tb_physics as phys
from repro_torch.launch.stencil_survey import build_model, build_survey, \
    sequential_traces
from repro_torch.survey import PlanCache, RUN_STATS_KEYS, Shot, \
    SurveyEngine, bucket_shots
from repro_torch.survey.shots import pad_count
from test_survey import _shot as _jax_shot
from test_torch_case import FIELD_RTOL, assert_fields_close, trace_channels

ORDER = 4
NT = 3   # not a multiple of T=2: every run exercises the remainder tile
ROOT = Path(__file__).resolve().parents[1]


def _case(physics_name, n=12, nz=8, seed=0):
    """(grid, dt, port params on the CPU) as test_survey.py's `_case`
    draws them (elastic in SI units)."""
    shape = (n, n, nz)
    grid = Grid(shape=shape, spacing=(10.0,) * 3)
    dt = grid.cfl_dt(3000.0, ORDER)
    params = build_model(physics_name, shape, grid,
                         np.random.RandomState(seed), device="cpu")
    return grid, dt, params


def _shot(grid, dt, nsrc, nrec, seed):
    """test_survey.py's shot, as the port's `Shot`."""
    s = _jax_shot(grid, dt, nsrc, nrec, seed)
    return Shot(src_coords=s.src_coords, wavelet=s.wavelet,
                rec_coords=s.rec_coords, shot_id=s.shot_id)


def _jax(shot):
    return JShot(src_coords=shot.src_coords, wavelet=shot.wavelet,
                 rec_coords=shot.rec_coords, shot_id=shot.shot_id)


def _assert_traces_close(got, want, what):
    assert got.shape == want.shape, (what, got.shape, want.shape)
    scale = float(np.max(np.abs(want))) + 1e-30
    err = float(np.max(np.abs(got - want)))
    assert err <= 5e-4 * scale + 1e-6, (what, err, scale)
    assert_fields_close(trace_channels(got, want), FIELD_RTOL, what)


# ---------------------------------------------------------------------------
# Bucketing: equal to the reference's
# ---------------------------------------------------------------------------

def test_pad_count_and_buckets_equal_reference():
    assert [pad_count(n) for n in range(1, 20)] == \
        [j_pad_count(n) for n in range(1, 20)]
    with pytest.raises(ValueError):
        pad_count(0)
    grid, dt, _ = _case("acoustic")
    shots = [_shot(grid, dt, nsrc, nrec, seed=10 * nsrc + nrec)
             for nsrc in range(1, 6) for nrec in (3, 4, 5)]
    got = bucket_shots(shots)
    want = j_bucket_shots([_jax(s) for s in shots])
    assert list(got) == list(want)
    for key, b in got.items():
        jb = want[key]
        assert b.indices == jb.indices and len(b) == len(jb)
        for s, js in zip(b.shots, jb.shots):
            assert (s.nsrc, s.nrec, s.shot_id) == (js.nsrc, js.nrec,
                                                   js.shot_id)
            for a in ("src_coords", "wavelet", "rec_coords"):
                np.testing.assert_array_equal(getattr(s, a), getattr(js, a))


def test_build_survey_and_model_draw_the_reference_inputs():
    from repro.core.grid import Grid as JGrid
    from repro.launch import stencil_survey as jcli

    shape = (12, 12, 6)
    grid, jgrid = Grid(shape, (10.0,) * 3), JGrid(shape, (10.0,) * 3)
    dt = grid.cfl_dt(3000.0, ORDER)
    for name in ("acoustic", "tti", "elastic"):
        p = build_model(name, shape, grid, np.random.RandomState(3), "cpu")
        jp = jcli.build_model(name, shape, jgrid, np.random.RandomState(3))
        assert list(p) == list(jp)
        for f in p:
            want = np.asarray(jp[f])
            if name == "elastic" and f in ("lam", "mu"):
                want = want * 1e6          # the reference's 1e-6 units
                np.testing.assert_allclose(p[f].numpy(), want, rtol=1e-6)
            else:
                np.testing.assert_array_equal(p[f].numpy(), want)
    shots = build_survey(grid, dt, 5, 6, np.random.RandomState(1))
    jshots = jcli.build_survey(jgrid, dt, 5, 6, np.random.RandomState(1))
    for s, js in zip(shots, jshots):
        for a in ("src_coords", "wavelet", "rec_coords"):
            np.testing.assert_array_equal(getattr(s, a), getattr(js, a))


# ---------------------------------------------------------------------------
# The engine against the reference's
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("physics_name", ["acoustic", "tti", "elastic"])
def test_survey_matches_reference(physics_name):
    grid, dt, params = _case(physics_name, n=8)
    r = phys.PHYSICS[physics_name].step_radius(ORDER)
    # bucket (4, 4): nsrc 3 pads to 4 beside an exact nsrc-4 shot; bucket
    # (2, 4): one shot in a batch of 2, beside a null shot
    shots = [_shot(grid, dt, 3, 3, seed=1), _shot(grid, dt, 4, 3, seed=2),
             _shot(grid, dt, 2, 3, seed=3)]
    engine = SurveyEngine(physics_name, grid, params, NT, dt, order=ORDER,
                          plan=TBPlan((8, 8), 2, r), plan_cache=PlanCache(),
                          bucket_cap=2, device="cpu")
    assert engine.executor == "torch"
    res = engine.run(shots, return_wavefields=True)
    jengine = JEngine(physics_name, grid, {f: p.numpy() for f, p in
                                           params.items()},
                      NT, dt, order=ORDER, executor="jnp",
                      plan=JPlan((8, 8), 2, r), plan_cache=JCache(),
                      bucket_cap=2)
    jres = jengine.run([_jax(s) for s in shots], return_wavefields=True)
    assert res.stats["buckets"] == jres.stats["buckets"] == 2
    assert res.stats["batches"] == jres.stats["batches"] == 2
    assert res.stats["bucket_keys"] == jres.stats["bucket_keys"]
    names = phys.PHYSICS[physics_name].state_fields
    for i, (got, want) in enumerate(zip(res.traces, jres.traces)):
        _assert_traces_close(got, np.asarray(want), f"shot {i}")
        assert_fields_close(
            zip(names, [f.numpy() for f in res.wavefields[i]],
                [np.asarray(f) for f in jres.wavefields[i]]),
            FIELD_RTOL, f"{physics_name} shot {i}")
    # and the port's own sequential calls, bit for bit on the CPU
    seq = sequential_traces(physics_name, shots, grid, params, engine.plan,
                            ORDER, dt, NT, device="cpu")
    for got, want in zip(res.traces, seq):
        np.testing.assert_array_equal(got, want)


def test_engine_one_sweep_one_build_per_bucket():
    """>= 4 shots across >= 2 buckets: exactly one autotune sweep and one
    executable build per bucket; a rerun adds neither."""
    grid, dt, params = _case("acoustic")
    shots = [_shot(grid, dt, 1, 3, seed=1), _shot(grid, dt, 1, 4, seed=2),
             _shot(grid, dt, 2, 3, seed=3), _shot(grid, dt, 2, 3, seed=4),
             _shot(grid, dt, 1, 3, seed=5)]
    cache = PlanCache()
    engine = SurveyEngine("acoustic", grid, params, NT, dt, order=ORDER,
                          plan_cache=cache, bucket_cap=2, device="cpu")
    result = engine.run(shots)
    assert result.stats["buckets"] >= 2
    assert cache.sweeps == 1
    assert set(engine.trace_counts.values()) == {1}
    assert set(result.stats["traces_per_bucket"].values()) == {1}

    engine2 = SurveyEngine("acoustic", grid, params, NT, dt, order=ORDER,
                           plan_cache=cache, bucket_cap=2, device="cpu")
    assert cache.sweeps == 1 and engine2.cache_info.hit

    result2 = engine.run(shots)
    assert set(engine.trace_counts.values()) == {1}
    assert result2.stats["compile_seconds"] == 0.0
    for a, b in zip(result.traces, result2.traces):
        np.testing.assert_array_equal(a, b)
    refs = sequential_traces("acoustic", shots, grid, params, engine.plan,
                             ORDER, dt, NT, device="cpu")
    for got, ref in zip(result.traces, refs):
        _assert_traces_close(got, ref, "sequential")


def test_run_stats_keys_and_cold_warm_split():
    assert set(RUN_STATS_KEYS) == set(J_KEYS)
    grid, dt, params = _case("acoustic")
    shots = [_shot(grid, dt, 1, 3, seed=1), _shot(grid, dt, 2, 3, seed=2)]
    engine = SurveyEngine("acoustic", grid, params, NT, dt, order=ORDER,
                          plan_cache=PlanCache(), bucket_cap=2,
                          device="cpu")
    s = engine.run(shots).stats
    assert set(s) == set(RUN_STATS_KEYS)
    assert s["plan_seconds"] > 0.0
    assert s["compile_seconds"] > 0.0
    assert s["cold_seconds"] == pytest.approx(
        s["plan_seconds"] + s["compile_seconds"])
    assert s["warm_seconds"] == pytest.approx(
        max(s["seconds"] - s["compile_seconds"], 1e-12))
    assert s["shots_per_s"] == pytest.approx(len(shots) / s["warm_seconds"])
    assert set(s["metrics"]) == {"counters", "gauges", "histograms"}
    s2 = engine.run(shots).stats
    assert set(s2) == set(RUN_STATS_KEYS)
    assert s2["plan_seconds"] == 0.0 and s2["compile_seconds"] == 0.0
    assert s2["warm_seconds"] == pytest.approx(s2["seconds"])
    assert s2["cold_seconds"] == 0.0
    assert engine.batch_times == []          # CUDA events only on a card


def test_engine_rejects_bad_input():
    grid, dt, params = _case("acoustic")
    engine = SurveyEngine("acoustic", grid, params, NT, dt, order=ORDER,
                          plan_cache=PlanCache(), device="cpu")
    bad = _shot(grid, dt, 1, 2, seed=1)
    bad = Shot(src_coords=bad.src_coords, wavelet=np.zeros((NT + 2, 1)),
               rec_coords=bad.rec_coords)
    with pytest.raises(ValueError, match="nt"):
        engine.run([bad])
    with pytest.raises(ValueError, match="executor"):
        SurveyEngine("acoustic", grid, params, NT, dt, executor="pallas",
                     plan_cache=PlanCache(), device="cpu")
    with pytest.raises(ValueError, match="bucket_cap"):
        SurveyEngine("acoustic", grid, params, NT, dt, bucket_cap=0,
                     plan_cache=PlanCache(), device="cpu")


def test_caps_scale_with_interp_footprint():
    from repro_torch.core import interp as interp_mod

    grid, dt, params = _case("acoustic")
    lin = SurveyEngine("acoustic", grid, params, NT, dt, order=ORDER,
                       plan_cache=PlanCache(), device="cpu")
    assert lin._caps((4, 8)) == (8 * 4, 8 * 4, 8 * 8)
    snc = SurveyEngine("acoustic", grid, params, NT, dt, order=ORDER,
                       plan_cache=PlanCache(), interp="sinc",
                       interp_order=2, device="cpu")
    assert snc.interp == interp_mod.InterpSpec(kernel="sinc", radius=2)
    assert snc._caps((4, 8)) == (64 * 4, 64 * 4, 64 * 8)


def test_stencil_survey_cli_check_passes():
    env = dict(os.environ, PYTHONPATH=str(ROOT / "src"))
    out = subprocess.run(
        [sys.executable, "-m", "repro_torch.launch.stencil_survey",
         "--device", "cpu", "--check", "--shots", "4", "--n", "12",
         "--nt", "3", "--physics", "tti"],
        capture_output=True, text=True, env=env, cwd=ROOT, timeout=300)
    assert out.returncode == 0, out.stdout + out.stderr
    assert "CHECK PASS" in out.stdout


def test_batch_bytes_counts_what_a_batch_allocates():
    """The elastic kernel (csrc/stencil_tb_elastic.cu) at T = 3, order 4
    (halo 12: the z-streamed schedule) allocates, a shot: its outputs and
    partials, float32 z-major copies of its padded state and 9 z-major
    windows a block (here each block the whole 8x8 tile); the params'
    copies are kept once for all shots."""
    from repro_torch.kernels import ops
    from repro_torch.kernels import stencil_tb as ker
    from repro_torch.survey.engine import batch_bytes

    p = phys.ELASTIC
    plan = TBPlan((8, 8), 3, p.step_radius(ORDER))
    spec = ops.make_spec((16, 16, 8), plan, ORDER, 1e-3, (10.0,) * 3, 1, 1,
                         physics=p)
    assert ker.launch_plan(spec, p)[:2] == (8, 8)
    shared, per_shot = batch_bytes(p, spec, None)
    padded = (16 + 24) ** 2 * 8 * 4                 # halo 12 a side
    assert shared == 4 * padded + 4 * padded        # padded params + copies
    copies = 9 * padded                             # the state, z-major
    windows = 4 * 9 * (8 + 24) ** 2 * 8 * 4         # 4 blocks x 9 windows
    partials = 4 * 3 * 1 * 2 * 4                    # (ntiles, T, cap, chan)
    assert per_shot == 9 * (16 * 16 * 8 * 4 + padded) + 9 * 16 * 16 * 8 * 4 \
        + partials + copies + windows


def test_batch_bytes_counts_the_tti_param_copies():
    """The TTI main plan at 512^3 (tile 32, T = 4, order 4: halo 16) takes
    the z-streamed schedule: the survey keeps, for all shots, the 6 padded
    params and their float32 z-major copies (3.64 GB); a shot needs its
    state, padded state, outputs and partials, the z-major copies of its 4
    state fields and 7 windows a block (p, r twice over 56^2, the three
    inner derivatives over 60^2), 256 blocks."""
    from repro_torch.kernels import ops
    from repro_torch.kernels import stencil_tb as ker
    from repro_torch.survey.engine import batch_bytes

    p = phys.TTI
    plan = TBPlan((32, 32), 4, p.step_radius(ORDER))
    spec = ops.make_spec((512,) * 3, plan, ORDER, 1e-3, (20.0,) * 3, 1, 1,
                         physics=p)
    assert ker.launch_plan(spec, p)[:2] == (32, 32)
    shared, per_shot = batch_bytes(p, spec, None)
    padded = 544 * 544 * 512 * 4
    assert shared == 6 * padded + 6 * padded
    assert 6 * padded == 3_636_461_568
    grid = 512 ** 3 * 4
    windows = 256 * (4 * 56 * 56 + 3 * 60 * 60) * 512 * 4
    partials = 256 * 4 * 1 * 1 * 4
    assert per_shot == 4 * (grid + padded) + 4 * grid + partials \
        + 4 * padded + windows


def test_batch_bytes_counts_the_remainder_copies():
    """With nt = 7 and T = 4 the acoustic remainder tile (T = 3, halo 6)
    streams too, and reads its own copies of its own padded params: the
    shared bytes count both tiles' pads and both sets of copies."""
    from repro_torch.kernels import ops
    from repro_torch.kernels import stencil_tb as ker
    from repro_torch.survey.engine import batch_bytes

    p = phys.ACOUSTIC
    specs = [ops.make_spec((16, 16, 8), TBPlan((8, 8), T, 2), ORDER, 1e-3,
                           (10.0,) * 3, 1, 1, physics=p) for T in (4, 3)]
    assert all(ker.launch_plan(s, p) is not None for s in specs)
    shared, _ = batch_bytes(p, *specs)
    assert shared == sum(2 * 2 * (16 + 2 * s.halo) ** 2 * 8 * 4
                         for s in specs)


@pytest.mark.parametrize("physics", ["acoustic", "elastic", "tti"])
def test_memory_check_follows_launch_bytes(physics, monkeypatch):
    """`SurveyEngine`'s bucket sizing (`_check_memory`) admits a batch
    exactly when the card's free memory covers the shared bytes plus
    bucket_cap times `batch_bytes`' per-shot bytes, which take the kernel's
    allocations from `stencil_tb.launch_bytes` and
    `launch_shared_bytes`."""
    import torch

    from repro_torch.kernels import stencil_tb as ker
    from repro_torch.survey import engine as E

    grid = Grid((16, 16, 8), (10.0,) * 3)
    rng = np.random.RandomState(0)
    params = build_model(physics, grid.shape, grid, rng, device="cpu")
    p = phys.PHYSICS[physics]
    eng = SurveyEngine(physics, grid, params, 5, 1e-3, bucket_cap=3,
                       plan=TBPlan((8, 8), 2, p.step_radius(ORDER)),
                       plan_cache=PlanCache(), device="cpu")
    spec, rspec = eng._specs((1, 1))
    shared, per_shot = E.batch_bytes(p, spec, rspec)
    assert per_shot - ker.launch_bytes(spec, p) == len(p.state_fields) * (
        16 * 16 * 8 + (16 + 2 * spec.halo) ** 2 * 8) * 4
    assert shared - sum(ker.launch_shared_bytes(s, p)
                        for s in (spec, rspec)) == len(
        p.param_fields) * sum((16 + 2 * s.halo) ** 2 * 8 * 4
                              for s in (spec, rspec))
    need = shared + 3 * per_shot
    monkeypatch.setattr(torch.cuda, "memory_snapshot", lambda: [])
    monkeypatch.setattr(torch.cuda, "current_device", lambda: 0)
    for free, ok in ((need, True), (need - 1, False)):
        monkeypatch.setattr(torch.cuda, "mem_get_info",
                            lambda dev=None, f=free: (f, 2 * f))
        if ok:
            eng._check_memory()
        else:
            with pytest.raises(ValueError, match="bucket_cap=3"):
                eng._check_memory()

def _segment(total, allocated):
    """One entry of `torch.cuda.memory_snapshot()` (the keys read)."""
    return {"device": 0, "total_size": total, "allocated_size": allocated,
            "active_size": allocated}


def test_memory_check_refuses_free_memory_in_split_segments(monkeypatch):
    """`_check_memory` counts the device's free memory and the cached
    segments that hold no live block, never the free memory inside a
    segment that also holds a live tensor: a batch that fits only by
    counting that is refused, at construction, with the usual message."""
    import torch

    from repro_torch.survey import engine as E

    grid = Grid((16, 16, 8), (10.0,) * 3)
    rng = np.random.RandomState(0)
    params = build_model("tti", grid.shape, grid, rng, device="cpu")
    eng = SurveyEngine("tti", grid, params, 5, 1e-3, bucket_cap=3,
                       plan=TBPlan((8, 8), 2, phys.TTI.step_radius(ORDER)),
                       plan_cache=PlanCache(), device="cpu")
    need = eng._batch_need(eng.plan)
    free, whole = need // 2, need // 4
    split = [_segment(4 * need, need // 100)]        # mostly free, pinned
    freed = [_segment(whole, 0)]                     # wholly free
    monkeypatch.setattr(torch.cuda, "current_device", lambda: 0)
    monkeypatch.setattr(torch.cuda, "mem_get_info",
                        lambda dev=None: (free, 8 * need))
    monkeypatch.setattr(torch.cuda, "memory_snapshot",
                        lambda: split + freed + [{**freed[0], "device": 1}])
    dev = torch.device("cuda", 0)
    assert E.free_device_bytes(dev) == free + whole
    with pytest.raises(ValueError, match="bucket_cap=3"):
        eng._check_memory()
    # the same free bytes, all in wholly free segments: admitted
    monkeypatch.setattr(torch.cuda, "memory_snapshot",
                        lambda: [_segment(need - free, 0)])
    assert E.free_device_bytes(dev) == need
    eng._check_memory()
    assert eng._scratch is None        # the plain executor takes none


def test_scratch_sizes_and_check():
    """`stencil_tb.scratch_bytes` is a launch's scratch (B rows of
    `launch_bytes`' scratch part), `make_scratch` the largest over the
    main and remainder tiles, and the wrapper's `scratch=` check refuses a
    buffer of the wrong dtype or too small, or not flat and contiguous."""
    import torch

    from repro_torch.kernels import ops
    from repro_torch.kernels import stencil_tb as ker

    p = phys.TTI
    specs = [ops.make_spec((32, 32, 8), TBPlan((16, 16), T, 4), ORDER,
                           1e-3, (10.0,) * 3, 1, 1, physics=p)
             for T in (2, 1)]
    for s in specs:
        per_row, _, sdtype = ker._scratch_elems(s, p)
        assert ker.scratch_bytes(s, p, 3) == 3 * per_row * sdtype.itemsize
        out_bytes = (len(p.state_fields) * 32 * 32 * 8
                     + 4 * s.T * s.rec_cap * p.rec_channels) * 4
        assert ker.scratch_bytes(s, p, 1) == ker.launch_bytes(s, p) \
            - out_bytes
    buf = ker.make_scratch(specs + [None], p, 3, "cpu")
    need = max(ker.scratch_bytes(s, p, 3) for s in specs)
    assert buf.dtype == torch.uint8 and buf.numel() == need
    cpu = torch.device("cpu")
    ker.check_scratch(buf, need, cpu)
    ker.check_scratch(buf, need - 1, cpu)
    with pytest.raises(ValueError, match="bytes"):
        ker.check_scratch(buf, need + 1, cpu)
    with pytest.raises(TypeError, match="dtype"):
        ker.check_scratch(buf.view(torch.float32), 16, cpu)
    with pytest.raises(ValueError, match="contiguous"):
        ker.check_scratch(buf[: need // 2 * 2].view(2, -1), 16, cpu)
    with pytest.raises(ValueError, match="contiguous"):
        ker.check_scratch(buf[1:], 16, cpu)


def test_sweep_keeps_to_what_a_batch_can_hold():
    """The engine's sweep on a card passes `_fits`: a plan whose batch
    (`_batch_need`) exceeds the card's memory is not picked; the cheapest
    that fits is.  Here the sweep is asked directly, with a budget just
    below the unconstrained winner's need."""
    from repro_torch.core.temporal_blocking import plan_for_physics

    grid = Grid((32, 32, 8), (10.0,) * 3)
    rng = np.random.RandomState(0)
    params = build_model("acoustic", grid.shape, grid, rng, device="cpu")
    eng = SurveyEngine("acoustic", grid, params, 9, 1e-3, bucket_cap=2,
                       plan=TBPlan((8, 8), 2, 2), plan_cache=PlanCache(),
                       device="cpu")
    kw = dict(tiles=(8, 16, 32), depths=(1, 2, 4, 8))
    best, _ = plan_for_physics("acoustic", 8, ORDER, **kw)
    budget = eng._batch_need(best) - 1
    plan, log = plan_for_physics(
        "acoustic", 8, ORDER, feasible=lambda p: eng._fits(p, budget), **kw)
    assert (plan.tile, plan.T) != (best.tile, best.T)
    assert eng._batch_need(plan) <= budget
    fits = [e["cost_s"] for k, e in log.items()
            if eng._fits(TBPlan((k[0], k[1]), k[2], 2), budget)]
    assert log[log.best_key]["cost_s"] == min(fits)
    assert not eng._fits(TBPlan((12, 12), 2, 2), 10 ** 15)   # 12 ∤ 32
