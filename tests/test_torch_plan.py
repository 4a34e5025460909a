"""The port's plan model and plan cache against the JAX package's
(`repro.core.temporal_blocking`, `repro.survey.plan_cache`).

Given the reference's hardware constants explicitly, `autotune_plan` and
`plan_for_physics` must return the same plan, the same winning key and the
same sweep log, entry for entry (the arithmetic is the reference's, term
for term), on the calls `tests/test_tb_cost_model.py` makes.  A plan-cache
key is the reference's when every sweep argument is passed, and differs
when only the defaults are (the port's defaults are the H100's).
"""
import inspect

import pytest

from repro.core import temporal_blocking as jtb
from repro.survey import plan_cache as jpc
from repro_torch.core import temporal_blocking as ttb
from repro_torch.survey import plan_cache as tpc

# the reference's own defaults, passed explicitly to both
REF_HW = dict(vmem_budget=96 * 2 ** 20, peak_flops=197e12, hbm_bw=819e9,
              link_bw=45e9, link_latency=1.5e-6)

# (nz, radius, kwargs): the autotune_plan calls of test_tb_cost_model.py
AUTOTUNE_CASES = [
    (128, 2, dict(vmem_budget=8 * 2 ** 20)),
    (512, 12, dict(flops_per_point=1e5)),
    (512, 2, dict(flops_per_point=40.0)),
    (128, 2, dict(mesh_block=(32, 32))),
    (128, 2, dict(mesh_block=(32, 32), link_bw=1e30, link_latency=1.0)),
    (128, 2, dict(mesh_block=(32, 32), link_bw=1e3, link_latency=0.0)),
    (128, 2, dict(mesh_block=(64, 64), tiles=(16,), depths=(1, 2, 4, 8),
                  outer_depths=(8,))),
    (128, 2, dict(mesh_block=(64, 64), tiles=(16,), depths=(3, 6),
                  outer_depths=(4, 8))),
    (128, 2, dict(mesh_block=(32, 32), link_bw=1e9, link_latency=1e-6)),
    (128, 2, dict(mesh_block=(32, 32), link_bw=1e9, link_latency=1e-5,
                  sweep_overlap=True, exchange_lags=(2, 0),
                  exchange_fields=2)),
    (512, 2, dict(flops_per_point=float(
        jtb.PHYSICS_COSTS["acoustic"].flops_per_point(4)), fields=5,
        read_fields=4, write_fields=2)),
]

# (physics, nz, order, kwargs): the plan_for_physics calls of that file
PHYSICS_CASES = [
    ("acoustic", 128, 4, dict(mesh_block=(32, 32), link_bw=1e9,
                              link_latency=1e-6)),
    ("elastic", 128, 4, dict(mesh_block=(32, 32), link_bw=1e9,
                             link_latency=1e-6)),
    ("elastic", 128, 4, dict(mesh_block=(16, 16))),
    ("acoustic", 512, 4, {}),
    ("tti", 512, 12, {}),
    ("elastic", 512, 12, {}),
    ("elastic", 128, 4, dict(depths=(1, 2), tiles=(32,))),
    ("tti", 512, 4, dict(tiles=(4, 8, 16, 32, 64, 128),
                         depths=(1, 2, 4, 8))),
    ("acoustic", 64, 4, dict(mesh_block=(64, 64), tiles=(8, 16, 32),
                             depths=(1, 2, 4), outer_depths=(4, 8),
                             sweep_overlap=True)),
]


def _same_sweep(got, want):
    (tplan, tlog), (jplan, jlog) = got, want
    assert tplan.to_dict() == jplan.to_dict()
    assert tlog.best_key == jlog.best_key
    assert tlog[tlog.best_key] == jlog[jlog.best_key]
    assert tlog == jlog                   # every entry, term for term


@pytest.mark.parametrize("nz,radius,kw", AUTOTUNE_CASES)
def test_autotune_matches_reference(nz, radius, kw):
    args = {**REF_HW, **kw}
    _same_sweep(ttb.autotune_plan(nz, radius, **args),
                jtb.autotune_plan(nz, radius, **args))


@pytest.mark.parametrize("physics,nz,order,kw", PHYSICS_CASES)
def test_plan_for_physics_matches_reference(physics, nz, order, kw):
    args = {**REF_HW, **kw}
    _same_sweep(ttb.plan_for_physics(physics, nz, order, **args),
                jtb.plan_for_physics(physics, nz, order, **args))


def test_physics_costs_match_reference():
    for name, pc in ttb.PHYSICS_COSTS.items():
        jc = jtb.PHYSICS_COSTS[name]
        assert (pc.state_fields, pc.param_fields, pc.evolved_fields,
                pc.radius_mult, pc.halo_lag_units, pc.fields,
                pc.read_fields, pc.write_fields) == \
            (jc.state_fields, jc.param_fields, jc.evolved_fields,
             jc.radius_mult, jc.halo_lag_units, jc.fields, jc.read_fields,
             jc.write_fields)
        for order in (2, 4, 8, 12):
            assert pc.flops_per_point(order) == jc.flops_per_point(order)
            assert pc.exchange_lags(order) == jc.exchange_lags(order)
    assert set(ttb.PHYSICS_COSTS) == set(jtb.PHYSICS_COSTS)


@pytest.mark.parametrize("tile,T,r,block,outer_T", [
    ((16, 16), 4, 2, (64, 64), 4), ((16, 16), 2, 2, (64, 64), 4),
    ((8, 16), 3, 4, (48, 32), 6), ((32, 32), 1, 1, (32, 32), 5)])
def test_plan_cost_methods_match_reference(tile, T, r, block, outer_T):
    a, b = jtb.TBPlan(tile, T, r), ttb.TBPlan(tile, T, r)
    nz = 64
    assert b.vmem_bytes(nz, 13) == a.vmem_bytes(nz, 13)
    assert b.nested_compute_multiplier(block, outer_T) == \
        a.nested_compute_multiplier(block, outer_T)
    assert b.nested_hbm_bytes_per_point_step(block, outer_T, nz, 10, 4) == \
        a.nested_hbm_bytes_per_point_step(block, outer_T, nz, 10, 4)
    assert b.exchange_bytes_per_tile(block, nz, 9) == \
        a.exchange_bytes_per_tile(block, nz, 9)
    assert b.exchange_bytes_per_tile(block, nz, depths=(4, 2, 0)) == \
        a.exchange_bytes_per_tile(block, nz, depths=(4, 2, 0))
    assert b.exchange_seconds_per_point_step(block, nz, 3, 1e9, 1e-6) == \
        a.exchange_seconds_per_point_step(block, nz, 3, 1e9, 1e-6)
    assert b.split_step_overhead_per_point_step(block, nz, r, 40.0, 1e12) \
        == a.split_step_overhead_per_point_step(block, nz, r, 40.0, 1e12)
    assert [tuple(g) for g in ttb.nested_pass_geometry(block, tile, outer_T,
                                                       T, r)] == \
        [tuple(g) for g in jtb.nested_pass_geometry(block, tile, outer_T, T,
                                                    r)]


def test_defaults_are_the_h100_data_sheet():
    sig = inspect.signature(ttb.autotune_plan).parameters
    assert sig["peak_flops"].default == 67e12
    assert sig["hbm_bw"].default == 3.35e12
    assert sig["link_bw"].default == 450e9
    assert sig["vmem_budget"].default is None      # no on-chip window cap
    # the reference's parameters, name for name
    assert list(sig) == list(inspect.signature(jtb.autotune_plan).parameters)
    # with no cap every candidate is priced
    _, log = ttb.autotune_plan(512, 2, tiles=(16, 256), depths=(1, 16))
    assert len(log) == 8
    with pytest.raises(ValueError, match="outer_depths"):
        ttb.autotune_plan(64, 2, outer_depths=(4,))


def _all_sweep_args():
    """Every defaulted parameter of `autotune_plan` at the reference's
    value (so nothing is resolved from either package's defaults)."""
    sig = inspect.signature(jtb.autotune_plan).parameters
    return {k: p.default for k, p in sig.items()
            if p.default is not inspect.Parameter.empty}


@pytest.mark.parametrize("physics,block,extra", [
    ("acoustic", None, None),
    ("elastic", (32, 32), {"grid_shape": [64, 64, 32], "use": "x"}),
])
def test_plan_cache_key_matches_reference(physics, block, extra):
    kw = _all_sweep_args()
    kw["mesh_block"] = block
    assert tpc.plan_cache_key(physics, 64, 4, block=block, key_extra=extra,
                              **kw) == \
        jpc.plan_cache_key(physics, 64, 4, block=block, key_extra=extra,
                           **kw)
    # defaults resolved from each package's own signature differ
    assert tpc.plan_cache_key(physics, 64, 4, block=block) != \
        jpc.plan_cache_key(physics, 64, 4, block=block)


def test_cached_plan_equals_reference_and_sweeps_once(tmp_path):
    kw = dict(REF_HW, tiles=(8, 16), depths=(1, 2))
    cache = tpc.PlanCache(disk_dir=str(tmp_path / "plans"))
    plan, entry, info = tpc.cached_plan_for_physics("tti", 16, 4,
                                                    cache=cache, **kw)
    jplan, jentry, jinfo = jpc.cached_plan_for_physics(
        "tti", 16, 4, cache=jpc.PlanCache(), **kw)
    assert plan.to_dict() == jplan.to_dict() and entry == jentry
    assert info.key == jinfo.key and not info.hit
    again = tpc.PlanCache(disk_dir=str(tmp_path / "plans"))
    plan2, entry2, info2 = tpc.cached_plan_for_physics("tti", 16, 4,
                                                       cache=again, **kw)
    assert info2.hit and again.sweeps == 0 and plan2 == plan
    assert entry2 == entry


def test_plan_for_physics_skips_plans_the_caller_refuses():
    """`feasible` keeps the sweep to the plans it accepts (the survey
    engine refuses the plans whose batch does not fit the card): the
    winner is the cheapest accepted candidate, the log keeps every one;
    with none accepted the sweep raises."""
    kw = dict(tiles=(16, 32), depths=(1, 2, 4))
    plan, log = ttb.plan_for_physics("acoustic", 64, 4, **kw)
    best = (plan.tile, plan.T)
    plan2, log2 = ttb.plan_for_physics(
        "acoustic", 64, 4, feasible=lambda p: (p.tile, p.T) != best, **kw)
    assert (plan2.tile, plan2.T) != best
    assert log2.best_key == (*plan2.tile, plan2.T)
    assert log2[log2.best_key]["cost_s"] == min(
        e["cost_s"] for k, e in log2.items() if (k[:2], k[2]) != best)
    assert len(log2) == len(log)
    with pytest.raises(ValueError, match="feasibility"):
        ttb.plan_for_physics("acoustic", 64, 4, feasible=lambda p: False,
                             **kw)


def test_plan_cache_key_leaves_out_the_callers_check():
    """A callable is no key component: the caller folds what it checks
    against into `key_extra`."""
    key = tpc.plan_cache_key("acoustic", 64, 4, tiles=(16,))
    assert tpc.plan_cache_key("acoustic", 64, 4, tiles=(16,),
                              feasible=lambda p: True) == key
    assert tpc.plan_cache_key("acoustic", 64, 4, tiles=(16,),
                              key_extra={"device_bytes": 1}) != key
