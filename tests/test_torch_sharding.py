"""The port's sharding rules (`repro_torch.distributed.sharding`) against
the reference's (`repro.distributed.sharding`), for every architecture of
the registry at full size, on the two production meshes: (16, 16)
("data", "model") and (2, 16, 16) ("pod", "data", "model") with
dp_axes=("pod", "data").

The reference's side runs on `jax.sharding.AbstractMesh` (no devices)
over its `api.param_specs` / `input_specs` / `cache_specs`
(`jax.eval_shape`); the port's on `launch.mesh.make_production_mesh`
(a ``meta`` mesh) over its own specs (``meta`` tensors).  A spec is held
equal, leaf by leaf, to ``tuple(PartitionSpec)``:

- `param_pspecs` with and without FSDP, `opt_pspecs` (ZeRO-1) over each
  package's AdamW state, `batch_pspecs` over `input_specs` of TRAIN_4K
  and DECODE_32K, `cache_pspecs` over `cache_specs` of DECODE_32K and
  LONG_500K (batch 1: the sequence-sharded fallback);
- `activation_spec` for every tag, with and without SP;
- `needs_fsdp`, at the reference's default memory and at an H100's;
- the api specs' shapes and dtypes equal the reference's;
- the reference's own rule tests (`tests/test_distributed.py:228`,
  divisibility, and `:253`, ZeRO-1 adds the data axis), ported;
- `shard_of` / `unshard` place every rank's slice and put them back.
"""
import jax
import numpy as np
import pytest
import torch
from jax.sharding import AbstractMesh
from jax.sharding import PartitionSpec as P

from repro import configs as jconfigs
from repro.distributed import sharding as jsharding
from repro.models import api as japi
from repro.optim import adamw_init as jadamw_init

from repro_torch import configs
from repro_torch.distributed import ShardingRules, needs_fsdp
from repro_torch.distributed.sharding import (all_coords, shard_of,
                                              shard_slices, unshard)
from repro_torch.tree import named_leaves
from repro_torch.launch.mesh import make_mesh, make_production_mesh
from repro_torch.models import api
from repro_torch.optim import adamw_init

ARCHS = list(configs.ARCHS)
MESHES = {
    "pod": ((16, 16), ("data", "model"), ("data",)),
    "multipod": ((2, 16, 16), ("pod", "data", "model"), ("pod", "data")),
}
H100_BYTES = 80 * 10 ** 9


def test_registry_is_the_reference_s():
    assert tuple(configs.ARCHS) == tuple(jconfigs.ARCHS)


def _rules(mesh, arch, **kw):
    """(reference rules, port rules) on the named production mesh."""
    shape, axes, dp = MESHES[mesh]
    jr = jsharding.ShardingRules(mesh=AbstractMesh(shape, axes),
                                 cfg=jconfigs.get(arch), dp_axes=dp, **kw)
    tm = make_production_mesh(multi_pod=mesh == "multipod")
    assert tm.shape == dict(zip(axes, shape))
    return jr, ShardingRules(mesh=tm, cfg=configs.get(arch), dp_axes=dp,
                             **kw)


_specs = {}


def _param_specs(arch):
    """(reference param specs, port param specs) at TRAIN_4K, cached."""
    if arch not in _specs:
        _specs[arch] = (japi.param_specs(jconfigs.get(arch),
                                         jconfigs.TRAIN_4K),
                        api.param_specs(configs.get(arch), configs.TRAIN_4K))
    return _specs[arch]


def _key(k) -> str:
    if isinstance(k, jax.tree_util.DictKey):
        return str(k.key)
    if isinstance(k, jax.tree_util.GetAttrKey):
        return str(k.name)
    raise TypeError(k)


def _ref_named(tree) -> dict:
    """{path name: leaf} of a reference tree (PartitionSpecs as leaves)."""
    flat, _ = jax.tree_util.tree_flatten_with_path(
        tree, is_leaf=lambda x: isinstance(x, P))
    return {"/".join(_key(k) for k in path): leaf for path, leaf in flat}


def _assert_same_specs(got, want):
    want = {k: tuple(v) for k, v in _ref_named(want).items()}
    got = dict(named_leaves(got))
    assert sorted(got) == sorted(want)
    bad = {k: (got[k], want[k]) for k in want if got[k] != want[k]}
    assert not bad, bad


@pytest.mark.parametrize("fsdp", [False, True], ids=["tp", "fsdp"])
@pytest.mark.parametrize("mesh", list(MESHES))
@pytest.mark.parametrize("arch", ARCHS)
def test_param_pspecs_equal_reference(arch, mesh, fsdp):
    jr, tr = _rules(mesh, arch, fsdp=fsdp)
    jp, tp = _param_specs(arch)
    _assert_same_specs(tr.param_pspecs(tp), jr.param_pspecs(jp))


@pytest.mark.parametrize("fsdp", [False, True], ids=["tp", "fsdp"])
@pytest.mark.parametrize("mesh", list(MESHES))
@pytest.mark.parametrize("arch", ARCHS)
def test_opt_pspecs_equal_reference(arch, mesh, fsdp):
    jr, tr = _rules(mesh, arch, fsdp=fsdp)
    jp, tp = _param_specs(arch)
    want = jr.opt_pspecs(jax.eval_shape(jadamw_init, jp))
    got = tr.opt_pspecs(adamw_init(tp))
    assert got.step == tuple(want.step) == ()
    for field in ("master", "mu", "nu"):
        _assert_same_specs(getattr(got, field), getattr(want, field))


@pytest.mark.parametrize("mesh", list(MESHES))
@pytest.mark.parametrize("arch", ARCHS)
def test_batch_pspecs_equal_reference(arch, mesh):
    jr, tr = _rules(mesh, arch)
    for jshape, shape in ((jconfigs.TRAIN_4K, configs.TRAIN_4K),
                          (jconfigs.DECODE_32K, configs.DECODE_32K)):
        want = jr.batch_pspecs(japi.input_specs(jconfigs.get(arch), jshape))
        got = tr.batch_pspecs(api.input_specs(configs.get(arch), shape))
        assert got == {k: tuple(v) for k, v in want.items()}


@pytest.mark.parametrize("mesh", list(MESHES))
@pytest.mark.parametrize("arch", ARCHS)
def test_cache_pspecs_equal_reference(arch, mesh):
    """DECODE_32K (batch 128: batch over dp) and LONG_500K (batch 1: the
    sequence over dp, kv heads or the sequence over model)."""
    jr, tr = _rules(mesh, arch)
    for shape in (configs.DECODE_32K, configs.LONG_500K):
        B, S = shape.global_batch, shape.seq_len
        want = jr.cache_pspecs(japi.cache_specs(jconfigs.get(arch), B, S))
        _assert_same_specs(
            tr.cache_pspecs(api.cache_specs(configs.get(arch), B, S)), want)


TAGS = {  # tag -> shapes (one divisible by the axes, one not)
    "act_model": [(256, 4096, 2048), (3, 4095, 2048)],
    "act_heads": [(256, 4096, 32, 128), (256, 4096, 7, 128)],
    "act_kv_heads": [(256, 4096, 16, 128), (2, 4096, 1, 128)],
    "act_ff": [(256, 4096, 8192), (256, 4096, 8191)],
    "act_vocab": [(256, 4096, 151936), (256, 4096, 50280)],
    "moe_expert_batch": [(128, 320, 2048), (60, 320, 2048)],
    "moe_expert_batch_g": [(32, 128, 320, 2048), (3, 60, 320, 2048)],
    "unknown": [(256, 4096)],
}


@pytest.mark.parametrize("sp", [False, True], ids=["no-sp", "sp"])
@pytest.mark.parametrize("mesh", list(MESHES))
def test_activation_spec_equals_reference(mesh, sp):
    jr, tr = _rules(mesh, "qwen3-1.7b", sp=sp)
    for tag, shapes in TAGS.items():
        for shape in shapes:
            want = jr.activation_spec(jax.ShapeDtypeStruct(shape, np.float32),
                                      tag)
            got = tr.activation_spec(torch.empty(shape, device="meta"), tag)
            assert got == (None if want is None else tuple(want)), (tag,
                                                                   shape)
    x = torch.ones(2, 3)
    assert tr.constrain(x, "act_model") is x


@pytest.mark.parametrize("arch", ARCHS)
def test_needs_fsdp_equals_reference(arch):
    for tp in (1, 16):
        for hbm in ({}, {"hbm_bytes": H100_BYTES}):
            assert needs_fsdp(configs.get(arch), tp, **hbm) == \
                jsharding.needs_fsdp(jconfigs.get(arch), tp, **hbm)


def _shapes_dtypes(tree) -> dict:
    return {k: (tuple(v.shape), str(v.dtype).replace("torch.", ""))
            for k, v in named_leaves(tree)}


def _ref_shapes_dtypes(tree) -> dict:
    return {k: (tuple(v.shape), str(v.dtype))
            for k, v in _ref_named(tree).items()}


@pytest.mark.parametrize("arch", ARCHS)
def test_api_specs_shapes_and_dtypes_equal_reference(arch):
    cfg, jcfg = configs.get(arch), jconfigs.get(arch)
    jp, tp = _param_specs(arch)
    assert all(t.device.type == "meta" for _, t in named_leaves(tp))
    assert _shapes_dtypes(tp) == _ref_shapes_dtypes(jp)
    for name, shape in configs.SHAPES.items():
        got = api.input_specs(cfg, shape)
        want = japi.input_specs(jcfg, jconfigs.SHAPES[name])
        assert list(got) == list(want)
        assert _shapes_dtypes(got) == _ref_shapes_dtypes(want)
    for B, S, enc in ((128, 32768, None), (1, 1024, 1500)):
        assert _shapes_dtypes(api.cache_specs(cfg, B, S, enc)) == \
            _ref_shapes_dtypes(japi.cache_specs(jcfg, B, S, enc))


def test_sharding_rules_divisibility():
    """`tests/test_distributed.py::test_sharding_rules_divisibility`,
    ported, on the (16, 16) mesh: no rule shards a dimension its axes do
    not divide (granite's MQA kv=1 over tp=16)."""
    _, tr = _rules("pod", "granite-34b")
    params = api.param_specs(configs.get("granite-34b"), configs.TRAIN_4K)
    specs = dict(named_leaves(tr.param_pspecs(params)))
    for name, leaf in named_leaves(params):
        for d, ax in enumerate(specs[name]):
            if ax is not None:
                assert leaf.shape[d] % tr.axis_size(ax) == 0, (name, d, ax)
    assert specs["blocks/attn/wk"][2] is None      # kv heads = 1


def test_zero1_adds_data_sharding():
    """`tests/test_distributed.py::test_zero1_adds_data_sharding`, ported:
    the master leaves carry the data axis under ZeRO-1 while the params
    do not."""
    mesh = make_mesh((2, 1), ("data", "model"), ["meta"])
    cfg = configs.get_reduced("qwen2-7b")
    rules = ShardingRules(mesh=mesh, cfg=cfg)
    params = api.param_specs(cfg, configs.TRAIN_4K)
    specs = rules.opt_pspecs(adamw_init(params))
    found = [any(ax == "data" for ax in s)
             for _, s in named_leaves(specs.master)]
    assert any(found)
    assert not any(any(ax == "data" for ax in s)
                   for _, s in named_leaves(rules.param_pspecs(params)))


@pytest.mark.parametrize("spec", [
    (("pod", "data"), "model"), ("data", None, "model"), (None, None),
    ("model", ("pod", "data")), ()],
    ids=["pod-data", "data-model", "replicated", "model-first", "scalar"])
def test_shard_of_and_unshard_round_trip(spec):
    """Each rank's slice is its block of the global array (a dimension
    over (a, b) in blocks indexed a * |b| + b, JAX's order) and the
    slices put back give the array."""
    mesh = make_mesh((2, 3, 2), ("pod", "data", "model"), ["meta"])
    shape = {2: (12, 12), 3: (6, 5, 4), 0: ()}[len(spec)]
    x = torch.arange(int(np.prod(shape)), dtype=torch.float32).reshape(shape)
    parts = [shard_of(x, spec, c, mesh) for c in all_coords(mesh)]
    for c, part in zip(all_coords(mesh), parts):
        assert torch.equal(part, x[shard_slices(x.shape, spec, c, mesh)])
    if spec == (("pod", "data"), "model"):
        c = {"pod": 1, "data": 2, "model": 1}
        assert torch.equal(shard_of(x, spec, c, mesh), x[10:12, 6:12])
    assert torch.equal(unshard(parts, spec, mesh), x)
    with pytest.raises(ValueError, match="split"):
        shard_slices((5, 4), ("data", None), {"data": 0}, mesh)
