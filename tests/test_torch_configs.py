"""The port's config registry and `ModelConfig` against the reference's:
every architecture's CONFIG and REDUCED equal the reference's field by
field, with the same `param_count`, `active_param_count`, `hd()` and
`gqa_groups()`; the shapes and meshes of `configs.base` equal the
reference's."""
import dataclasses

import pytest

from repro import configs as jconfigs

from repro_torch import configs

NEW = ["zamba2-2.7b", "qwen3-1.7b", "qwen2-7b", "granite-34b",
       "stablelm-12b", "qwen3-moe-30b-a3b", "dbrx-132b", "whisper-medium",
       "llava-next-mistral-7b"]


@pytest.mark.parametrize("reduced", [False, True], ids=["full", "reduced"])
@pytest.mark.parametrize("name", NEW)
def test_config_equals_reference(name, reduced):
    get, jget = ((configs.get_reduced, jconfigs.get_reduced) if reduced
                 else (configs.get, jconfigs.get))
    cfg, jcfg = get(name), jget(name)
    for f in dataclasses.fields(cfg):
        assert getattr(cfg, f.name) == getattr(jcfg, f.name), f.name
    assert cfg.param_count() == jcfg.param_count()
    assert cfg.active_param_count() == jcfg.active_param_count()
    assert cfg.hd() == jcfg.hd()
    assert cfg.gqa_groups() == jcfg.gqa_groups()


def test_registry():
    assert set(configs.ARCHS) == {"mamba2-130m"} | set(NEW)
    assert configs.ARCHS == jconfigs.ARCHS
    assert configs.UNPORTED == ()
    for name in configs.ARCHS:
        assert configs.get(name).name == name
    with pytest.raises(KeyError, match="unknown"):
        configs.get("gpt-2")


def test_shapes_and_meshes():
    """`configs.base`'s benchmark shapes, `shapes_for` and the meshes equal
    the reference's."""
    from repro.configs import base as jbase

    from repro_torch.configs import base

    assert {k: dataclasses.asdict(v) for k, v in base.SHAPES.items()} == \
        {k: dataclasses.asdict(v) for k, v in jbase.SHAPES.items()}
    assert base.LONG_CONTEXT_FAMILIES == jbase.LONG_CONTEXT_FAMILIES
    for name in configs.ARCHS:
        assert [s.name for s in base.shapes_for(configs.get(name))] == \
            [s.name for s in jbase.shapes_for(jconfigs.get(name))]
    for mesh in ("SINGLE_POD", "MULTI_POD"):
        got, want = getattr(base, mesh), getattr(jbase, mesh)
        assert (got.shape, got.axes, got.num_devices) == \
            (want.shape, want.axes, want.num_devices)
    assert base.DECODE_32K.is_decode and not base.TRAIN_4K.is_decode


def test_published_sizes():
    """The figures the card phases print: zamba2-2.7b 2.42 G parameters,
    qwen3-1.7b 1.72 G (`param_count`)."""
    assert round(configs.get("zamba2-2.7b").param_count() / 1e9, 2) == 2.42
    assert round(configs.get("qwen3-1.7b").param_count() / 1e9, 2) == 1.72
