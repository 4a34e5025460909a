"""The port's config registry and `ModelConfig` against the reference's:
every ported architecture's CONFIG and REDUCED equal the reference's field
by field, with the same `param_count`, `hd()` and `gqa_groups()`; the
unported ones raise naming ROADMAP A11."""
import dataclasses

import pytest

from repro import configs as jconfigs

from repro_torch import configs

NEW = ["zamba2-2.7b", "qwen3-1.7b", "qwen2-7b", "granite-34b",
       "stablelm-12b"]


@pytest.mark.parametrize("reduced", [False, True], ids=["full", "reduced"])
@pytest.mark.parametrize("name", NEW)
def test_config_equals_reference(name, reduced):
    get, jget = ((configs.get_reduced, jconfigs.get_reduced) if reduced
                 else (configs.get, jconfigs.get))
    cfg, jcfg = get(name), jget(name)
    for f in dataclasses.fields(cfg):
        assert getattr(cfg, f.name) == getattr(jcfg, f.name), f.name
    assert cfg.param_count() == jcfg.param_count()
    assert cfg.hd() == jcfg.hd()
    assert cfg.gqa_groups() == jcfg.gqa_groups()


def test_registry():
    assert set(configs.ARCHS) == {"mamba2-130m"} | set(NEW)
    assert set(configs.UNPORTED) == {"llava-next-mistral-7b",
                                     "qwen3-moe-30b-a3b", "dbrx-132b",
                                     "whisper-medium"}
    assert set(configs.UNPORTED) | set(configs.ARCHS) == \
        set(jconfigs.ARCHS)
    for name in configs.UNPORTED:
        with pytest.raises(KeyError, match="A11"):
            configs.get(name)
    with pytest.raises(KeyError, match="unknown"):
        configs.get("gpt-2")


def test_published_sizes():
    """The figures the card phases print: zamba2-2.7b 2.42 G parameters,
    qwen3-1.7b 1.72 G (`param_count`)."""
    assert round(configs.get("zamba2-2.7b").param_count() / 1e9, 2) == 2.42
    assert round(configs.get("qwen3-1.7b").param_count() / 1e9, 2) == 1.72
