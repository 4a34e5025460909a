"""Guards of the port's package boundary.

The port must run on a machine without JAX: no module of
`src/repro_torch/`, and not `chip_smoke.py`, the tools or the port's
examples (`examples/torch_*.py`), may import `jax` or `repro`.
And its entry points default to the card, with no CPU fallback.
"""
import ast
from pathlib import Path

import numpy as np
import pytest
import torch

from repro_torch.core.temporal_blocking import TBPlan
from repro_torch.kernels import ops

ROOT = Path(__file__).resolve().parents[1]
PORT_FILES = sorted((ROOT / "src" / "repro_torch").rglob("*.py")) + [
    ROOT / "chip_smoke.py"] + sorted((ROOT / "tools").glob("*.py")) + \
    sorted((ROOT / "examples").glob("torch_*.py"))
BANNED = ("jax", "jaxlib", "repro")


def _imported_roots(path: Path):
    tree = ast.parse(path.read_text(), filename=str(path))
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            for alias in node.names:
                yield alias.name.split(".")[0]
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            yield node.module.split(".")[0]
        elif (isinstance(node, ast.Call)
              and getattr(node.func, "attr", getattr(node.func, "id", ""))
              in ("import_module", "__import__") and node.args
              and isinstance(node.args[0], ast.Constant)):
            yield str(node.args[0].value).split(".")[0]


@pytest.mark.parametrize("path", PORT_FILES,
                         ids=[str(p.relative_to(ROOT)) for p in PORT_FILES])
def test_port_imports_no_jax_or_reference(path):
    bad = sorted(set(_imported_roots(path)) & set(BANNED))
    assert not bad, f"{path.relative_to(ROOT)} imports {bad}"


def test_guard_sees_the_files():
    assert len(PORT_FILES) >= 15
    assert (ROOT / "chip_smoke.py").is_file()
    port = ROOT / "src" / "repro_torch"
    for pkg in ("survey", "telemetry", "launch", "configs", "models",
                "serving"):
        assert port / pkg / "__init__.py" in PORT_FILES
    assert port / "launch" / "stencil_survey.py" in PORT_FILES
    assert port / "launch" / "serve.py" in PORT_FILES
    assert port / "kernels" / "ssd_scan.py" in PORT_FILES
    assert port / "launch" / "dryrun.py" in PORT_FILES
    for mod in ("layers", "mamba2", "zamba2", "transformer",
                "api"):
        assert port / "models" / f"{mod}.py" in PORT_FILES
    for name in ("torch_quickstart.py", "torch_seismic_imaging.py"):
        assert ROOT / "examples" / name in PORT_FILES
    assert "jax" in set(_imported_roots(ROOT / "tests" / "test_torch_ops.py"))


def test_default_device_raises_without_card():
    if torch.cuda.is_available():
        pytest.skip("a card is present: the default device is valid here")
    z = np.zeros((8, 8, 4), np.float32)
    with pytest.raises(RuntimeError, match="cuda"):
        ops.acoustic_tb_propagate(2, z, z, z + 1.0, z, None, None,
                                  TBPlan(tile=(8, 8), T=1, radius=2), 4,
                                  1e-3, (10.0,) * 3)


def test_cpu_runs_only_when_asked():
    z = np.zeros((8, 8, 4), np.float32)
    (u0, u1), rec = ops.acoustic_tb_propagate(
        2, z, z, z + 1.0, z, None, None, TBPlan(tile=(8, 8), T=1, radius=2),
        4, 1e-3, (10.0,) * 3, device="cpu")
    assert rec is None and u1.device.type == "cpu"
    assert not torch.any(u1)


@pytest.mark.parametrize("physics", ["tti", "elastic"])
def test_multiphysics_entry_points_default_to_the_card(physics):
    """TTI and elastic raise without a card unless the CPU is asked for."""
    from repro_torch.core.propagators import elastic, tti

    mod, entry, nstate = {
        "tti": (tti, ops.tti_tb_propagate, 4),
        "elastic": (elastic, ops.elastic_tb_propagate, 9)}[physics]
    state = mod.init_state((8, 8, 4), device="cpu")
    params = tuple(torch.ones((8, 8, 4)) for _ in range(6 if nstate == 4
                                                         else 4))
    plan = TBPlan(tile=(8, 8), T=1, radius=4)
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="cuda"):
            entry(2, state, params, None, None, plan, 4, 1e-3, (10.0,) * 3)
        with pytest.raises(RuntimeError, match="cuda"):
            mod.init_state((8, 8, 4))
    final, rec = entry(2, state, params, None, None, plan, 4, 1e-3,
                       (10.0,) * 3, device="cpu")
    assert rec is None and len(final) == nstate
    assert all(f.device.type == "cpu" and not torch.any(f) for f in final)


def test_survey_engine_defaults_to_the_card():
    """The survey engine and its launcher raise without a card unless the
    CPU is asked for."""
    from repro_torch.core.grid import Grid
    from repro_torch.launch import stencil_survey
    from repro_torch.survey import PlanCache, SurveyEngine

    grid = Grid((8, 8, 4), (10.0,) * 3)
    params = {"m": np.ones((8, 8, 4), np.float32),
              "damp": np.zeros((8, 8, 4), np.float32)}
    plan = TBPlan(tile=(8, 8), T=1, radius=2)
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="cuda"):
            SurveyEngine("acoustic", grid, params, 2, 1e-3, plan=plan,
                         plan_cache=PlanCache())
        with pytest.raises(RuntimeError, match="cuda"):
            SurveyEngine("acoustic", grid, params, 2, 1e-3, plan=plan,
                         plan_cache=PlanCache(), device="cuda")
        with pytest.raises(RuntimeError, match="cuda"):
            stencil_survey.build_model("acoustic", (8, 8, 4), grid,
                                       np.random.RandomState(0))
    engine = SurveyEngine("acoustic", grid, params, 2, 1e-3, plan=plan,
                          plan_cache=PlanCache(), device="cpu")
    assert engine.device.type == "cpu" and engine.executor == "torch"
    assert engine.params["m"].device.type == "cpu"


@pytest.mark.parametrize("arch", ["zamba2-2.7b", "qwen3-1.7b"])
def test_hybrid_and_dense_entry_points_default_to_the_card(arch):
    """The hybrid and dense families' entry points raise without a card
    unless the CPU is asked for."""
    from repro_torch import configs
    from repro_torch.launch import serve
    from repro_torch.models import api, transformer, zamba2
    from repro_torch.serving import GenerationEngine

    cfg = configs.get_reduced(arch)
    cache_cls = (zamba2.HybridCache if cfg.family == "hybrid"
                 else transformer.KVCache)
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="cuda"):
            api.init(0, cfg)
        with pytest.raises(RuntimeError, match="cuda"):
            api.make_cache(cfg, 2, 16)
        with pytest.raises(RuntimeError, match="cuda"):
            cache_cls.zeros(cfg, 2, 16)
        params = api.init(0, cfg, device="cpu")
        with pytest.raises(RuntimeError, match="cuda"):
            GenerationEngine(params, cfg, max_len=16, batch_size=2)
        with pytest.raises(RuntimeError, match="cuda"):
            serve.main(["--arch", arch, "--reduced"])
    cache = api.make_cache(cfg, 2, 16, device="cpu")
    assert isinstance(cache, cache_cls)
    assert all(t.device.type == "cpu" for t in cache)


def test_package_data_ships_every_kernel_source():
    """An installed package must carry every file the kernels build from:
    the `.cu` sources and the shared `.cuh` headers they include."""
    import fnmatch
    import tomllib

    from repro_torch.kernels import _build

    data = tomllib.loads((ROOT / "pyproject.toml").read_text())
    globs = data["tool"]["setuptools"]["package-data"]["repro_torch"]
    port = ROOT / "src" / "repro_torch"
    csrc = sorted(p.relative_to(port).as_posix()
                  for p in (port / "kernels" / "csrc").iterdir())
    assert any(c.endswith(".cuh") for c in csrc)
    for rel in csrc:
        assert any(fnmatch.fnmatch(rel, g) for g in globs), rel
    assert {f"kernels/csrc/{n}.cu" for n in _build.SOURCES} <= set(csrc)
