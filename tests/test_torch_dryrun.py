"""The dry run's language-model half (`repro_torch.launch.dryrun`, port
of `repro.launch.dryrun`): a rank's step traced on ``meta`` tensors over
a `process_group.RecordingGroup` (`launch.mesh.make_rank_view`).

(a) The pure functions equal the reference's, with nothing compiled:
    `with_depth` and `depth_units` for every architecture, `build_rules`'
    FSDP picks (the reference's `needs_fsdp` at the model axis of 16:
    dbrx-132b alone), and the cells: the 16 `long_500k` cells of the
    pure-attention architectures skipped with the reference's records.
(b) The recorder's collectives, by class, counts and bytes, equal what
    four ``gloo`` ranks record running the same step for real on a
    (2, 2) mesh (REDUCED float32; train, prefill and decode), exactly.
(c) The trace's FLOPs (`FlopCounterMode`), argument, output and peak
    bytes on ``meta`` equal the same counters over the same step run for
    real on the CPU, exactly (qwen3-1.7b and qwen3-moe-30b-a3b train,
    qwen3-1.7b decode: no SSD scan, whose ``meta`` route counts kernel
    B2's `kernel_cost` where the CPU runs its plain version), and so do
    the bytes accessed but for the MoE's: on a real device `one_hot`
    checks its indices' range (an `aminmax` and a read back to the host)
    where ``meta`` does not.  The SSD scan's ``meta`` route returns its
    outputs' shapes and records B2's cost; CPU tensors run the plain
    version, uncounted.
(d) `roofline_measure`'s depth-1/2 extrapolation equals the full-depth
    trace (an eager trace counts every layer): FLOPs and collectives
    exactly; the bytes of a decode exactly, of a train step from below,
    since a layer's gradient of its view of a stacked leaf is written
    into a whole stacked-shape buffer (`select_backward`), a term
    quadratic in depth that a linear fit cannot hold.
(e) Three full-width production cells end ``ok`` with every key:
    qwen3-1.7b x train_4k on the single pod, mamba2-130m x long_500k, and
    dbrx-132b x train_4k on the multi-pod mesh with FSDP.
(f) The CLI writes its JSON where --out says (a tmp_path).
"""
import dataclasses
import json
import os

import pytest
import torch

from repro_torch import configs
from repro_torch.configs.base import ShapeConfig
from repro_torch.launch import dryrun
from repro_torch.launch.mesh import make_host_mesh, make_rank_view

import _torch_serve_workers as W

TIMEOUT = 180.0
RECORD_CELLS = [("train/qwen3", "qwen3-1.7b", "train", 32, 4),
                ("train/moe", "qwen3-moe-30b-a3b", "train", 32, 4),
                ("train/mamba2", "mamba2-130m", "train", 32, 4),
                ("prefill/zamba2", "zamba2-2.7b", "prefill", 32, 4),
                ("decode/qwen3", "qwen3-1.7b", "decode", 32, 4),
                ("decode/whisper", "whisper-medium", "decode", 32, 4),
                ("decode/zamba2-seq", "zamba2-2.7b", "decode", 32, 1)]


def _reference_dryrun():
    """`repro.launch.dryrun`, whose import sets XLA_FLAGS to 512 host
    devices: restored at once (as `tests/test_torch_paper.py` does)."""
    before = os.environ.get("XLA_FLAGS")
    from repro.launch import dryrun as jdry
    if before is None:
        os.environ.pop("XLA_FLAGS", None)
    else:
        os.environ["XLA_FLAGS"] = before
    return jdry


@pytest.mark.parametrize("arch", configs.ARCHS)
def test_depth_and_fsdp_picks_equal_reference(arch):
    jdry = _reference_dryrun()
    from repro import configs as jconfigs
    from repro.distributed.sharding import needs_fsdp as jneeds

    cfg, jcfg = configs.get(arch), jconfigs.get(arch)
    assert dryrun.depth_units(cfg) == jdry.depth_units(jcfg)
    for k in (1, 2):
        got, want = dryrun.with_depth(cfg, k), jdry.with_depth(jcfg, k)
        assert (got.num_layers, got.num_decoder_layers) == \
            (want.num_layers, want.num_decoder_layers)
    for mp in (False, True):
        rules = dryrun.build_rules(cfg, make_rank_view(multi_pod=mp), mp)
        assert rules.fsdp == jneeds(jcfg, 16) == (arch == "dbrx-132b")
        assert rules.dp == (("pod", "data") if mp else ("data",))


def test_cells_and_skips_equal_reference():
    jdry = _reference_dryrun()
    skipped = []
    for arch in configs.ARCHS:
        for shape in configs.SHAPES:
            cfg = configs.get(arch)
            if shape == "long_500k" and cfg.family not in ("ssm", "hybrid"):
                for mp in (False, True):
                    got = dryrun.run_cell(arch, shape, mp)
                    assert got == jdry.run_cell(arch, shape, mp)
                    skipped.append(got)
    assert len(skipped) == 16
    assert all(r["status"] == "skipped" for r in skipped)


_recorded = {}


@pytest.fixture(scope="module")
def recorded(tmp_path_factory):
    if not _recorded:
        tmp = tmp_path_factory.mktemp("rec")
        _recorded["ranks"] = W.run_ranks(
            W.recorded_steps, 4, str(tmp / "rdzv"), (2, RECORD_CELLS),
            timeout=TIMEOUT)
    return _recorded["ranks"]


@pytest.mark.parametrize("cell", RECORD_CELLS, ids=[c[0] for c in
                                                    RECORD_CELLS])
def test_recorder_equals_real_ranks(cell, recorded):
    key, name, kind, seq, batch = cell
    cfg = W.f32_reduced(name)
    shape = ShapeConfig("t", seq, batch, kind)
    for rank in (0, 3):
        mesh = make_rank_view((2, 2), ("data", "model"), rank=rank)
        trace, _ = dryrun.lower_cell(cfg, shape, mesh)
        want = recorded[rank][key]
        assert trace.collectives == want, (rank, trace.collectives, want)
    assert want["total_bytes"] > 0


def _one_rank_mesh():
    from repro_torch.distributed.process_group import DataParallel
    return make_host_mesh(group=DataParallel(0, 1, torch.device("cpu"),
                                             "gloo"))


@pytest.mark.parametrize("name,kind", [("qwen3-1.7b", "train"),
                                       ("qwen3-moe-30b-a3b", "train"),
                                       ("qwen3-1.7b", "decode")])
def test_meta_trace_counts_equal_real_run(name, kind):
    from repro_torch.launch import steps
    from repro_torch.optim import AdamWConfig

    cfg = W.f32_reduced(name)
    shape = ShapeConfig("t", 32, 2, kind)
    meta, _ = dryrun.lower_cell(cfg, shape,
                                make_rank_view((1, 1), ("data", "model")))
    mesh = _one_rank_mesh()
    rules = dryrun.build_rules(cfg, mesh, False)
    if kind == "train":
        step = steps.make_train_step(cfg, AdamWConfig(), rules)
        args = W.step_args(cfg, shape, rules, mesh, 0)
    else:
        params, prompt = W.step_args(
            cfg, dataclasses.replace(shape, kind="prefill", seq_len=16),
            rules, mesh, 0)
        tok, cache = steps.make_prefill_step(cfg, 32, rules)(params, prompt)
        step, args = steps.serve_step(cfg, rules), (params, tok, cache)
    real = dryrun.trace_step(step, args, mesh.process_group)
    assert meta.flops == real.flops > 0
    if "moe" not in name:
        assert meta.bytes_accessed == real.bytes_accessed > 0
    assert meta.argument_bytes == real.argument_bytes
    assert meta.output_bytes == real.output_bytes
    assert meta.peak_bytes >= meta.argument_bytes


def test_ssd_meta_route_counts_kernel_cost():
    from repro_torch.kernels import ssd_scan as ssd

    spec = ssd.SSDSpec(seq_len=256, chunk=64, nheads=4, ngroups=1,
                       headdim=16, state=32, dtype=torch.float32)
    args = [torch.empty(s, device="meta") for s in (
        (2, 256, 4, 16), (2, 256, 4), (2, 256, 1, 32), (2, 256, 1, 32),
        (4,))]
    ssd.meta_calls.clear()
    y, h = ssd.ssd_scan(spec, *args)
    assert (y.shape, h.shape) == ((2, 256, 4, 16), (2, 4, 32, 16))
    assert y.device.type == h.device.type == "meta"
    assert ssd.meta_calls == [{**ssd.kernel_cost(spec, 2), "has_h0": False}]
    ssd.meta_calls.clear()
    g = torch.Generator().manual_seed(0)
    cpu = [torch.rand(a.shape, generator=g) for a in args]
    cpu[4] = -cpu[4]
    y, h = ssd.ssd_scan(spec, *cpu)          # the plain version, uncounted
    assert y.device.type == "cpu" and ssd.meta_calls == []
    assert torch.equal(y, ssd.ssd_scan_plain(spec, *cpu)[0])


@pytest.mark.parametrize("name,kind", [("qwen3-1.7b", "train"),
                                       ("mamba2-130m", "train"),
                                       ("zamba2-2.7b", "decode")])
def test_roofline_extrapolation_equals_full_depth(name, kind):
    cfg = W.f32_reduced(name)
    units = 3
    full = dataclasses.replace(dryrun.with_depth(cfg, units))
    assert dryrun.depth_units(full) == units
    shape = ShapeConfig("t", 32, 4, kind)
    mesh = make_rank_view((2, 2), ("data", "model"))
    roof = dryrun.roofline_measure(full, shape, mesh, False)
    trace, _ = dryrun.lower_cell(full, shape, mesh)
    a = dryrun.analyze(trace)
    assert roof["units"] == units
    assert roof["flops"] == a["flops"]
    if kind == "train":
        assert roof["bytes_accessed"] < a["bytes_accessed"]
    else:
        assert roof["bytes_accessed"] == a["bytes_accessed"]
    assert roof["collective_bytes"] == a["collectives"]["total_bytes"]
    assert roof["collectives"] == a["collectives"]["bytes"]


KEYS = {"flops", "bytes_accessed", "collectives", "memory", "fits_h100",
        "attn_q_chunk", "moe_dp_groups", "kind", "devices", "fsdp"}


@pytest.mark.parametrize("arch,shape,mp", [
    ("qwen3-1.7b", "train_4k", False), ("mamba2-130m", "long_500k", False),
    ("dbrx-132b", "train_4k", True)])
def test_full_width_cells_end_ok(arch, shape, mp):
    rec = dryrun.run_cell(arch, shape, mp)
    assert rec["status"] == "ok", rec.get("traceback")
    assert KEYS <= set(rec)
    assert rec["devices"] == (512 if mp else 256)
    assert rec["fsdp"] == (arch == "dbrx-132b")
    assert rec["attn_q_chunk"] == (1024 if shape == "long_500k" else 0)
    assert rec["moe_dp_groups"] == (32 if mp else 16)
    coll = rec["collectives"]
    assert set(coll["bytes"]) == set(dryrun.COLLECTIVE_OPS)
    assert coll["total_bytes"] == sum(coll["bytes"].values()) > 0
    mem = rec["memory"]
    assert mem["peak_bytes"] >= mem["argument_size_in_bytes"] > 0
    assert rec["fits_h100"] == (mem["peak_bytes"] <= dryrun.H100_BYTES)
    assert rec["flops"] > 0 and rec["bytes_accessed"] > 0
    if arch == "mamba2-130m":
        assert rec["kind"] == "serve_step" and rec["ssd_scans"] == 0
    if arch == "dbrx-132b":
        assert coll["counts"]["reduce-scatter"] > 0


def test_cli_writes_its_json_where_asked(tmp_path, monkeypatch):
    monkeypatch.chdir(tmp_path)
    out = tmp_path / "sub" / "dry.json"
    rc = dryrun.main(["--arch", "mamba2-130m", "--shape", "long_500k",
                      "--both-meshes", "--out", str(out)])
    assert rc == 0
    recs = json.loads(out.read_text())
    assert [r["multi_pod"] for r in recs] == [False, True]
    assert all(r["status"] == "ok" for r in recs)
    assert not (tmp_path / "results").exists()
