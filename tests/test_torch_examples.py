"""The port's language-model examples run on the CPU at REDUCED size
(each example's own assertions and its closing "OK"):
`examples/torch_serve_lm.py`, `examples/torch_train_lm.py` (the loss
falls below 0.8 of its start; a vocabulary of 64, whose Markov stream a
two-layer model learns in 150 steps) and `examples/torch_distributed_train.py`
(four gloo ranks as (2, 2), then the elastic resume in two as (2, 1)).
"""
import os
import subprocess
import sys

import pytest

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def _run(name, *args, timeout=240):
    # one intra-op thread: the suite runs files side by side, and the
    # distributed example starts six processes
    env = dict(os.environ, PYTHONPATH=os.path.join(ROOT, "src"),
               OMP_NUM_THREADS="1")
    out = subprocess.run([sys.executable, os.path.join(ROOT, "examples",
                                                       name), *args,
                          "--device", "cpu"], env=env, capture_output=True,
                         text=True, timeout=timeout)
    assert out.returncode == 0, out.stdout[-2000:] + out.stderr[-4000:]
    return out.stdout


@pytest.mark.parametrize("arch", ["qwen3-1.7b", "mamba2-130m"])
def test_serve_example(arch):
    out = _run("torch_serve_lm.py", "--arch", arch, "--max-new", "4")
    assert out.count("req[") == 4 and out.rstrip().endswith("OK")


def test_train_example():
    out = _run("torch_train_lm.py", "--steps", "150", "--width", "64",
               "--layers", "2", "--seq-len", "32", "--batch", "8",
               "--vocab", "64")
    assert "loss:" in out and out.rstrip().endswith("OK")


def test_distributed_example():
    out = _run("torch_distributed_train.py", "--steps", "4")
    assert "resumed from checkpoint step 2" in out
    assert "step 3 loss" in out and "dp=2" in out
    assert out.rstrip().endswith("OK — same stream, new mesh, training "
                                 "continued.")
