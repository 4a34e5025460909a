import pytest


def pytest_configure(config):
    config.addinivalue_line(
        "markers",
        "slow: multi-minute tests (multi-device subprocess parity, heavy "
        "survey/kernel matrices) — deselected by default via addopts, run "
        "by the dedicated CI slow job with `-m slow`")
    config.addinivalue_line(
        "markers",
        "cuda: needs an NVIDIA card (a CUDA kernel has no CPU mode); skips "
        "inside the test body without one — run on the card with "
        "`python -m pytest -q -m cuda tests/test_torch_cuda.py`")
