"""The benchmark's own tests: ``python -m pytest benchmark/tests -q``.

Tests marked ``cuda`` decide inside the test whether a card is there and
skip without one; on the card they run with ``-m cuda``."""

import pytest
import torch


def pytest_configure(config):
    config.addinivalue_line(
        "markers", "cuda: needs a CUDA card; skips without one")


@pytest.fixture()
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("no CUDA card")
    return torch.device("cuda", 0)
