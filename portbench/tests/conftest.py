"""The benchmark's own tests: ``python -m pytest portbench/tests -q``.

Tests marked ``portbench_card`` need a CUDA device and skip without one;
on the card: ``python -m pytest portbench/tests -q -m portbench_card``.
"""

import pytest
import torch


def pytest_configure(config):
    config.addinivalue_line(
        "markers", "portbench_card: needs a CUDA device; skipped without one")


@pytest.fixture
def card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    return torch.device("cuda")
