"""pytest settings of the benchmark's own tests (``portbench/tests``): the
``card`` marker of tests that need a CUDA card. Such a test takes the
``card`` fixture, which skips it where no card is there."""

import pytest


def pytest_configure(config):
    config.addinivalue_line(
        "markers", "card: needs a CUDA card (skips without one)")


@pytest.fixture
def card():
    import torch
    if not torch.cuda.is_available():
        pytest.skip("no CUDA card in this process")
    return torch.device("cuda", 0)
