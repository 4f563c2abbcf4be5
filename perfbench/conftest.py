"""pytest settings of the benchmark's own tests (``perfbench/tests``):
the ``card`` marker, and the fixture that decides, inside a test, whether
a CUDA card is there."""

import pytest


def pytest_configure(config):
    config.addinivalue_line("markers", "card: needs a CUDA card; skipped without one")


@pytest.fixture
def card():
    """The card's device name; skips the test where there is none."""
    import torch

    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    return "cuda:0"
