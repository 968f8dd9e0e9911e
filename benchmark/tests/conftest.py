"""The ``card`` marker: tests that need a CUDA device. Whether there is one is
decided in the ``card`` fixture, never while a module is imported."""
import pytest


def pytest_configure(config):
    config.addinivalue_line("markers", "card: needs a CUDA device; skips without one")


@pytest.fixture
def card():
    import torch

    if not torch.cuda.is_available():
        pytest.skip("no CUDA device: the TF32 control exists only on the card")
    return torch.device("cuda", 0)
