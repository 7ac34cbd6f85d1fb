"""Pytest settings of the benchmark's own tests (``benchmark/tests``):
the ``card`` marker for tests that need a CUDA card, which skip, with
the reason, where there is none."""

import pytest


def pytest_configure(config):
    config.addinivalue_line(
        "markers", "card: needs a CUDA card; skips without one "
        "(run on the card: python3 -m pytest benchmark/tests -m card)")


@pytest.fixture
def card():
    """The card's device name; skips the test where there is none.
    Decided here, when the test runs, never at import."""
    import torch

    if not torch.cuda.is_available():
        pytest.skip("no CUDA card: torch.cuda.is_available() is false")
    return torch.cuda.get_device_name(0)
