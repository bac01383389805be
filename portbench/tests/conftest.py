"""The benchmark's own tests: ``python -m pytest portbench/tests`` on the
CPU; the tests marked ``card`` run on a machine with an NVIDIA card (they
skip elsewhere, deciding inside the `card` fixture)."""

import pytest


def pytest_configure(config):
    config.addinivalue_line(
        "markers", "card: needs an NVIDIA card (skips without one)")


@pytest.fixture
def card():
    import torch
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA card: torch.cuda.is_available() is "
                    "False")
