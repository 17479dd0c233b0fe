"""The benchmark's own tests: ``python -m pytest benchmark/tests -q`` on the
CPU; the ones marked ``card`` need CUDA devices and skip without them
(decided in the ``card`` fixture, never at import)."""

import os
import sys

import pytest

ROOT = os.path.dirname(os.path.dirname(os.path.dirname(os.path.abspath(__file__))))
if ROOT not in sys.path:
    sys.path.insert(0, ROOT)


def pytest_configure(config):
    config.addinivalue_line("markers", "card: needs CUDA devices (skips without them)")


@pytest.fixture
def card():
    """The number of CUDA devices; skips the test when there is none."""
    import torch

    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    return torch.cuda.device_count()
