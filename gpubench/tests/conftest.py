"""The benchmark's own tests: ``python -m pytest gpubench/tests -q`` from the
repository's root. Tests that need a CUDA device carry the ``card`` marker
and take the ``card`` fixture, which skips them where there is none."""

import sys
from pathlib import Path

import pytest

ROOT = Path(__file__).resolve().parents[2]
if str(ROOT) not in sys.path:
    sys.path.insert(0, str(ROOT))


def pytest_configure(config):
    config.addinivalue_line("markers", "card: needs a CUDA device (an NVIDIA H100); "
                                       "skipped where there is none")


@pytest.fixture
def card():
    """The CUDA device, or a skip where there is none."""
    import torch

    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    return torch.device("cuda", 0)
