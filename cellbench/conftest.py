"""pytest settings of the harness's tests (``tests/``). They run on the
CPU at small sizes; those that need a card carry the ``card`` marker and
skip without one:

    python -m pytest cellbench/tests -q              # CPU
    python -m pytest cellbench/tests -q -m card      # on the card
"""

import os
import sys

import pytest

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
if ROOT not in sys.path:
    sys.path.insert(0, ROOT)


def pytest_configure(config):
    config.addinivalue_line(
        "markers", "card: needs a CUDA card; skips without one")


@pytest.fixture
def card():
    """Skip unless a CUDA card is visible (decided when the test runs)."""
    import torch

    if not torch.cuda.is_available():
        pytest.skip("no CUDA card visible")
    return torch.device("cuda", 0)
