"""pytest settings of the benchmark's own tests (``perfbench/tests``):
the repo's root and ``src`` on the path, and the ``card`` marker for tests
that need a CUDA card, which skip without one (decided in the ``card``
fixture, never while a module is imported).

    python -m pytest -q perfbench/tests             # the CPU tests
    python -m pytest -q -m card perfbench/tests     # on the card
"""
import sys
from pathlib import Path

import pytest

ROOT = Path(__file__).resolve().parent.parent
for p in (str(ROOT / "src"), str(ROOT)):
    if p not in sys.path:
        sys.path.insert(0, p)


def pytest_configure(config):
    config.addinivalue_line(
        "markers", "card: needs a CUDA card; skips without one")


@pytest.fixture
def card():
    import torch
    if not torch.cuda.is_available():
        pytest.skip("no CUDA card: this test runs on the card")
    return torch.device("cuda")
