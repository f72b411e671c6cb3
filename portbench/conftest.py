"""Test settings of the benchmark's own tests (``python -m pytest
portbench/tests``): the repository root and ``src`` on the path, and the
``card`` marker for tests that need a CUDA device. Whether there is one
is decided inside the ``card`` fixture, never while a module is
imported."""
import gc
import pathlib
import sys

import pytest

ROOT = pathlib.Path(__file__).resolve().parents[1]
for p in (ROOT, ROOT / "src"):
    if str(p) not in sys.path:
        sys.path.insert(0, str(p))


def pytest_configure(config):
    config.addinivalue_line(
        "markers", "card: needs a CUDA device (run on the card: python -m "
                   "pytest portbench/tests -m card)")


@pytest.fixture
def card():
    """Skips the test without a CUDA device; gives "cuda" with the card's
    memory freed of what earlier tests left (a cell at its own size
    takes most of it)."""
    import torch
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (the card)")
    gc.collect()
    torch.cuda.empty_cache()
    yield "cuda"
    gc.collect()
    torch.cuda.empty_cache()
