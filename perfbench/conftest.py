"""Test settings of the benchmark's own tests: the ``card`` marker, and a
fixture that skips a card test where there is no CUDA device (decided
when the test runs, never at import)."""

import pathlib
import sys

import pytest

ROOT = pathlib.Path(__file__).resolve().parents[1]
for p in (ROOT, ROOT / "src"):
    if str(p) not in sys.path:
        sys.path.insert(0, str(p))


def pytest_configure(config):
    config.addinivalue_line("markers", "card: needs an NVIDIA card; skips without one")


@pytest.fixture
def card():
    import torch

    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA card (run the card tests on the GPU machine)")
    return "cuda:0"
