"""Fixtures of the harness's tests.  ``card`` decides inside the fixture whether a CUDA
card is present and skips without one; tests that need it carry the ``card`` marker."""

import sys
from pathlib import Path

import pytest

ROOT = Path(__file__).resolve().parents[2]
for p in (ROOT / "src", ROOT):
    if str(p) not in sys.path:
        sys.path.insert(0, str(p))


def pytest_configure(config):
    config.addinivalue_line("markers", "card: needs a CUDA card; skips without one")


@pytest.fixture
def card():
    import torch

    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the cell runs only on the GPU")
    return torch.device("cuda")


@pytest.fixture
def tiny_root(tmp_path):
    from portbench.tests import tiny

    return tiny.make_root(tmp_path)
