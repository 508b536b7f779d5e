"""The benchmark's own tests: on the CPU, with the port's plain kernel
versions at a small size; the ``gpu``-marked ones need the card and skip
without one (``python -m pytest portbench/tests -m gpu`` there)."""

import pathlib
import sys

import pytest

ROOT = pathlib.Path(__file__).resolve().parents[2]
if str(ROOT) not in sys.path:
    sys.path.insert(0, str(ROOT))


def pytest_configure(config):
    config.addinivalue_line(
        "markers", "gpu: needs a CUDA device; skips without one (run with -m gpu)")


@pytest.fixture
def cuda():
    import torch

    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    return torch.device("cuda")
