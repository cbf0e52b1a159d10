"""The benchmark's own tests: they run on the CPU at tiny sizes; a test marked ``card`` needs a CUDA
device and skips without one (decided when the test runs, never at import)."""

import os
import sys

import pytest

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.dirname(os.path.abspath(__file__)))))


def pytest_configure(config):
    config.addinivalue_line("markers", "card: needs a CUDA device; skips without one")


@pytest.fixture(autouse=True)
def _card_only(request):
    if request.node.get_closest_marker("card") is not None:
        import torch

        if not torch.cuda.is_available():
            pytest.skip("needs a CUDA device (run on the card)")
