"""Settings of the benchmark's own tests: the harness's packages on the
path, the ``cuda`` marker (tests that need a card skip without one), one
torch thread a process."""

import os
import sys

import pytest

GPBENCH = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
ROOT = os.path.dirname(GPBENCH)
for path in (ROOT, GPBENCH):
    if path not in sys.path:
        sys.path.insert(0, path)


def pytest_configure(config):
    config.addinivalue_line(
        "markers", "cuda: needs an NVIDIA GPU; skips where CUDA is absent")


@pytest.fixture(autouse=True)
def one_torch_thread():
    import torch
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


@pytest.fixture
def card():
    """Skip unless a CUDA card is present (decided inside the test)."""
    import torch
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card; this machine has none")
