"""The benchmark's own tests: CPU rehearsals of its cells at a tiny size
with the port's plain twins, and (marked `card`) what only the card runs.

    python -m pytest vio_bench/tests -q
"""

import os
import sys

import pytest

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.dirname(os.path.abspath(__file__)))))


def pytest_configure(config):
    config.addinivalue_line("markers", "card: needs an NVIDIA card (skips where there is none)")


@pytest.fixture
def card():
    import torch
    if not torch.cuda.is_available():
        pytest.skip("no CUDA device: the benchmark's window runs on the card only")


@pytest.fixture(autouse=True)
def native_cpu_convolutions():
    """oneDNN picks its convolution on a process's first calls in a way that
    moves the CPU's round-off from one process to the next (a blur's ulp
    then moves ~65 of 768 keypoints across the grid top-k, in about half
    of the processes); PyTorch's own convolution rounds the same every
    time, so the port and the reference are compared on it."""
    import torch
    enabled = torch.backends.mkldnn.enabled
    torch.backends.mkldnn.enabled = False
    yield
    torch.backends.mkldnn.enabled = enabled

