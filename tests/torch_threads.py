"""The torch thread count of the port's CPU tests, set in one place: each
``tests/test_torch_*.py`` that runs on the CPU imports ``_threads`` from
here. Under xdist several workers share the machine's cores, so every port
file of a worker runs with two torch threads, whatever the worker ran
before; a single process keeps torch's own count."""
import os

import pytest
import torch


@pytest.fixture(scope="module", autouse=True)
def _threads():
    if os.environ.get("PYTEST_XDIST_WORKER"):
        torch.set_num_threads(min(2, os.cpu_count() or 1))
