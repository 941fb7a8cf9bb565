"""gitbench's own tests (CPU), run as `python -m pytest gitbench/tests -q`;
those marked `card` run the benchmark on a CUDA card and skip without one
(decided inside each test)."""

import pytest
import torch


def pytest_configure(config):
    config.addinivalue_line("markers", "card: needs a CUDA card (skips without one)")


@pytest.fixture(autouse=True)
def _few_threads():
    n = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(n)
