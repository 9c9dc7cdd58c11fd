"""The benchmark's own tests (``python -m pytest stereo_bench/tests``).

Tests marked ``card`` need a CUDA card; the ``card`` fixture decides, when
a test runs, whether there is one, and skips the test where there is none.
"""

import pytest
import torch

# a few intra-op threads a process: with several test workers on one host,
# more threads than cores slow every worker many times over
torch.set_num_threads(2)


def pytest_configure(config):
    config.addinivalue_line("markers", "card: needs a CUDA card (skips without one)")


@pytest.fixture
def card():
    if not torch.cuda.is_available():
        pytest.skip("no CUDA card: runs on the H100")
    return torch.device("cuda", 0)
