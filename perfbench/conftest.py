"""pytest settings of the benchmark's own tests (perfbench/tests/).

    python -m pytest perfbench/tests -q            # here: card tests skip
    python -m pytest perfbench/tests -q -m card    # on the card
"""

import pytest
import torch


def pytest_configure(config):
    config.addinivalue_line("markers", "card: needs an NVIDIA card; skipped without CUDA")


@pytest.fixture
def card():
    """The CUDA device, decided when the test runs (never at import)."""
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA card (torch.cuda.is_available() is False)")
    return torch.device("cuda")
