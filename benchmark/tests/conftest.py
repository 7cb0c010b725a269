"""Fixtures of the benchmark's own tests: torch pinned to one thread, and
the card found inside a fixture.

    python -m pytest benchmark/tests -q      # on the CPU; the card's tests skip
    python -m pytest benchmark/tests -m cuda  # on the card
"""

from __future__ import annotations

import pytest
import torch


@pytest.fixture(autouse=True)
def _one_torch_thread():
    prev = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(prev)


@pytest.fixture
def card():
    """The first CUDA card; skips where there is none."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    return torch.device("cuda", 0)
