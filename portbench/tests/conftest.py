"""Tests of the benchmark: ``python -m pytest portbench/tests -q``.  The
``gpu``-marked ones decide in a fixture whether there is a card and skip
without one; on the card: ``python3 -m pytest portbench/tests -q -m gpu``."""

import pytest


@pytest.fixture
def card():
    import torch

    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    return torch.device("cuda", 0)
