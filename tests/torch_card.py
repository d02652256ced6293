"""The ``card`` fixture of the port's card tests (marked ``card``): the
card's device, or a skip where there is none, decided when a test runs,
never at import. A test module takes it with ``from torch_card import
card``."""

import pytest


@pytest.fixture
def card():
    import torch

    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA card (run the card tests on the GPU machine)")
    return "cuda:0"
