"""The benchmark's CPU tests: the port runs its plain PyTorch path on the
CPU (device="cpu") at small sizes; tests marked `cuda` need the card."""
import pytest


@pytest.fixture
def card():
    """Skip unless a CUDA device is present (decided when the test runs)."""
    import torch

    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU")
    return torch.device("cuda")
