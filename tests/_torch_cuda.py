"""The marker and fixture of tests that need a CUDA card.

Kept apart from the JAX harness (``test_torch_ref.py``) so that the card's
tests, ``tests/test_torch_cuda.py``, import only torch and the port."""
import pytest
import torch

needs_cuda = pytest.mark.needs_cuda


@pytest.fixture
def cuda():
    """The CUDA device, or a skip where the machine has none."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device; the kernels run only on the card "
                    "(chip_smoke.py checks them there)")
    return torch.device("cuda")
