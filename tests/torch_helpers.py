"""Shared helpers of the port's parity tests (tests/test_torch_*.py)."""
import numpy as np
import pytest
import torch


def t(a, dtype=None):
    """numpy (or jax) array -> CPU torch tensor."""
    return torch.from_numpy(np.array(a)).to(dtype=dtype)


def n(x):
    """torch tensor -> float32 numpy array."""
    return x.detach().float().cpu().numpy()


@pytest.fixture
def cuda():
    """The card, or a skip. Decided inside the test run, never at import."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    return torch.device("cuda")
