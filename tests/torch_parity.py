"""Shared pieces of the port's parity tests (tests/test_torch_*.py)."""
import numpy as np
import pytest
import torch


@pytest.fixture
def cuda_device():
    """The first CUDA card; the test skips where there is none."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card (run on the GPU machine)")
    return torch.device("cuda", 0)


def random_hermitian(rng, K, m):
    """K random Hermitian m x m matrices from a numpy generator."""
    a = rng.normal(size=(K, m, m)) + 1j * rng.normal(size=(K, m, m))
    return (a + a.conj().transpose(0, 2, 1)) / 2


def rel_err(got, want):
    got, want = np.asarray(got), np.asarray(want)
    return float(np.max(np.abs(got - want)) / np.max(np.abs(want)))
