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


ERROR_KINDS = ("random", "cold_inf", "noise_floor", "ties", "quiet")


def dyadic_pool(rng, cap, segs, nsplit, kind):
    """One warm-start pool as numpy arrays (a, b, e, n): the segments of
    ``segs`` bisected ``nsplit`` times at random, in shuffled slots, with a
    few dead (zero-width) slots among the live ones and junk past ``n``.
    ``kind`` sets the errors: log-uniform, +inf (cold seeds), one constant
    (errors floored at evaluation noise), a few repeated values (ties), or
    all tiny but a few (cap pressure)."""
    ivs = [(segs[i], segs[i + 1]) for i in range(len(segs) - 1)]
    for _ in range(nsplit):
        a, b = ivs.pop(int(rng.integers(len(ivs))))
        ivs += [(a, (a + b) / 2), ((a + b) / 2, b)]
    ivs += [(0.0, 0.0)] * int(rng.integers(0, 3))
    ivs = [ivs[i] for i in rng.permutation(len(ivs))]
    n = len(ivs)
    assert n + 3 <= cap
    a, b, e = np.zeros(cap), np.zeros(cap), np.zeros(cap)
    a[:n], b[:n] = zip(*ivs)
    e[:n] = {"random": lambda: 10 ** rng.uniform(-12, -3, n), "cold_inf": lambda: np.full(n, np.inf),
             "noise_floor": lambda: np.full(n, 1e-8),
             "ties": lambda: rng.choice([1e-12, 1e-9, 1e-7], n),
             "quiet": lambda: np.where(rng.random(n) < 0.1, 1e-4, 1e-13)}[kind]()
    a[n:n + 3], b[n:n + 3], e[n:n + 3] = 0.7, 0.9, 1.0  # junk past the live slots
    return a, b, e, n


def dyadic_pools(rng, L, cap, segs, device):
    """L pools of :func:`dyadic_pool`, the error kinds in turn, each bisected
    between 3 and cap/2 times, stacked as tensors on ``device``: a, b, e
    (L, cap) float64 and n (L,) int64."""
    rows = [dyadic_pool(rng, cap, segs, int(rng.integers(3, cap // 2)), ERROR_KINDS[i % len(ERROR_KINDS)])
            for i in range(L)]
    a, b, e = (torch.as_tensor(np.stack([r[k] for r in rows]), device=device) for k in range(3))
    return a, b, e, torch.as_tensor([r[3] for r in rows], dtype=torch.int64, device=device)


def rel_err(got, want):
    got, want = np.asarray(got), np.asarray(want)
    return float(np.max(np.abs(got - want)) / np.max(np.abs(want)))
