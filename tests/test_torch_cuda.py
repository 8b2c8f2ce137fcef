"""The kernel wrappers: what they take and refuse, and on a CUDA card each
kernel against its plain PyTorch version.

This file imports no JAX, so the card tests run where JAX is not installed:

    python -m pytest --noconftest -m gpu tests/test_torch_cuda.py

Without a card the ``gpu`` tests skip.
"""
import numpy as np
import pytest
import torch

import autobzcore_torch as T
from autobzcore_torch.models import observables as tobs
from autobzcore_torch.models import tight_binding as ttb
from autobzcore_torch.ops.fourier_eval import fourier_points, fourier_points_plain
from autobzcore_torch.parallel.sweep import SweepSolver
from torch_parity import cuda_device, random_hermitian, rel_err  # noqa: F401  (cuda_device is a fixture)

torch.set_num_threads(2)


def test_fourier_wrapper_takes_plain_version_on_cpu_without_counting():
    s = ttb.flagship_series()
    X = torch.rand(40, 3, dtype=torch.float64)
    before = fourier_points.launches
    got = fourier_points(s.c, X, s.offset, s.period)
    assert fourier_points.launches == before
    assert torch.equal(got, fourier_points_plain(s.c, X, s.offset, s.period))


def test_fourier_wrapper_rejects_what_the_kernel_does_not_take():
    s = ttb.flagship_series()
    with pytest.raises(ValueError):
        fourier_points(s.c, torch.rand(4, 3, dtype=torch.float32), s.offset, s.period)
    with pytest.raises(ValueError):
        fourier_points(s.c, torch.rand(4, 4, dtype=torch.float64), s.offset, s.period)
    with pytest.raises(ValueError):
        fourier_points(s.c, torch.rand(3, 4, dtype=torch.float64).T, s.offset, s.period)
    with pytest.raises(ValueError):
        fourier_points(s.c.to(torch.complex64), torch.rand(4, 3, dtype=torch.float64),
                       s.offset, s.period)


def test_dos_wrapper_checks_its_inputs():
    H = torch.as_tensor(random_hermitian(np.random.default_rng(0), 8, 3))
    w = torch.ones(8, dtype=torch.float64)
    om = torch.zeros(5, dtype=torch.float64)
    before = tobs.dos_trace_weighted_sum.launches
    tobs.dos_trace_weighted_sum(H, w, om, om + 0.1, 1.0)
    assert tobs.dos_trace_weighted_sum.launches == before  # CPU: plain version, no launch
    with pytest.raises(ValueError):
        tobs.dos_trace_weighted_sum(H.to(torch.complex64), w, om, om + 0.1, 1.0)
    with pytest.raises(ValueError):
        tobs.dos_trace_weighted_sum(H, w[:7], om, om + 0.1, 1.0)
    with pytest.raises(ValueError):
        tobs.dos_trace_weighted_sum(H, w, om, om[:4] + 0.1, 1.0)


@pytest.mark.gpu
@pytest.mark.parametrize("build", [
    lambda dev: ttb.tb_integer(1, device=dev),
    lambda dev: ttb.tb_graphene(device=dev),
    # an 11^3 box of 4x4 values: several coefficient tiles and value passes
    lambda dev: ttb.synthetic_wannier(4, nr=11, seed=3, device=dev),
], ids=["1d", "2d", "3d_m4_nr11"])
def test_fourier_kernel_matches_plain_on_card(cuda_device, build):
    s = build(cuda_device)
    X = torch.rand(5001, s.sndim, dtype=torch.float64, device=cuda_device)  # a ragged last block
    before = fourier_points.launches
    got = fourier_points(s.c, X, s.offset, s.period)
    assert fourier_points.launches == before + 1
    want = fourier_points_plain(s.c, X, s.offset, s.period)
    assert float((got - want).abs().max() / want.abs().max()) <= 1e-12


@pytest.mark.gpu
@pytest.mark.parametrize("m", [1, 2, 3])
def test_dos_kernel_matches_plain_on_card(cuda_device, m):
    rng = np.random.default_rng(m)
    K = 10_000  # several k-chunks of the kernel
    H = torch.as_tensor(random_hermitian(rng, K, m), device=cuda_device)
    w = torch.as_tensor(rng.random(K) + 0.5, device=cuda_device)
    om = torch.linspace(-3, 3, 45, dtype=torch.float64, device=cuda_device)  # a ragged lane tile
    eta = torch.full_like(om, 0.05)
    before = tobs.dos_trace_weighted_sum.launches
    got = tobs.dos_trace_weighted_sum(H, w, om, eta, 0.5)
    assert tobs.dos_trace_weighted_sum.launches == before + 1
    want = tobs.dos_trace_weighted_sum_plain(H, w, om, eta, 0.5)
    assert float((got - want).abs().max() / want.abs().max()) <= 1e-10
    assert torch.equal(got, tobs.dos_trace_weighted_sum(H, w, om, eta, 0.5))


@pytest.mark.gpu
def test_dos_kernel_refuses_more_than_three_bands(cuda_device):
    H = torch.as_tensor(random_hermitian(np.random.default_rng(0), 8, 4), device=cuda_device)
    w = torch.ones(8, dtype=torch.float64, device=cuda_device)
    om = torch.zeros(3, dtype=torch.float64, device=cuda_device)
    with pytest.raises(NotImplementedError, match="B2"):
        tobs.dos_trace_weighted_sum(H, w, om, om + 0.1, 1.0)


@pytest.mark.gpu
@pytest.mark.parametrize("kind,model", [("FBZ", ttb.flagship_series),
                                        ("CubicSymIBZ", lambda device: ttb.tb_integer(3, device=device))])
def test_sweep_on_card_matches_cpu(cuda_device, kind, model):
    xs = np.linspace(-6, 7, 100)
    out = []
    for dev in ("cpu", cuda_device):
        prob = T.IntegralProblem(tobs.dos_integrand(model(device=dev), 0.2),
                                 T.load_bz(getattr(T, kind)(), np.eye(3)))
        out.append(SweepSolver(prob, T.PTR(npt=16), chunk=64)(xs))
    assert rel_err(out[1], out[0]) <= 1e-10


@pytest.mark.gpu
def test_kernels_take_edge_shapes(cuda_device):
    s = ttb.flagship_series(device=cuda_device)
    empty = fourier_points(s.c, torch.empty((0, 3), dtype=torch.float64, device=cuda_device),
                           s.offset, s.period)
    assert empty.shape == (0, 3, 3)
    rng = np.random.default_rng(4)
    for K, W in ((0, 5), (4097, 1), (1, 33)):  # no k; one k past a chunk; one k, a lane past a tile
        H = torch.as_tensor(random_hermitian(rng, K, 3), device=cuda_device)
        w = torch.ones(K, dtype=torch.float64, device=cuda_device)
        om = torch.linspace(-1, 1, W, dtype=torch.float64, device=cuda_device)
        eta = torch.full_like(om, 0.1)
        got = tobs.dos_trace_weighted_sum(H, w, om, eta, 1.0)
        want = tobs.dos_trace_weighted_sum_plain(H, w, om, eta, 1.0)
        assert got.shape == (W,)
        assert torch.allclose(got, want, rtol=1e-12, atol=1e-300)
