"""Parity of the port's full-grid engine (``autobzcore_torch/ops/grid_sweep.py``,
kernels K7 and K8 through their plain versions) and grid evaluation
(``ops/fourier_eval.evaluate_grid``) with a dense FP64 reference and with the
JAX package."""
import math

import numpy as np
import pytest
import torch

import jax.numpy as jnp

import __graft_entry__
from autobzcore_tpu.fourier import FourierSeries as JFourierSeries
from autobzcore_tpu.ops import fourier_eval as jfe
from autobzcore_tpu.ops.grid_sweep import FullGridSpectralSweep as JSweep

from autobzcore_torch.interop import series_from_arrays
from autobzcore_torch.models.tight_binding import flagship_series
from autobzcore_torch.ops import fourier_eval as tfe
from autobzcore_torch.ops import grid_sweep as tgs
from autobzcore_torch.ops.grid_sweep import FullGridSpectralSweep as TSweep
from torch_parity import dense_dos, hermitian_series_arrays

torch.set_num_threads(2)

# the port is native FP64: rungs equal the dense FP64 reference to rounding
DENSE_RTOL = 1e-12
# the JAX engine's own tier against dense FP64 (tests/test_grid_sweep.py:47,
# :98, :113): two-float f32 Lorentzians, Rayleigh eigenvalues for m != 3
JAX_RTOL = {3: 3e-6}
JAX_RTOL_OTHER_M = 2e-5


def _series(C, off):
    return (JFourierSeries(C, period=1.0, offset=off, ndim=3),
            series_from_arrays(C, off, 1.0, 3, device="cpu"))


def _rel(got, want):
    return float(np.max(np.abs(got - want) / np.abs(want)))


def test_evaluate_grid_matches_reference():
    """H on tensor grids, 3-D flagship and a 2-D series with non-unit
    periods, to 1e-12 of max|H|."""
    jc = np.asarray(__graft_entry__._flagship_series(jnp.complex128).c)
    h = flagship_series(device="cpu")
    nodes = [np.arange(6) / 6, np.linspace(0, 1, 5), np.random.default_rng(0).random(7)]
    got = tfe.evaluate_grid(h.c, 3, nodes, h.offset, h.period).numpy()
    want = np.asarray(jfe.evaluate_grid(jnp.asarray(jc), 3, [jnp.asarray(x) for x in nodes],
                                        h.offset, h.period))
    assert got.shape == (6, 5, 7, 3, 3)
    assert np.max(np.abs(got - want)) <= 1e-12 * np.max(np.abs(want))
    rng = np.random.default_rng(1)
    c2 = rng.normal(size=(3, 4, 2)) + 1j * rng.normal(size=(3, 4, 2))
    nodes2 = [rng.random(4) * 2.0, rng.random(3) * 0.5]
    got2 = tfe.evaluate_grid(torch.as_tensor(c2), 2, nodes2, (-1, -2), (2.0, 0.5)).numpy()
    want2 = np.asarray(jfe.evaluate_grid(jnp.asarray(c2), 2, nodes2, (-1, -2), (2.0, 0.5)))
    assert got2.shape == (4, 3, 2)
    assert np.max(np.abs(got2 - want2)) <= 1e-12 * np.max(np.abs(want2))
    with pytest.raises(NotImplementedError, match="A3"):
        tfe.evaluate_grid(h.c, 3, nodes, h.offset, h.period, derivs=(1, 0, 0))


# (m, n, seed, npt, slab, eta, W): m = 3 at npt 8 (whole slabs) and 12
# (slab padding), m = 1, 2, 5 through their tails
RUNGS = [(3, 5, 0, 8, 8, 0.1, 40), (3, 5, 0, 12, 8, 0.1, 40), (1, 3, 13, 8, 4, 0.15, 16),
         (2, 3, 13, 12, 5, 0.15, 16), (5, 3, 13, 8, 4, 0.15, 16)]


@pytest.mark.parametrize("m, n, seed, npt, slab, eta, W", RUNGS)
def test_rung_matches_dense_and_reference(m, n, seed, npt, slab, eta, W):
    C, off = hermitian_series_arrays(seed=seed, n=n, m=m)
    js, ts = _series(C, off)
    omegas = np.linspace(-6.0, 6.0, W)
    got = TSweep(ts, omegas, eta, slab=slab, device="cpu").rung(npt)
    ref = dense_dos(C, off, npt, omegas, eta)
    assert got.shape == (W,) and got.dtype == np.float64
    assert _rel(got, ref) <= DENSE_RTOL
    jax_rung = JSweep(js, omegas, eta, slab=slab, slabs_per_dispatch=2, omega_batch=W // 2).rung(npt)
    tol = JAX_RTOL.get(m, JAX_RTOL_OTHER_M)
    assert np.max(np.abs(got - jax_rung) / np.maximum(np.abs(got), 1e-3)) <= tol


def test_deep_n2_rung():
    """n2 = 49 frequencies along dimension 2 (the reference's deep stage-B
    case): dense FP64 to rounding, the JAX engine within its tier."""
    C, off = hermitian_series_arrays(seed=11, n=3, n2=49)
    js, ts = _series(C, off)
    omegas = np.linspace(-4, 4, 8)
    got = TSweep(ts, omegas, 0.2, slab=4, device="cpu").rung(8)
    assert _rel(got, dense_dos(C, off, 8, omegas, 0.2)) <= DENSE_RTOL
    want = JSweep(js, omegas, 0.2, slab=4, omega_batch=4).rung(8)
    assert _rel(got, want) <= JAX_RTOL[3]


def test_results_depend_on_slab_only_through_summation_order():
    C, off = hermitian_series_arrays(seed=2, n=3)
    _, ts = _series(C, off)
    omegas = np.linspace(-3, 3, 9)
    a = TSweep(ts, omegas, 0.2, slab=3, device="cpu").rung(10)
    b = TSweep(ts, omegas, 0.2, slab=16, device="cpu").rung(10)
    assert _rel(a, b) <= DENSE_RTOL


def test_plain_kernels_switch_and_progress():
    C, off = hermitian_series_arrays(seed=5, n=3)
    _, ts = _series(C, off)
    omegas = np.linspace(-3, 3, 6)
    calls = []
    a = TSweep(ts, omegas, 0.2, slab=2, slabs_per_dispatch=2, device="cpu").rung(
        7, progress=lambda i, n: calls.append((i, n)))
    b = TSweep(ts, omegas, 0.2, slab=2, device="cpu", plain_kernels=True).rung(7)
    assert np.array_equal(a, b)  # on the CPU both are the plain versions
    assert calls == [(2, 4), (4, 4)]


def test_rejects_non_hermitian_series():
    rng = np.random.default_rng(2)
    C = rng.normal(size=(3, 3, 3, 3, 3)) + 1j * rng.normal(size=(3, 3, 3, 3, 3))
    s = series_from_arrays(C, (-1, -1, -1), 1.0, 3, device="cpu")
    with pytest.raises(ValueError, match="Hermitian"):
        TSweep(s, np.linspace(0, 1, 4), 0.1, device="cpu")


def test_rejects_non_3d_or_nonsquare():
    rng = np.random.default_rng(1)
    s2 = series_from_arrays(rng.normal(size=(3, 3, 2, 2)) * (1 + 0j), (-1, -1), 1.0, 2, device="cpu")
    with pytest.raises(ValueError):
        TSweep(s2, np.linspace(0, 1, 4), 0.1, device="cpu")
    s3 = series_from_arrays(rng.normal(size=(3, 3, 3, 2, 3)) * (1 + 0j), (-1, -1, -1), 1.0, 3,
                            device="cpu")
    with pytest.raises(ValueError):
        TSweep(s3, np.linspace(0, 1, 4), 0.1, device="cpu")


def test_omega_batch_rule_and_set_omegas():
    C, off = hermitian_series_arrays(seed=4, n=3)
    js, ts = _series(C, off)
    for ob, W in ((0, 5), (4, 10), (100, 12), (7, 12)):
        t = TSweep(ts, np.linspace(0, 1, W), 0.1, omega_batch=ob, device="cpu")
        assert t.omega_batch == JSweep(js, np.linspace(0, 1, W), 0.1, omega_batch=ob).omega_batch
    assert TSweep(ts, np.linspace(0, 1, 5), 0.1, omega_batch=0, device="cpu").omega_batch == 1
    eng = TSweep(ts, np.linspace(0, 1, 5), 0.3, slab=4, device="cpu")
    new = np.linspace(-2, 2, 5)
    eng.set_omegas(new)
    assert _rel(eng.rung(6), dense_dos(C, off, 6, new, 0.3)) <= DENSE_RTOL
    with pytest.raises(ValueError, match="width"):
        eng.set_omegas(np.linspace(0, 1, 6))


def test_rung_sharded_raises_naming_the_roadmap_item():
    C, off = hermitian_series_arrays(seed=4, n=3)
    eng = TSweep(_series(C, off)[1], np.linspace(0, 1, 4), 0.1, device="cpu")
    with pytest.raises(NotImplementedError, match="A10"):
        eng.rung_sharded(8, mesh=None)


def test_engine_defaults_to_the_card():
    if torch.cuda.is_available():
        pytest.skip("this machine has a card")
    C, off = hermitian_series_arrays(seed=4, n=3)
    with pytest.raises(RuntimeError, match="CUDA"):
        TSweep(_series(C, off)[1], np.linspace(0, 1, 4), 0.1)


@pytest.mark.parametrize("m", [1, 2, 3])
def test_tail_plain_matches_eigvalsh_and_sum(m):
    """K7's plain version: closed-form eigenvalues of the entry planes and
    the weighted Lorentzian sum, against numpy eigvalsh and a direct sum,
    with pad rows (weight 0) and several rows per slab."""
    rng = np.random.default_rng(30 + m)
    S, inner, K2 = 3, 5, 4
    N = K2 * S * inner
    H = rng.normal(size=(N, m, m)) + 1j * rng.normal(size=(N, m, m))
    H = (H + H.conj().swapaxes(1, 2)) / 2
    ent = tgs._entries(m)
    planes = torch.as_tensor(np.stack([H[:, i, j] for i, j in ent]))
    wrow = torch.tensor([1.0, 0.5, 0.0], dtype=torch.float64)
    om = torch.linspace(-3, 3, 11, dtype=torch.float64)
    acc = torch.full((11,), 2.0, dtype=torch.float64)
    tgs.fullgrid_tail(planes, m, wrow, inner, om, 0.2, acc, scale=0.5)
    e = np.linalg.eigvalsh(H)
    w = wrow.numpy()[(np.arange(N) // inner) % S]
    t = om.numpy()[:, None, None] - e[None]
    want = 2.0 + 0.5 * np.sum(w[None, :, None] * 0.2 / (t * t + 0.04), axis=(1, 2))
    assert _rel(acc.numpy(), want) <= DENSE_RTOL
    got_e = tgs.slab_eigvalsh_plain(planes, m).numpy()
    assert np.max(np.abs(got_e - e)) <= 1e-12


def test_lorentzian_sum_plain_matches_bench_sweep():
    """K8's plain version against the bench's dos_sweep formula
    (bench.py:96-99: the mean over k of the band sum, /pi)."""
    rng = np.random.default_rng(3)
    e = rng.normal(size=(5000, 3)) * 2
    om = np.linspace(-4, 4, 300)
    got = tgs.lorentzian_sum(torch.as_tensor(e), None, torch.as_tensor(om), 0.01,
                             scale=1 / (math.pi * e.shape[0])).numpy()
    lor = 0.01 / ((om[:, None, None] - e[None]) ** 2 + 0.01**2) / np.pi
    want = np.mean(np.sum(lor, axis=2), axis=1)
    assert _rel(got, want) <= DENSE_RTOL
    w = rng.random(5000)
    got_w = tgs.lorentzian_sum(torch.as_tensor(e), torch.as_tensor(w), torch.as_tensor(om), 0.01).numpy()
    want_w = np.einsum("k,wkb->w", w, lor * np.pi)
    assert _rel(got_w, want_w) <= DENSE_RTOL
