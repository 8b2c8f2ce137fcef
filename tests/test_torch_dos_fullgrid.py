"""Parity of the port's DOS family (``autobzcore_torch/dos``: DOSProblem,
init/solve, LorentzianFullGrid and its ladder) with the JAX package: the
pointwise cases of the reference's ``tests/test_dos_fullgrid.py`` through
both packages, the scheduler, and the flagship slice through both. The
sweep, interval and hint cases are in ``test_torch_dos_sweep.py``.

Rung sequences, ``numevals``, retcodes and ladder hints must be identical;
values agree within 3e-6 relative (the JAX engine's two-float tier) or the
case's abstol, whichever is larger. The cases take eta = 0.8 so that the
ladders certify by npt = 32 (each JAX rung compiles for seconds on the CPU),
with every certifying delta at least 2x below abstol and every failing one
at least 2x above, far from the two engines' difference."""
import math

import numpy as np
import pytest
import torch

import __graft_entry__
from autobzcore_tpu import FBZ as JFBZ
from autobzcore_tpu import dos as jdos
from autobzcore_tpu import load_bz as jload_bz
from autobzcore_tpu.dos import fullgrid as jfg

import autobzcore_torch as T
from autobzcore_torch import dos as tdos
from autobzcore_torch.dos import fullgrid as tfg
from autobzcore_torch.interop import series_from_arrays
from autobzcore_torch.models.tight_binding import flagship_series
from autobzcore_torch.ops.grid_sweep import FullGridSpectralSweep as TSweep
from torch_dos_parity import JAX_RTOL, algs, both_series, rungs, same_solution, setup  # noqa: F401
from torch_parity import dense_dos, hermitian_series_arrays

torch.set_num_threads(2)


def _solve_both(setup, domain, jkw, alg_pair, series=None):
    (js, jbz), (ts, tbz) = setup["j"], setup["t"]
    if series is not None:
        js, ts = series
    ja, ta = alg_pair
    jc = jdos.init(jdos.DOSProblem(js, domain, jbz), ja, **jkw)
    tc = tdos.init(tdos.DOSProblem(ts, domain, tbz), ta, **jkw)
    return jc, tc, jdos.solve_(jc), tdos.solve_(tc)


def test_single_energy_converges(setup, rungs):
    jc, tc, sj, st = _solve_both(setup, 0.5, {"abstol": 1e-5},
                                 algs(0.8, nmin=8, nmax=32, slab=4, omega_batch=1, schedule="geometric"))
    same_solution(sj, st, 1e-5)
    assert st.retcode and rungs["t"] == rungs["j"] == [8, 11, 16, 23, 32]
    ref = dense_dos(setup["C"], setup["off"], 32, np.array([0.5]), 0.8)[0] / 32**3
    assert float(st.u) == pytest.approx(ref, rel=1e-12)
    assert tc.cacheval["ladder_hint"] == jc.cacheval["ladder_hint"]
    # a re-solve through the same cache reuses the engine (and the hint)
    st2, sj2 = tdos.solve_(tc), jdos.solve_(jc)
    same_solution(sj2, st2, 1e-5)
    assert float(st2.u) == pytest.approx(float(st.u), abs=1e-12)
    assert len(tc.cacheval["engines"]) == 1
    assert [r["npt"] for r in tc.cacheval["rung_log"]] == rungs["t"]


@pytest.mark.parametrize("abstol, maxiters", [
    (1e-12, 2000),  # truncation after the second rung
    (1e-3, 100),    # budget below the first rung: NaN, no evals
])
def test_budget(setup, rungs, abstol, maxiters):
    _, _, sj, st = _solve_both(setup, 0.5, {"abstol": abstol, "maxiters": maxiters},
                               algs(0.8, nmin=8, nmax=512, slab=4, omega_batch=1))
    assert st.retcode is False and sj.retcode is False
    assert st.numevals == sj.numevals <= maxiters
    assert rungs["t"] == rungs["j"]
    if maxiters < 8**3:
        assert st.numevals == 0 and np.isnan(float(st.u)) and np.isnan(float(sj.u))
    else:
        assert rungs["t"] == [8, 11]
        same_solution(sj, st, 0.0)


def test_rejects_wrong_shape(setup):
    tbz = setup["t"][1]
    alg = tdos.LorentzianFullGrid(0.1, device="cpu")
    s2 = series_from_arrays(np.zeros((3, 3, 3, 2, 3), complex), (-1, -1, -1), 1.0, 3, device="cpu")
    with pytest.raises(ValueError):
        alg.init_cacheval(s2, 0.0, tbz)
    s2d = series_from_arrays(np.zeros((3, 3, 2, 2), complex), (-1, -1), 1.0, 2, device="cpu")
    with pytest.raises(ValueError):
        alg.init_cacheval(s2d, 0.0, tbz)
    with pytest.raises(TypeError):
        alg.init_cacheval(np.zeros((3, 3, 3, 2, 2)), 0.0, tbz)
    with pytest.raises(TypeError):
        alg.init_cacheval(setup["t"][0], 0.0, None)
    with pytest.raises(ValueError, match="schedule"):
        tdos.LorentzianFullGrid(0.1, device="cpu", schedule="fast")


def test_general_m_through_dos_algorithm(setup, rungs):
    C, off = hermitian_series_arrays(seed=21, n=3, m=2)
    _, _, sj, st = _solve_both(setup, 0.5, {"abstol": 2e-4},
                               algs(0.8, nmin=8, nmax=64, slab=4, omega_batch=1), both_series(C, off))
    same_solution(sj, st, 2e-4)
    assert st.retcode and rungs["t"] == rungs["j"] == [8, 11, 16]
    ref = dense_dos(C, off, 16, np.array([0.5]), 0.8)[0] / 16**3
    assert float(st.u) == pytest.approx(ref, rel=1e-12)


def test_next_rung_npt_matches_reference():
    """The reference's scheduler cases, then identical outputs on its
    300-history fuzz and on histories with ties, zeros and rising deltas."""
    f = math.sqrt(2.0)
    cases = [([400, 560, 800, 1120], [3.24e-3, 2.91e-4, 1.13e-5], 1e-5, f, 2000),
             ([50, 71], [1e-3], 1e-5, f, 2000), ([50, 71, 100, 141], [1e-3, 2e-3, 5e-4], 1e-5, f, 2000),
             ([2000], [], 1e-5, f, 2000), ([100, 141, 200, 283], [1e-1, 1e-2, 1e-3], 1e-12, f, 4000),
             ([100, 141, 200], [1e-1, 1e-3], 1e-12, f, 4000), ([400, 560, 800], [4e-3, 1e-3], 1e-5, f, 2000),
             ([50, 100, 150], [1.5e-3, 1e-3], 1e-4, f, 10000), ([400, 600, 800], [4e-3, 1e-3], 1e-7, f, 100000),
             ([8, 11, 16], [0.0, 0.0], 1e-3, f, 64), ([8, 11, 16], [1e-3, 1e-3], 1e-3, f, 64),
             ([8, 11, 16, 23], [1e-2, 1e-4, 1e-3], 0.0, f, 64)]
    for args in cases:
        assert tfg.next_rung_npt(*args) == jfg.next_rung_npt(*args), args
    assert tfg.next_rung_npt(*cases[0]) < 1280
    rng = np.random.default_rng(11)
    for _ in range(300):
        k = rng.integers(1, 7)
        npts = [int(50 * f**j) for j in range(k)]
        deltas = list(10.0 ** rng.uniform(-8, -1, size=max(0, k - 1)))
        tol = 10.0 ** rng.uniform(-9, -2)
        nmax = int(rng.choice([800, 2000, 4000]))
        n = tfg.next_rung_npt(npts, deltas, tol, f, nmax)
        assert n == jfg.next_rung_npt(npts, deltas, tol, f, nmax)
        assert n is None if npts[-1] >= nmax else npts[-1] < n <= nmax
    for npt in (8, 50, 1999, 2000):
        assert tfg._geometric_step(npt, 2000, f) == jfg._geometric_step(npt, 2000, f)


def test_auto_schedule_converges_with_headroom(setup, rungs):
    ja, ta = algs(0.8, nmin=8, nmax=128, slab=4, omega_batch=1)
    _, _, sj, st = _solve_both(setup, 0.5, {"abstol": 1e-4}, (ja, ta))
    same_solution(sj, st, 1e-4)
    assert st.retcode and rungs["t"] == rungs["j"] == [8, 11, 16, 24]
    assert list(ta.npt_ladder()) == list(ja.npt_ladder())
    ref = dense_dos(setup["C"], setup["off"], 24, np.array([0.5]), 0.8)[0] / 24**3
    assert float(st.u) == pytest.approx(ref, rel=1e-12)


def test_cache_rebuilds_when_H_is_reassigned(setup):
    ts, tbz = setup["t"]
    ta = tdos.LorentzianFullGrid(0.3, nmin=8, nmax=8, slab=4, device="cpu")
    cache = tdos.init(tdos.DOSProblem(ts, 0.5, tbz), ta, abstol=1.0)
    first = tdos.solve_(cache)
    C2, off2 = hermitian_series_arrays(seed=12)
    cache.H = series_from_arrays(C2, off2, 1.0, 3, device="cpu")
    assert cache.isfresh
    second = tdos.solve_(cache)
    assert not cache.isfresh and cache.cacheval["h"] is cache.H
    ref = dense_dos(C2, off2, 8, np.array([0.5]), 0.3)[0] / 8**3
    assert float(second.u) == pytest.approx(ref, rel=1e-12) and float(second.u) != float(first.u)
    with pytest.raises(ValueError):
        tdos.init(tdos.DOSProblem(ts, 0.5, tbz), ta, atol=1.0)


def test_flagship_slice_matches_reference(rungs):
    """The slice as a whole: the flagship series on the full zone through
    DOSProblem, init and dos_sweep, nmin 8, nmax 32, 12 omegas, both
    packages."""
    import jax.numpy as jnp

    js = __graft_entry__._flagship_series(jnp.complex128)
    ts = flagship_series(device="cpu")
    Es = np.linspace(-6.0, 7.0, 12)
    ja, ta = algs(0.8, nmin=8, nmax=32, slab=8, omega_batch=12)
    jc = jdos.init(jdos.DOSProblem(js, Es, jload_bz(JFBZ(), np.eye(3))), ja, abstol=5e-4)
    tc = tdos.init(T.DOSProblem(ts, Es, T.load_bz(T.FBZ(), np.eye(3))), ta, abstol=5e-4)
    Dj, okj = ja.dos_sweep(jc.cacheval, Es, abstol=5e-4, with_status=True)
    Dt, okt = ta.dos_sweep(tc.cacheval, Es, abstol=5e-4, with_status=True)
    assert okt and okj and rungs["t"] == rungs["j"] == [8, 11, 16, 23]
    assert tc.cacheval["ladder_hint"] == jc.cacheval["ladder_hint"]
    assert np.max(np.abs(Dt - Dj) / np.abs(Dj)) <= JAX_RTOL
    log = tc.cacheval["rung_log"]
    assert [r["npt"] for r in log] == rungs["t"]
    assert log[0]["delta"] is None and all(r["delta"] >= 0 for r in log[1:])


def test_entry_points_default_to_the_card(setup):
    if torch.cuda.is_available():
        pytest.skip("this machine has a card")
    with pytest.raises(RuntimeError, match="CUDA"):
        tdos.LorentzianFullGrid(0.1)
    with pytest.raises(RuntimeError, match="CUDA"):
        TSweep(setup["t"][0], np.linspace(0, 1, 4), 0.1)
    with pytest.raises(NotImplementedError, match="A10"):
        tdos.solve_(tdos.init(tdos.DOSProblem(setup["t"][0], 0.5, setup["t"][1]),
                              tdos.LorentzianFullGrid(0.3, nmin=8, nmax=8, mesh=object(), device="cpu"),
                              abstol=1.0))
