"""Parity of the port's full-grid DOS sweeps with the JAX package: the sweep,
engine-cache, interval-domain and ladder-hint cases of the reference's
``tests/test_dos_fullgrid.py`` through both packages (the pointwise cases
are in ``test_torch_dos_fullgrid.py``, with the tolerance reasoning).

Rung sequences, ``numevals``, retcodes, hints and ``hchebinterp`` panels
must be identical; curves agree within 3e-6 relative or the case's
abstol, whichever is larger."""
import numpy as np
import pytest
import torch

from autobzcore_tpu import dos as jdos

from autobzcore_torch import dos as tdos
from torch_dos_parity import algs, close, rungs, setup  # noqa: F401
from torch_parity import dense_dos

torch.set_num_threads(2)


def _caches(setup, domain, alg_pair, **kw):
    (js, jbz), (ts, tbz) = setup["j"], setup["t"]
    ja, ta = alg_pair
    return (jdos.init(jdos.DOSProblem(js, domain, jbz), ja, **kw),
            tdos.init(tdos.DOSProblem(ts, domain, tbz), ta, **kw))


def test_sweep_matches_dense(setup, rungs):
    Es = np.linspace(-4.0, 4.0, 12)
    ja, ta = algs(0.8, nmin=8, nmax=32, slab=4, omega_batch=6)
    jc, tc = _caches(setup, Es, (ja, ta), abstol=3e-4)
    Dj, okj = ja.dos_sweep(jc.cacheval, Es, abstol=3e-4, with_status=True)
    Dt, okt = ta.dos_sweep(tc.cacheval, Es, abstol=3e-4, with_status=True)
    assert okt and okj and rungs["t"] == rungs["j"] == [8, 11, 16, 23]
    close(Dt, Dj, 3e-4)
    assert isinstance(Dt, np.ndarray) and Dt.shape == (12,)
    ref = dense_dos(setup["C"], setup["off"], 23, Es, 0.8) / 23**3
    assert np.max(np.abs(Dt - ref)) <= 1e-12 * np.max(np.abs(ref))
    # the same curve again, through the hint's pair
    assert np.array_equal(Dt, ta.dos_sweep(tc.cacheval, Es, abstol=3e-4))


def test_engine_cache_reuses_one_width(setup, rungs):
    """Grids of one width share one engine and still give their own curves."""
    ja, ta = algs(0.8, nmin=8, nmax=8, slab=4, omega_batch=1)
    jc, tc = _caches(setup, 0.0, (ja, ta), abstol=1e-3)
    for Es in (np.linspace(1.0, 4.0, 5), np.geomspace(1.0, 4.0, 5)):
        Dt = ta.dos_sweep(tc.cacheval, Es, abstol=1.0)
        close(Dt, ja.dos_sweep(jc.cacheval, Es, abstol=1.0), 0.0)
        ref = dense_dos(setup["C"], setup["off"], 8, Es, 0.8) / 8**3
        assert np.max(np.abs(Dt - ref)) <= 1e-12 * np.max(np.abs(ref))
    assert len(tc.cacheval["engines"]) == len(jc.cacheval["engines"]) == 1
    # widths above 8 pad to multiples of 32, sliced off
    Es = np.linspace(0.0, 2.0, 33)
    Dt = ta.dos_sweep(tc.cacheval, Es, abstol=1.0)
    assert Dt.shape == (33,) and (64, 0.8) in tc.cacheval["engines"]
    close(Dt, ja.dos_sweep(jc.cacheval, Es, abstol=1.0), 0.0)
    assert rungs["t"] == rungs["j"]


def test_interval_domain(setup, rungs):
    """The interval domain through hchebinterp: a budget below the first
    rung gives an uncertified interpolant; a certified run gives the
    reference's panels, numevals, error and retcode."""
    (js, jbz), (ts, tbz) = setup["j"], setup["t"]
    ja, ta = algs(0.8, nmin=8, nmax=16, slab=4, omega_batch=1, schedule="geometric")
    st = tdos.solve(tdos.DOSProblem(ts, (0.0, 1.0), tbz), ta, abstol=1e-2, maxiters=8**3 - 1)
    sj = jdos.solve(jdos.DOSProblem(js, (0.0, 1.0), jbz), ja, abstol=1e-2, maxiters=8**3 - 1)
    assert st.retcode is False and sj.retcode is False and not np.isfinite(st.err)
    assert st.numevals == sj.numevals and rungs["t"] == rungs["j"] == []
    sj = jdos.solve(jdos.DOSProblem(js, (0.0, 1.0), jbz), ja, abstol=1e-2)
    st = tdos.solve(tdos.DOSProblem(ts, (0.0, 1.0), tbz), ta, abstol=1e-2)
    assert st.retcode and sj.retcode and st.numevals == sj.numevals and st.err == sj.err
    assert [(p.a, p.b, len(p.coef)) for p in st.u.panels] == [(p.a, p.b, len(p.coef)) for p in sj.u.panels]
    xs = np.linspace(0.0, 1.0, 17)
    close(st.u(xs), sj.u(xs), 1e-2 / 2)
    assert rungs["t"] == rungs["j"] == [8, 11]


def test_ladder_hint_replay(setup, rungs):
    """A converged ladder records its certifying pair; the next sweep at a
    comparable tolerance replays exactly that pair; a much tighter one
    ignores it and climbs from nmin (here cut by a budget of two rungs)."""
    ja, ta = algs(0.8, nmin=8, nmax=32, slab=4, omega_batch=1)
    jc, tc = _caches(setup, 0.0, (ja, ta), abstol=1e-3)
    Es1, Es2 = np.linspace(0.5, 1.5, 5), np.linspace(1.0, 2.0, 5)
    _, okt = ta.dos_sweep(tc.cacheval, Es1, abstol=1e-3, with_status=True)
    _, okj = ja.dos_sweep(jc.cacheval, Es1, abstol=1e-3, with_status=True)
    hint = tc.cacheval["ladder_hint"]
    assert okt and okj and hint == jc.cacheval["ladder_hint"] and hint[:2] == (11, 16)
    for tol, budget in ((1e-3, None), (2e-6, 8**3 + 11**3)):
        del rungs["t"][:], rungs["j"][:]
        Dt, errt, okt, nevt = ta._ladder(tc.cacheval, Es2, tol, None, budget)
        Dj, errj, okj, nevj = ja._ladder(jc.cacheval, Es2, tol, None, budget)
        assert (okt, nevt) == (okj, nevj) and rungs["t"] == rungs["j"]
        close(Dt, Dj, tol)
        if budget is None:
            assert okt and nevt == hint[0] ** 3 + hint[1] ** 3 and rungs["t"] == list(hint[:2])
        else:
            assert not okt and rungs["t"] == [8, 11]  # the stale pair is not replayed


def test_interval_default_tolerance_forwards_abstol():
    seen = []

    class Stub(tdos.DOSAlgorithm):
        def dos_sweep(self, cacheval, Es, abstol=None, with_status=False):
            seen.append(abstol)
            out = np.exp(-np.asarray(Es) ** 2)
            return (out, True) if with_status else out

    sol = tdos.solve(tdos.DOSProblem(None, (0.0, 1.0)), Stub())
    assert sol.retcode
    assert seen and all(a == pytest.approx(0.5e-2) for a in seen)
