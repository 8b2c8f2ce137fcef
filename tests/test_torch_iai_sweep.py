"""Parity of the port's cold ``SweepSolver(scan=True)`` over IAI with the
JAX package's cold scan sweep on the CPU: every frequency one independent
solve, run here as lanes of one batched nest, with the reference's
per-sweep ``numevals`` and retcode."""
import numpy as np
import pytest
import torch

import autobzcore_torch as T
import autobzcore_tpu as J
from autobzcore_torch.models import observables as tobs
from autobzcore_torch.models import tight_binding as ttb
from autobzcore_torch.parallel.sweep import SweepSolver, sweep_solve
from autobzcore_torch.utils.chebinterp import hchebinterp
from autobzcore_tpu.models import tight_binding as jtb
from autobzcore_tpu.models.observables import dos_trace as jdos
from autobzcore_tpu.parallel.sweep import SweepSolver as JSweepSolver
from autobzcore_tpu.utils.chebinterp import hchebinterp as jhchebinterp

torch.set_num_threads(2)

ETA = 0.3


def _probs(kind="FBZ", d=2):
    jprob = J.IntegralProblem(J.FourierIntegrand(jdos, jtb.tb_integer(d), eta=ETA),
                              J.load_bz(getattr(J, kind)(), np.eye(d)))
    tprob = T.IntegralProblem(T.FourierIntegrand(tobs.dos_trace, ttb.tb_integer(d, device="cpu"), eta=ETA),
                              T.load_bz(getattr(T, kind)(), np.eye(d)))
    return jprob, tprob


def _iai_pair():
    return J.IAI(inner_cap=32, inner_nbisect=2), T.IAI(inner_cap=32, inner_nbisect=2, device="cpu")


@pytest.mark.parametrize("kind", ["FBZ", "CubicSymIBZ"])
def test_cold_scan_sweep_matches_reference(kind):
    """4 frequencies in chunks of 3 (the second chunk padded with the last
    value): values, the sweep's numevals and its retcode."""
    jprob, tprob = _probs(kind)
    jalg, talg = _iai_pair()
    xs = np.array([-3.1, -0.6, 0.45, 2.2])
    jsw = JSweepSolver(jprob, jalg, abstol=1e-4, chunk=3, scan=True)
    tsw = SweepSolver(tprob, talg, abstol=1e-4, chunk=3, scan=True)
    want, got = np.asarray(jsw(xs)), tsw(xs)
    assert got.shape == want.shape == (4,)
    assert np.max(np.abs(got - want) / np.abs(want)) <= 1e-10
    assert tsw.numevals == jsw.numevals and tsw.retcode == jsw.retcode is True
    # each frequency's count equals its solve alone, pads count nothing
    alone = [T.solve(T.IntegralProblem(tprob.f, tprob.dom, x), talg, abstol=1e-4) for x in xs]
    assert sum(s.numevals for s in alone) == tsw.numevals
    np.testing.assert_array_equal(got, [float(s.u) for s in alone])
    assert tsw.stats.syncs > 0 and set(tsw.stats.trips) == {1, 2}


def test_sweep_solve_gives_per_lane_certificates():
    _, tprob = _probs()
    _, talg = _iai_pair()
    xs = np.array([-1.0, 0.25, 1.5])
    u, resid, conv, ne = sweep_solve(tprob, talg, T.MixedParameters(xs), abstol=1e-4)
    for i, x in enumerate(xs):
        one = T.solve(T.IntegralProblem(tprob.f, tprob.dom, x), talg, abstol=1e-4)
        assert float(u[i]) == float(one.u) and ne[i] == one.numevals and bool(conv[i]) == one.retcode
        assert float(resid[i]) == float(one.resid)


def test_interpolated_cold_iai_curve_matches_reference():
    """The IAI leg at a small size: hchebinterp over the cold scan sweep,
    with the reference's panels, frequency count and numevals."""
    jprob, tprob = _probs()
    jalg, talg = _iai_pair()
    jsw = JSweepSolver(jprob, jalg, abstol=1e-3, chunk=33, scan=True)
    tsw = SweepSolver(tprob, talg, abstol=1e-3, chunk=33, scan=True)
    want = jhchebinterp(jsw, -4.5, 4.5, atol=1e-2)
    got = hchebinterp(tsw, -4.5, 4.5, atol=1e-2)
    assert [(p.a, p.b) for p in got.panels] == [(p.a, p.b) for p in want.panels]
    assert got.numevals == want.numevals
    assert tsw.numevals == jsw.numevals and tsw.retcode == jsw.retcode is True
    ws = np.linspace(-4.5, 4.5, 101)
    assert np.max(np.abs(got(ws) - np.asarray(want(ws)))) <= 1e-10 * np.max(np.abs(got(ws)))


@pytest.mark.parametrize("knob,item", [(dict(block=3), "omega blocks"), (dict(mesh="m"), "A10")])
def test_unported_iai_sweep_knobs_raise(knob, item):
    _, tprob = _probs()
    with pytest.raises(NotImplementedError, match=item):
        SweepSolver(tprob, _iai_pair()[1], abstol=1e-3, chunk=3, scan=True, **knob)


@pytest.mark.parametrize("knob", [dict(warm=True), dict(group=3)], ids=["warm", "group"])
def test_warm_and_group_iai_sweeps_match_reference(knob):
    """The warm chain, and lockstep groups (which change no per-solve result),
    as the reference's scan sweep: values, numevals and retcode."""
    jprob, tprob = _probs()
    jalg, talg = _iai_pair()
    xs = np.array([-3.1, -0.6, 0.45, 2.2])
    jsw = JSweepSolver(jprob, jalg, abstol=1e-4, chunk=3, scan=True, **knob)
    tsw = SweepSolver(tprob, talg, abstol=1e-4, chunk=3, scan=True, **knob)
    want, got = np.asarray(jsw(xs)), tsw(xs)
    assert np.max(np.abs(got - want) / np.abs(want)) <= 1e-10
    assert tsw.numevals == jsw.numevals and tsw.retcode == jsw.retcode is True
    assert tsw.chunk_evals == jsw.chunk_evals


def test_warm_iai_sweep_refuses_what_the_reference_refuses():
    _, tprob = _probs()
    with pytest.raises(ValueError, match="requires scan=True"):
        SweepSolver(tprob, _iai_pair()[1], chunk=3, warm=True)
    with pytest.raises(ValueError, match="group=1"):
        SweepSolver(tprob, _iai_pair()[1], chunk=3, scan=True, warm=True, group=3)
    with pytest.raises(ValueError, match="no warm-pool solve form"):
        SweepSolver(tprob, T.IAI(precision="guided", device="cpu"), chunk=3, scan=True, warm=True)
