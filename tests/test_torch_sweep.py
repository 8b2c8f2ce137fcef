"""Parity of the port's sweeps (``SweepSolver`` under ``hchebinterp``, and
``sweep_solve``) with the JAX package: the same panels, the same
``numevals`` and the same values."""
import numpy as np
import pytest
import torch

import jax.numpy as jnp

import __graft_entry__
import autobzcore_tpu as J
from autobzcore_tpu.models import tight_binding as jtb
from autobzcore_tpu.models.observables import dos_integrand as jdos_integrand
from autobzcore_tpu.parallel.sweep import SweepSolver as JSweepSolver
from autobzcore_tpu.parallel.sweep import sweep_solve as jsweep_solve
from autobzcore_tpu.utils.chebinterp import hchebinterp as jhchebinterp

import autobzcore_torch as T
from autobzcore_torch.interop import series_from_arrays
from autobzcore_torch.models.observables import dos_integrand as tdos_integrand
from autobzcore_torch.models.tight_binding import tb_integer
from autobzcore_torch.parallel.sweep import SweepSolver, sweep_solve
from autobzcore_torch.utils.chebinterp import hchebinterp

torch.set_num_threads(2)

ETA = 0.2


def _pair(model, kind):
    js = (__graft_entry__._flagship_series(jnp.complex128) if model == "flagship"
          else jtb.tb_integer(3))
    ts = series_from_arrays(np.asarray(js.c), js.offset, js.period, js.sndim, device="cpu")
    jprob = J.IntegralProblem(jdos_integrand(js, ETA), J.load_bz(getattr(J, kind)(), np.eye(3)))
    tprob = T.IntegralProblem(tdos_integrand(ts, ETA), T.load_bz(getattr(T, kind)(), np.eye(3)))
    return jprob, tprob


@pytest.mark.parametrize("model,kind,window", [
    ("flagship", "FBZ", (-6.0, 7.0)), ("tb_integer3", "CubicSymIBZ", (-6.5, 6.5)),
])
def test_hchebinterp_sweep_matches_reference(model, kind, window):
    jprob, tprob = _pair(model, kind)
    jsweep = JSweepSolver(jprob, J.PTR(npt=12), chunk=64)
    want = jhchebinterp(jsweep, *window, atol=1e-2)
    tsweep = SweepSolver(tprob, T.PTR(npt=12, device="cpu"), chunk=64)
    got = hchebinterp(tsweep, *window, atol=1e-2)
    assert len(got.panels) == len(want.panels)
    assert [(p.a, p.b) for p in got.panels] == [(p.a, p.b) for p in want.panels]
    assert got.numevals == want.numevals
    assert tsweep.numevals == jsweep.numevals
    assert tsweep.retcode is True and jsweep.retcode
    ws = np.linspace(*window, 301)
    assert np.max(np.abs(got(ws) - want(ws)) / np.max(np.abs(want(ws)))) <= 1e-10


def test_sweep_counts_real_lanes_only():
    _, tprob = _pair("tb_integer3", "CubicSymIBZ")
    sweep = SweepSolver(tprob, T.PTR(npt=8, device="cpu"), chunk=16)
    xs = np.linspace(-3, 3, 21)  # two chunks, the second padded
    got = sweep(xs)
    K = sweep.numevals // 21
    assert sweep.numevals == 21 * K and got.shape == (21,)
    one = [float(T.solve(T.IntegralProblem(tprob.f, tprob.dom, x), T.PTR(npt=8, device="cpu")).u) for x in xs[:3]]
    np.testing.assert_allclose(got[:3], one, rtol=1e-13, atol=0)
    assert sweep(np.zeros(0)).shape == (0,)


def test_sweep_solve_matches_reference():
    jprob, tprob = _pair("flagship", "FBZ")
    oms = np.linspace(-4, 5, 9)
    ju, _, jconv, jne = jsweep_solve(jprob, J.PTR(npt=6), J.MixedParameters(jnp.asarray(oms)))
    tu, _, tconv, tne = sweep_solve(tprob, T.PTR(npt=6, device="cpu"), T.MixedParameters(oms))
    assert np.max(np.abs(tu.numpy() - np.asarray(ju)) / np.abs(np.asarray(ju))) <= 1e-10
    np.testing.assert_array_equal(tconv, np.asarray(jconv))
    np.testing.assert_array_equal(tne, np.asarray(jne))


def test_unknown_rep_array_output_raises_inside_sweep():
    def kernel(hv, om):
        return torch.stack([hv.s[..., 0, 0].real * om, om], dim=-1)

    prob = T.IntegralProblem(T.FourierIntegrand(kernel, tb_integer(3, device="cpu")),
                             T.load_bz(T.CubicSymIBZ(), np.eye(3)))
    sweep = SweepSolver(prob, T.PTR(npt=6, device="cpu"), chunk=4)
    with pytest.raises(ValueError, match="symmetry representation"):
        sweep(np.linspace(0, 1, 4))


@pytest.mark.parametrize("knob,item", [
    ({"group": 2}, "requires scan"), ({"warm": True}, "requires scan"), ({"block": 2}, "requires scan"),
    ({"mesh": object()}, "A10"), ({"warm": True, "scan": True}, "no warm-pool solve form"),
])
def test_unported_sweep_knobs_raise(knob, item):
    """A fixed rule with the knobs of adaptive sweeps: the reference's
    ValueErrors (a PTR has no warm form), and mesh sharding, not ported."""
    jprob, tprob = _pair("tb_integer3", "FBZ")
    if "mesh" in knob:
        with pytest.raises(NotImplementedError, match=item):
            SweepSolver(tprob, T.PTR(npt=4, device="cpu"), **knob)
        return
    with pytest.raises(ValueError, match=item) as want:
        JSweepSolver(jprob, J.PTR(npt=4), **knob)
    with pytest.raises(ValueError, match=item) as got:
        SweepSolver(tprob, T.PTR(npt=4, device="cpu"), **knob)
    assert str(got.value) == str(want.value)


def test_scan_sweep_of_a_fixed_rule_is_the_plain_sweep():
    """``scan`` orders cold solves, which a fixed rule runs as one lane
    vector either way."""
    _, tprob = _pair("tb_integer3", "FBZ")
    xs = np.linspace(-2, 2, 7)
    a = SweepSolver(tprob, T.PTR(npt=5, device="cpu"), chunk=4)(xs)
    b = SweepSolver(tprob, T.PTR(npt=5, device="cpu"), chunk=4, scan=True)(xs)
    np.testing.assert_array_equal(a, b)
