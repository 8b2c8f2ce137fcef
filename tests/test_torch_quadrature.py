"""Parity of the port's fixed rules (``ops.adaptive.fixed_rule_eval``,
``QuadratureFunction`` alone and as a fixed level of ``NestedQuad``/``IAI``)
and meta-algorithms (``EvalCounter``, ``AbsoluteEstimate``, ``PTR_IAI``)
with the JAX package on the CPU: values within 1e-12 relative (the same
rules, sums in another order), ``numevals`` and retcodes exactly, on the
reference's own interface cases."""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import autobzcore_torch as T
import autobzcore_tpu as J
from autobzcore_torch.models import observables as tobs
from autobzcore_torch.models import tight_binding as ttb
from autobzcore_torch.ops import adaptive as tad
from autobzcore_tpu.models import tight_binding as jtb
from autobzcore_tpu.models.observables import dos_trace as jdos
from autobzcore_tpu.ops import adaptive as jad

torch.set_num_threads(2)
REL = 1e-12
A, B, P = 0.0, 2 * np.pi, 3.0

# the reference's INTEGRANDS_1D (tests/test_interface.py)
CASES_1D = [
    (lambda x, p: p * jnp.sin(x), lambda x, p: p * torch.sin(x)),
    (lambda x, p: p * jnp.ones_like(x), lambda x, p: p * torch.ones_like(x)),
    (lambda x, p: 1.0 / (p - jnp.cos(x)), lambda x, p: 1.0 / (p - torch.cos(x))),
]


def _close(got, want, rel=REL, scale=None):
    """max|got - want| <= rel * scale, the scale max|want| unless given (an
    integral that cancels to 0 takes its integrand's scale)."""
    got, want = np.asarray(got), np.asarray(want)
    assert got.shape == want.shape
    scale = max(float(np.max(np.abs(want))) if scale is None else scale, 1e-300)
    assert float(np.max(np.abs(got - want))) <= rel * scale, (got, want)


def _same_solution(got, want, rel=REL, scale=None):
    _close(np.complex128(np.asarray(got.u)), np.complex128(np.asarray(want.u)), rel, scale)
    assert got.numevals == want.numevals and got.retcode == bool(want.retcode)


@pytest.mark.parametrize("case", range(3))
@pytest.mark.parametrize("rule", ["trapz", "gausslegendre"])
def test_quadrature_function_matches_reference(case, rule):
    jf, tf = CASES_1D[case]
    want = J.solve(J.IntegralProblem(jf, A, B, P), J.QuadratureFunction(getattr(J, rule), npt=200),
                   abstol=1e-5)
    got = T.solve(T.IntegralProblem(tf, A, B, P),
                  T.QuadratureFunction(getattr(T, rule), npt=200, device="cpu"), abstol=1e-5)
    _same_solution(got, want, scale=P * (B - A))  # the integral of sin cancels to 0
    assert got.resid is None and got.retcode is True and got.numevals == 200


@pytest.mark.parametrize("stats", [False, True])
def test_fixed_rule_eval_matches_reference(stats):
    """fixed_rule_eval over three segments, complex two-channel values, with
    per-node counts (the nest's form) or without."""
    segs = np.array([-1.0, 0.3, 0.4, 2.0])
    x, w = T.gausslegendre(7)

    def jf(xs, p):
        v = jnp.stack([jnp.exp(1j * p * xs), xs ** 2 + 0j], -1)
        return (v, jnp.full(xs.shape, 15.0)) if stats else v

    def tf(xs, p):
        v = torch.stack([torch.exp(1j * p * xs), xs ** 2 + 0j], -1)
        return (v, torch.full(xs.shape, 15.0)) if stats else v

    want = jad.fixed_rule_eval(jf, 1.3, jnp.asarray(segs), x, w, stats=stats)
    got = tad.fixed_rule_eval(tf, 1.3, segs, x, w, stats=stats)
    _close(got[0].numpy(), np.asarray(want[0]))
    assert float(got[1]) == float(want[1]) == (3 * 7 * (15 if stats else 1))


def test_eval_counter_counts():
    """The reference's test_eval_counter: 10, 15 and 19 evaluations."""
    prob = T.IntegralProblem(lambda x, p: torch.ones_like(x), 0.0, 1.0)
    for alg, numevals in ((T.QuadratureFunction(npt=10, device="cpu"), 10),
                          (T.QuadGKJL(order=7, device="cpu"), 15),
                          (T.QuadGKJL(order=9, device="cpu"), 19)):
        assert T.solve(prob, T.EvalCounter(alg)).numevals == numevals


def test_absolute_estimate_matches_reference():
    """The reference's test_absolute_estimate (a near-pole integrand, the
    estimate by QuadratureFunction(npt=100), the absolute solve by QuadGKJL)
    and test_absolute_estimate_counts_both_phases (10 + 15 = 25)."""
    def f2j(x, p):
        return 1.0 / (p[0] + 1j * p[1] - jnp.cos(x))

    def f2t(x, p):
        return 1.0 / (p[0] + 1j * p[1] - torch.cos(x))

    want = J.solve(J.IntegralProblem(f2j, 0.0, 2 * np.pi, (0.5, 1e-3)),
                   J.AbsoluteEstimate(J.QuadratureFunction(npt=100), J.QuadGKJL()), reltol=1e-5)
    got = T.solve(T.IntegralProblem(f2t, 0.0, 2 * np.pi, (0.5, 1e-3)),
                  T.AbsoluteEstimate(T.QuadratureFunction(npt=100, device="cpu"),
                                     T.QuadGKJL(device="cpu")), reltol=1e-5)
    _same_solution(got, want)
    alg_j = J.AbsoluteEstimate(J.QuadratureFunction(npt=10), J.QuadGKJL(), abstol=1e-3)
    alg_t = T.AbsoluteEstimate(T.QuadratureFunction(npt=10, device="cpu"), T.QuadGKJL(device="cpu"),
                               abstol=1e-3)
    want = J.solve(J.IntegralProblem(lambda x, p: jnp.sin(p * x), 0.0, 1.0, 0.7), alg_j, abstol=1e-9)
    got = T.solve(T.IntegralProblem(lambda x, p: torch.sin(p * x), 0.0, 1.0, 0.7), alg_t, abstol=1e-9)
    _same_solution(got, want)
    assert got.numevals == 25


def test_nested_quad_mixed_algorithms():
    """The reference's test_nested_quad_mixed_algorithms: a fixed innermost
    rule under an adaptive outer level."""
    dom_j = J.CubicLimits(np.zeros(2), 2 * np.pi * np.ones(2))
    dom_t = T.CubicLimits(np.zeros(2), 2 * np.pi * np.ones(2))
    want = J.solve(J.IntegralProblem(lambda x, p: 1.0 + jnp.sum(jnp.cos(x)), dom_j),
                   J.NestedQuad((J.QuadratureFunction(npt=64), J.AuxQuadGKJL())), abstol=1e-6)
    got = T.solve(T.IntegralProblem(lambda x, p: 1.0 + torch.sum(torch.cos(x)), dom_t),
                  T.NestedQuad((T.QuadratureFunction(npt=64), T.AuxQuadGKJL()), device="cpu"),
                  abstol=1e-6)
    _same_solution(got, want)
    assert abs(float(got.u) - (2 * np.pi) ** 2) < 1e-4


@pytest.mark.parametrize("dim", [1, 2, 3])
def test_nested_fixed_rule_matches_reference(dim):
    """The reference's test_nested_quad with QuadratureFunction(npt=100) at
    every level: 100^dim evaluations, retcode True."""
    dom_j = J.CubicLimits(np.zeros(dim), 2 * np.pi * np.ones(dim))
    dom_t = T.CubicLimits(np.zeros(dim), 2 * np.pi * np.ones(dim))
    want = J.solve(J.IntegralProblem(lambda x, p: 1.0 + p * jnp.sum(jnp.cos(x)), dom_j, 7.0),
                   J.NestedQuad(J.QuadratureFunction(npt=100)), abstol=1e-3)
    got = T.solve(T.IntegralProblem(lambda x, p: 1.0 + p * torch.sum(torch.cos(x)), dom_t, 7.0),
                  T.NestedQuad(T.QuadratureFunction(npt=100), device="cpu"), abstol=1e-3)
    _same_solution(got, want)
    assert got.numevals == 100 ** dim and got.retcode


@pytest.mark.parametrize("kind", ["FBZ", "CubicSymIBZ"])
def test_fixed_outer_iai_matches_reference(kind):
    """The flagship's phase-24 nest at small caps: IAI with a trapezoid rule
    on the outermost coordinate over two adaptive levels, tb_integer(3) at
    eta 0.3, on the full zone and on the cubic wedge (per-lane segments)."""
    algs_j = (J.AuxQuadGKJL(), J.AuxQuadGKJL(), J.QuadratureFunction(J.trapz, npt=9))
    algs_t = (T.AuxQuadGKJL(), T.AuxQuadGKJL(), T.QuadratureFunction(T.trapz, npt=9))
    jfi = J.FourierIntegrand(jdos, jtb.tb_integer(3), eta=0.3)
    tfi = T.FourierIntegrand(tobs.dos_trace, ttb.tb_integer(3, device="cpu"), eta=0.3)
    want = J.solve(J.IntegralProblem(jfi, J.load_bz(getattr(J, kind)(), np.eye(3)), 0.4),
                   J.IAI(algs_j, inner_cap=16, inner_nbisect=2), abstol=1e-3)
    got = T.solve(T.IntegralProblem(tfi, T.load_bz(getattr(T, kind)(), np.eye(3)), 0.4),
                  T.IAI(algs_t, inner_cap=16, inner_nbisect=2, device="cpu"), abstol=1e-3)
    _same_solution(got, want)


def test_fixed_outer_sweep_lanes_and_warm_refusal():
    """A fixed outermost level sweeps as lanes (each lane equal to its solve
    alone), and has no warm form: SweepSolver(warm=True) refuses it, as the
    reference's does, and a warm pool handed to the fixed level raises the
    reference's TypeError."""
    from autobzcore_torch.parallel.sweep import SweepSolver

    algs = (T.AuxQuadGKJL(), T.QuadratureFunction(T.trapz, npt=7))
    th = ttb.tb_integer(2, device="cpu")
    bz = T.load_bz(T.FBZ(), np.eye(2))
    prob = T.IntegralProblem(tobs.dos_integrand(th, 0.3), bz)
    iai = T.IAI(algs, inner_cap=32, device="cpu")
    sw = SweepSolver(prob, iai, abstol=1e-4, chunk=3, scan=True)
    oms = np.array([-1.3, 0.45, 2.2])
    d = sw(oms)
    for om, v, ne in zip(oms, d, sw.lane_numevals):
        s = T.solve(T.IntegralProblem(tobs.dos_integrand(th, 0.3), bz, om), iai, abstol=1e-4)
        assert float(s.u) == v and s.numevals == ne and s.retcode
    with pytest.raises(ValueError, match="warm"):
        SweepSolver(prob, iai, abstol=1e-4, chunk=3, scan=True, warm=True)
    jalgs = (J.AuxQuadGKJL(), J.QuadratureFunction(J.trapz, npt=7))
    from autobzcore_tpu.parallel.sweep import SweepSolver as JSweepSolver

    with pytest.raises(ValueError, match="warm"):
        JSweepSolver(J.IntegralProblem(J.FourierIntegrand(jdos, jtb.tb_integer(2), eta=0.3),
                                       J.load_bz(J.FBZ(), np.eye(2))),
                     J.IAI(jalgs, inner_cap=32), abstol=1e-4, chunk=3, scan=True, warm=True)
    nest = T.NestedQuad(algs, device="cpu")
    cv = nest.init_cacheval(lambda x, p: x[0], T.CubicLimits(np.zeros(2), np.ones(2)), None)
    level, segs = nest._top_level(cv, T.parameters.LaneParams(None), 1e-3)
    with pytest.raises(TypeError, match="adaptive"):
        nest._solve_level(cv, level, segs, 2, 0.0, None, return_state=True)


def test_ptr_iai_matches_reference():
    """The reference's test_ptr_iai for PTR_IAI: the unit measure on the
    inversion wedge at reltol 1e-4, both phases counted."""
    jbz, tbz = J.load_bz(J.InversionSymIBZ(), np.eye(2)), T.load_bz(T.InversionSymIBZ(), np.eye(2))
    want = J.solve(J.IntegralProblem(lambda x, p: jnp.asarray(1.0), jbz), J.PTR_IAI(), reltol=1e-4)
    got = T.solve(T.IntegralProblem(lambda x, p: torch.ones(()), tbz),
                  T.PTR_IAI(T.PTR(device="cpu"), T.IAI(device="cpu")), reltol=1e-4)
    _same_solution(got, want)
    assert abs(float(got.u) - (2 * np.pi) ** 2) <= 1e-4 * (2 * np.pi) ** 2


def test_sweeps_match_reference():
    """Sweeps of the reference's test_evalcounter_sweeps (EvalCounter of
    QuadGKJL: a constant-cost 15), of QuadratureFunction (lanes in one
    call) and of AbsoluteEstimate (each lane's tolerance from its own
    estimate, both phases counted)."""
    from autobzcore_torch.parallel.sweep import sweep_solve
    from autobzcore_tpu.parallel.sweep import sweep_solve as jsweep

    ps = np.linspace(0.5, 1.0, 4)
    cases = [
        (J.EvalCounter(J.QuadGKJL()), T.EvalCounter(T.QuadGKJL(device="cpu")), dict(abstol=1e-10)),
        (J.QuadratureFunction(npt=30), T.QuadratureFunction(npt=30, device="cpu"), dict()),
        (J.AbsoluteEstimate(J.QuadratureFunction(npt=10), J.QuadGKJL()),
         T.AbsoluteEstimate(T.QuadratureFunction(npt=10, device="cpu"), T.QuadGKJL(device="cpu")),
         dict(reltol=1e-8)),
    ]
    for ja, ta, kw in cases:
        ju, _, jconv, jne = jsweep(J.IntegralProblem(lambda x, p: jnp.sin(p * x), 0.0, 1.0), ja,
                                   jnp.asarray(ps), **kw)
        tu, _, tconv, tne = sweep_solve(T.IntegralProblem(lambda x, p: torch.sin(p * x), 0.0, 1.0), ta,
                                        ps, **kw)
        _close(tu.numpy(), np.asarray(ju))
        np.testing.assert_array_equal(tne, np.asarray(jne))
        np.testing.assert_array_equal(tconv, np.asarray(jconv))
    assert tne.min() == 10 + 15
