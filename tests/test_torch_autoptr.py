"""Parity of the port's AutoPTR family (``algorithms.ptr.AutoSymPTRJL``,
``brillouin.AutoPTR`` and ``AutoPTR_IAI``, ``sweep_solve``'s batched
ladder) with the JAX package on the CPU: every reference case of the family
(``tests/test_brillouin.py``, ``tests/test_interface.py``,
``tests/test_fourier.py``, ``tests/test_parallel.py``) run through both
packages on the same inputs, the synthetic models crossed by
``interop.series_from_arrays``.

Tolerances: values within 1e-12 of their scale (the same rules, sums in
another order); ``numevals``, retcodes, residual flags and the rungs
exactly; every physical identity at the reference test's own tolerance.
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import autobzcore_torch as T
import autobzcore_tpu as J
from autobzcore_torch.interop import series_from_arrays
from autobzcore_torch.models import observables as tobs
from autobzcore_torch.models import tight_binding as ttb
from autobzcore_torch.parallel.sweep import SweepSolver, sweep_solve
from autobzcore_tpu.models import observables as jobs
from autobzcore_tpu.models import tight_binding as jtb
from autobzcore_tpu.parallel.sweep import SweepSolver as JSweepSolver
from autobzcore_tpu.parallel.sweep import sweep_solve as jsweep_solve

torch.set_num_threads(2)
REL = 1e-12
A, B, P = 0.0, 2 * np.pi, 3.0


def _close(got, want, rel=REL, scale=None):
    got, want = np.asarray(got, dtype=np.complex128), np.asarray(want, dtype=np.complex128)
    assert got.shape == want.shape
    scale = max(float(np.max(np.abs(want))) if scale is None else scale, 1e-300)
    assert float(np.max(np.abs(got - want))) <= rel * scale, (got, want)


def _same_solution(got, want, rel=REL, scale=None):
    _close(got.u, want.u, rel, scale)
    assert got.numevals == want.numevals and bool(got.retcode) == bool(want.retcode)


def _bzs(kind, d):
    return J.load_bz(getattr(J, kind)(), np.eye(d)), T.load_bz(getattr(T, kind)(), np.eye(d))


def _cross(hj):
    """The JAX package's series as the port's, by its arrays."""
    return series_from_arrays(np.asarray(hj.c), hj.offset, hj.period, hj.sndim, device="cpu")


@pytest.mark.parametrize("kwargs,ladder", [
    (dict(nmax=90), [50, 60, 70, 80, 90]),
    (dict(a=0.5, nmin=10, nmax=60), [12, 32, 52, 60]),
    (dict(nmax=70, keepmost=4), [50, 60, 70]),
    (dict(a=0.1, nmin=100, nmax=500), [100, 200, 300, 400, 500]),
    (dict(a=3.0, n0=2.0, nmin=1, nmax=9, dn=0.5), [1, 2, 3, 4, 5, 6, 7, 8, 9]),
])
def test_npt_ladder_matches_reference(kwargs, ladder):
    assert T.AutoSymPTRJL(device="cpu", **kwargs).npt_ladder() == ladder
    assert J.AutoSymPTRJL(**kwargs).npt_ladder() == ladder


@pytest.mark.parametrize("kind", ["InversionSymIBZ", "FBZ"])
def test_autoptr_lattice_rep_transport_matches_reference(kind):
    """The reference's in-loop symmetrization case: the LatticeRep transport
    integrand under AutoPTR converges on the symmetrized iterate, on both
    zones, with the reference's rungs and counts."""
    bzj, bzt = _bzs(kind, 2)
    fi = tobs.transport_integrand(ttb.tb_integer(2, device="cpu"), eta=0.5)
    fj = jobs.transport_integrand(jtb.tb_integer(2), eta=0.5)
    got = T.IntegralSolver(T.IntegralProblem(fi, bzt), T.AutoPTR(nmin=20, nmax=200, device="cpu"),
                           abstol=1e-8).solve_p(T.MixedParameters(om=0.4))
    want = J.IntegralSolver(J.IntegralProblem(fj, bzj), J.AutoPTR(nmin=20, nmax=200),
                            abstol=1e-8).solve_p(J.MixedParameters(om=0.4))
    assert got.retcode
    _same_solution(got, want)
    assert got.u.shape == (2, 2)


def test_autoptr_ibz_equals_fbz():
    _, bzi = _bzs("InversionSymIBZ", 2)
    _, bzf = _bzs("FBZ", 2)
    fi = tobs.transport_integrand(ttb.tb_integer(2, device="cpu"), eta=0.5)
    alg = T.AutoPTR(nmin=20, nmax=200, device="cpu")
    ui = T.IntegralSolver(T.IntegralProblem(fi, bzi), alg, abstol=1e-8).solve_p(T.MixedParameters(om=0.4))
    uf = T.IntegralSolver(T.IntegralProblem(fi, bzf), alg, abstol=1e-8).solve_p(T.MixedParameters(om=0.4))
    assert ui.retcode and uf.retcode
    np.testing.assert_allclose(ui.u.numpy(), uf.u.numpy(), atol=1e-8)


def test_autoptr_keepmost_window_matches_reference():
    bzj, bzt = _bzs("InversionSymIBZ", 2)
    fi = tobs.dos_integrand(ttb.tb_integer(2, device="cpu"), eta=0.5)
    fj = jobs.dos_integrand(jtb.tb_integer(2), eta=0.5)
    sols = {}
    for k in (2, 3):
        got = T.IntegralSolver(T.IntegralProblem(fi, bzt), T.AutoPTR(nmin=20, nmax=200, keepmost=k, device="cpu"),
                               abstol=1e-6).solve_p(T.MixedParameters(om=0.3))
        want = J.IntegralSolver(J.IntegralProblem(fj, bzj), J.AutoPTR(nmin=20, nmax=200, keepmost=k),
                                abstol=1e-6).solve_p(J.MixedParameters(om=0.3))
        _same_solution(got, want)
        sols[k] = got
    assert sols[2].retcode and sols[3].retcode
    assert float(sols[2].u) == pytest.approx(float(sols[3].u), abs=1e-6)
    assert sols[3].numevals >= sols[2].numevals


@pytest.mark.parametrize("seed", [3, 7])
def test_bz_algorithms_agree_2d(seed):
    """The reference's four-algorithm agreement on a generic complex
    Hermitian model, and AutoPTR against the reference's solve."""
    hj = jtb.synthetic_wannier(2, nr=3, ndim=2, seed=seed)
    bzj, bzt = _bzs("FBZ", 2)
    fi = tobs.dos_integrand(_cross(hj), eta=0.8)
    vals = {name: float(T.solve(T.IntegralProblem(fi, bzt, 0.3), alg, abstol=1e-5).u)
            for name, alg in [("IAI", T.IAI(device="cpu")), ("TAI", T.TAI(device="cpu")),
                              ("PTR", T.PTR(device="cpu")), ("AutoPTR", T.AutoPTR(device="cpu"))]}
    ref = vals["PTR"]
    assert ref > 0
    for name, v in vals.items():
        assert v == pytest.approx(ref, abs=5e-5), (name, vals)
    got = T.solve(T.IntegralProblem(fi, bzt, 0.3), T.AutoPTR(device="cpu"), abstol=1e-5)
    want = J.solve(J.IntegralProblem(jobs.dos_integrand(hj, eta=0.8), bzj, 0.3), J.AutoPTR(), abstol=1e-5)
    _same_solution(got, want)


@pytest.mark.parametrize("kind", ["FBZ", "InversionSymIBZ"])
def test_unit_measure_matches_reference(kind):
    """The integral of 1 over the 3-D zone under AutoPTR is (2 pi)^3, with
    the reference's rungs."""
    bzj, bzt = _bzs(kind, 3)
    got = T.solve(T.IntegralProblem(lambda x, p: torch.ones(()), bzt), T.AutoPTR(device="cpu"))
    want = J.solve(J.IntegralProblem(lambda x, p: jnp.asarray(1.0), bzj), J.AutoPTR())
    assert float(got.u) == pytest.approx((2 * np.pi) ** 3, rel=1e-6)
    _same_solution(got, want)


@pytest.mark.parametrize("dims", [1, 2, 3])
@pytest.mark.parametrize("kind", ["FBZ", "InversionSymIBZ"])
@pytest.mark.parametrize("counter", [False, True])
def test_fourier_unit_measure_matches_reference(dims, kind, counter):
    """The reference's FourierIntegrand unit measure under AutoPTR (and
    EvalCounter(AutoPTR)): the value, the count and the retcode."""
    bzj, bzt = _bzs(kind, dims)
    st = T.FourierSeries(ttb.integer_lattice(dims), period=1.0, offset=(-1,) * dims, device="cpu")
    sj = J.FourierSeries(jtb.integer_lattice(dims), period=1.0, offset=(-1,) * dims)

    def ft(v, a, b=None):
        return torch.real(a * v.s) + b

    def fj(v, a, b=None):
        return jnp.real(a * v.s) + b

    at, aj = T.AutoPTR(device="cpu"), J.AutoPTR()
    if counter:
        at, aj = T.EvalCounter(at), J.EvalCounter(aj)
    got = T.IntegralSolver(T.IntegralProblem(T.FourierIntegrand(ft, st, 0.0, b=1.0), bzt), at, reltol=0,
                           abstol=1e-6).solve_p(T.MixedParameters())
    want = J.IntegralSolver(J.IntegralProblem(J.FourierIntegrand(fj, sj, 0.0, b=1.0), bzj), aj, reltol=0,
                            abstol=1e-6).solve_p(J.MixedParameters())
    assert float(got.u) == pytest.approx((2 * np.pi) ** dims, abs=1e-5)
    _same_solution(got, want)


@pytest.mark.parametrize("name", ["PTR_IAI", "AutoPTR_IAI"])
def test_ptr_iai_and_autoptr_iai_match_reference(name):
    """The reference's test_ptr_iai: the unit measure on the inversion wedge
    at reltol 1e-4, both phases counted."""
    bzj, bzt = _bzs("InversionSymIBZ", 2)
    est = T.PTR(device="cpu") if name == "PTR_IAI" else T.AutoPTR(device="cpu")
    got = T.solve(T.IntegralProblem(lambda x, p: torch.ones(()), bzt),
                  getattr(T, name)(ptr=est, iai=T.IAI(device="cpu")), reltol=1e-4)
    want = J.solve(J.IntegralProblem(lambda x, p: jnp.asarray(1.0), bzj), getattr(J, name)(), reltol=1e-4)
    assert float(got.u) == pytest.approx((2 * np.pi) ** 2, rel=1e-4)
    _same_solution(got, want)


CASES = [
    (lambda x, p: p * jnp.sum(jnp.sin(x)), lambda x, p: p * torch.sum(torch.sin(x)), lambda d: 0.0),
    (lambda x, p: p * jnp.ones(()), lambda x, p: p * torch.ones(()), lambda d: P * (B - A) ** d),
    (lambda x, p: jnp.prod(1.0 / (p - jnp.cos(x))), lambda x, p: torch.prod(1.0 / (p - torch.cos(x))),
     lambda d: ((B - A) / np.sqrt(P**2 - 1)) ** d),
]


@pytest.mark.parametrize("dim", [1, 2, 3])
@pytest.mark.parametrize("fi", range(3))
def test_autosymptr_on_a_plain_basis_matches_reference(dim, fi):
    """The reference's TestCubature.test_ptr: AutoSymPTRJL on a Basis, with
    no series and no zone (the rule on ``device``)."""
    jf, tf, ref = CASES[fi]
    got = T.solve(T.IntegralProblem(tf, T.Basis(B * np.eye(dim)), P), T.AutoSymPTRJL(device="cpu"), abstol=1e-5)
    want = J.solve(J.IntegralProblem(jf, J.Basis(B * np.eye(dim)), P), J.AutoSymPTRJL(), abstol=1e-5)
    assert float(got.u) == pytest.approx(ref(dim), abs=1e-3)
    _same_solution(got, want, scale=max(abs(ref(dim)), P))


@pytest.mark.parametrize("wrapper", ["inplace", "batch"])
@pytest.mark.parametrize("fi", range(3))
def test_autosymptr_takes_the_integrand_wrappers(wrapper, fi):
    """The reference's TestInplace and TestBatch cases under
    AutoSymPTRJL(nmin=100) on a 1-D Basis."""
    jf, tf, ref = CASES[fi]
    if wrapper == "inplace":
        ft = T.InplaceIntegrand(lambda y, x, p: y + tf(x, p).reshape(1), torch.zeros(1))
        fj = J.InplaceIntegrand(lambda y, x, p: y.at[0].set(jf(x, p)), jnp.zeros(1))
    else:
        ft = T.BatchIntegrand(lambda xs, p: torch.stack([tf(x, p) for x in xs]))
        fj = J.BatchIntegrand(lambda xs, p: jnp.stack([jf(x, p) for x in xs]))
    got = T.solve(T.IntegralProblem(ft, T.Basis(np.array([[B]])), P), T.AutoSymPTRJL(nmin=100, device="cpu"),
                  abstol=1e-5)
    want = J.solve(J.IntegralProblem(fj, J.Basis(np.array([[B]])), P), J.AutoSymPTRJL(nmin=100), abstol=1e-5)
    assert float(np.real(np.ravel(got.u.numpy())[0])) == pytest.approx(ref(1), abs=1e-4)
    _same_solution(got, want, scale=max(abs(ref(1)), P))


def test_sweep_autoptr_ladder_matches_reference():
    """The reference's batched ladder over 21 omegas: per-lane values,
    residuals, flags and counts as the reference's, and the values as
    PTR(160)'s."""
    bzj, bzt = _bzs("InversionSymIBZ", 2)
    fi = tobs.dos_integrand(ttb.tb_integer(2, device="cpu"), eta=0.5)
    fj = jobs.dos_integrand(jtb.tb_integer(2), eta=0.5)
    om = np.linspace(-5.0, 5.0, 21)
    us, errs, convs, nes = sweep_solve(T.IntegralProblem(fi, bzt), T.AutoPTR(nmin=20, nmax=160, device="cpu"),
                                       T.MixedParameters(om), abstol=1e-6)
    ju, je, jc, jn = jsweep_solve(J.IntegralProblem(fj, bzj), J.AutoPTR(nmin=20, nmax=160), J.MixedParameters(om),
                                  abstol=1e-6)
    assert us.shape == (21,) and float(np.max(errs)) <= 1e-6
    assert convs.all() and nes.min() > 0
    _close(us.numpy(), np.asarray(ju))
    # residuals are differences of rungs: they agree to the values' rounding
    np.testing.assert_allclose(errs, np.asarray(je), rtol=0, atol=REL * float(np.max(np.abs(np.asarray(ju)))))
    assert np.array_equal(convs, np.asarray(jc)) and np.array_equal(nes, np.asarray(jn))
    ref, *_ = sweep_solve(T.IntegralProblem(fi, bzt), T.PTR(npt=160, device="cpu"), T.MixedParameters(om))
    np.testing.assert_allclose(us.numpy(), ref.numpy(), atol=1e-8)


def test_sweep_autoptr_per_lane_certificates_match_reference():
    """A smooth and a van Hove lane: per-lane flags differ, the smooth lane
    stops earlier, and each lane equals the scalar AutoPTR solve (count,
    flag, value) in both packages."""
    bzj, bzt = _bzs("InversionSymIBZ", 2)
    fi = tobs.dos_integrand(ttb.tb_integer(2, device="cpu"), eta=0.05)
    fj = jobs.dos_integrand(jtb.tb_integer(2), eta=0.05)
    om = np.array([-20.0, 0.0])
    us, errs, convs, nes = sweep_solve(T.IntegralProblem(fi, bzt), T.AutoPTR(nmin=20, nmax=400, device="cpu"),
                                       T.MixedParameters(om), abstol=1e-8)
    ju, _, jc, jn = jsweep_solve(J.IntegralProblem(fj, bzj), J.AutoPTR(nmin=20, nmax=400), J.MixedParameters(om),
                                 abstol=1e-8)
    assert convs[0] and not convs[1] and nes[0] < nes[1]
    assert np.array_equal(convs, np.asarray(jc)) and np.array_equal(nes, np.asarray(jn))
    _close(us.numpy(), np.asarray(ju))
    solver = T.IntegralSolver(T.IntegralProblem(fi, bzt), T.AutoPTR(nmin=20, nmax=400, device="cpu"), abstol=1e-8)
    for i, o in enumerate(om):
        ref = solver.solve_p(T.MixedParameters(float(o)))
        assert bool(convs[i]) == bool(ref.retcode) and int(nes[i]) == ref.numevals
        assert float(us[i]) == pytest.approx(float(ref.u), abs=1e-10)


def test_sweep_autoptr_transport_and_batched_lanes():
    """A lane vector through the transport route (K18/K19's plain
    versions) and a batched integrand without a kernel route (the Berry
    flux, one solve a lane) under the batched ladder, each lane as the
    reference's scalar solve."""
    bzj, bzt = _bzs("FBZ", 2)
    om = np.array([-1.0, 0.4, 2.5])
    fi = tobs.transport_integrand(ttb.tb_integer(2, device="cpu"), eta=0.5)
    fj = jobs.transport_integrand(jtb.tb_integer(2), eta=0.5)
    us, _, convs, nes = sweep_solve(T.IntegralProblem(fi, bzt), T.AutoPTR(nmin=20, nmax=100, device="cpu"),
                                    T.MixedParameters(om), abstol=1e-8)
    for i, o in enumerate(om):
        want = J.IntegralSolver(J.IntegralProblem(fj, bzj), J.AutoPTR(nmin=20, nmax=100),
                                abstol=1e-8).solve_p(J.MixedParameters(om=float(o)))
        assert int(nes[i]) == int(want.numevals) and bool(convs[i]) == bool(want.retcode)
        _close(us[i].numpy(), np.asarray(want.u))
    from autobzcore_torch.models import berry as tb
    from autobzcore_tpu.models import berry as jb

    hj = jtb.tb_haldane(t1=1.0, t2=0.1, phi=np.pi / 2, M=0.0)
    mus = np.array([-1.5, 0.0])
    us, _, convs, nes = sweep_solve(T.IntegralProblem(tb.berry_flux_integrand(_cross(hj)), bzt),
                                    T.AutoPTR(nmin=20, nmax=60, device="cpu"), T.MixedParameters(mu=mus),
                                    abstol=1e-6)
    for i, mu in enumerate(mus):
        want = J.IntegralSolver(J.IntegralProblem(jb.berry_flux_integrand(hj), bzj), J.AutoPTR(nmin=20, nmax=60),
                                abstol=1e-6)(mu=float(mu))
        solj = J.solve(J.IntegralProblem(jb.berry_flux_integrand(hj), bzj, J.MixedParameters(mu=float(mu))),
                       J.AutoPTR(nmin=20, nmax=60), abstol=1e-6)
        assert int(nes[i]) == int(solj.numevals) and bool(convs[i]) == bool(solj.retcode)
        _close(us[i].numpy(), np.asarray(want), scale=1.0)


def test_sweepsolver_refuses_autoptr_in_both_packages():
    """The reference's SweepSolver has no AutoPTR form (its BZ layer finds no
    consts form and AutoSymPTRJL has no solve_fn); the port says so and
    names sweep_solve."""
    bzj, bzt = _bzs("FBZ", 2)
    with pytest.raises(AttributeError):
        JSweepSolver(J.IntegralProblem(jobs.dos_integrand(jtb.tb_integer(2), eta=0.5), bzj),
                     J.AutoPTR(nmin=20, nmax=60), abstol=1e-6, chunk=4)
    for alg in (T.AutoPTR(nmin=20, nmax=60, device="cpu"), T.AutoSymPTRJL(device="cpu"),
                T.EvalCounter(T.AutoPTR(device="cpu"))):
        with pytest.raises(TypeError, match="sweep_solve"):
            SweepSolver(T.IntegralProblem(tobs.dos_integrand(ttb.tb_integer(2, device="cpu"), eta=0.5), bzt), alg,
                        abstol=1e-6, chunk=4)


def test_autoptr_caches_rules_across_solves():
    """One IntegralSolver keeps each rung's rule: a second solve builds none
    and gives the same count as a fresh solver."""
    _, bzt = _bzs("FBZ", 2)
    fi = tobs.dos_integrand(ttb.tb_integer(2, device="cpu"), eta=0.5)
    solver = T.IntegralSolver(T.IntegralProblem(fi, bzt), T.AutoPTR(nmin=20, nmax=80, device="cpu"), abstol=1e-7)
    first = solver.solve_p(T.MixedParameters(0.3))
    rules = solver.cache.cacheval["inner"]["rules"]
    built = dict(rules)
    second = solver.solve_p(T.MixedParameters(-0.7))
    assert all(rules[k] is built[k] for k in built)
    fresh = T.solve(T.IntegralProblem(fi, bzt, T.MixedParameters(-0.7)), T.AutoPTR(nmin=20, nmax=80, device="cpu"),
                    abstol=1e-7)
    _same_solution(second, fresh)
    assert first.retcode and second.retcode
