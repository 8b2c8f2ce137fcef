"""Parity of the port's PTR solves (BZ layer, MonkhorstPack, the K1+K2
path and the generic batched path) with the JAX package."""
import math

import numpy as np
import pytest
import torch

import jax.numpy as jnp

import __graft_entry__
import autobzcore_tpu as J
from autobzcore_tpu.models import tight_binding as jtb
from autobzcore_tpu.models.observables import dos_integrand as jdos_integrand

import autobzcore_torch as T
from autobzcore_torch.interop import bz_from_arrays, series_from_arrays
from autobzcore_torch.models import tight_binding as ttb
from autobzcore_torch.models.observables import dos_integrand as tdos_integrand
from autobzcore_torch.ops.symptr import symptr_rule
from autobzcore_torch.parameters import MixedParameters, NullParameters, merge_parameters

torch.set_num_threads(2)

KINDS = ("FBZ", "InversionSymIBZ", "CubicSymIBZ")


def _bzs(kind, d):
    return (J.load_bz(getattr(J, kind)(), np.eye(d)), T.load_bz(getattr(T, kind)(), np.eye(d)))


@pytest.mark.parametrize("d", [2, 3])
@pytest.mark.parametrize("kind", KINDS)
def test_integral_of_one_is_the_zone_volume(kind, d):
    _, bz = _bzs(kind, d)
    sol = T.solve(T.IntegralProblem(lambda x, p: torch.ones((), dtype=torch.float64), bz), T.PTR(npt=7))
    assert abs(float(sol.u) - (2 * math.pi) ** d) <= 1e-12 * (2 * math.pi) ** d


@pytest.mark.parametrize("case", [
    ("flagship", "FBZ", 8), ("tb_integer3", "CubicSymIBZ", 10),
    ("tb_integer3", "InversionSymIBZ", 7), ("tb_graphene", "FBZ", 9),
])
@pytest.mark.parametrize("block", [False, True], ids=["scalar_omega", "omega_block"])
def test_dos_solve_matches_reference(case, block):
    model, kind, npt = case
    js = {"flagship": lambda: __graft_entry__._flagship_series(jnp.complex128),
          "tb_integer3": lambda: jtb.tb_integer(3), "tb_graphene": jtb.tb_graphene}[model]()
    ts = series_from_arrays(np.asarray(js.c), js.offset, js.period, js.sndim)
    jbz, tbz = _bzs(kind, js.sndim)
    om = np.linspace(-2.0, 2.0, 5) if block else 0.45
    want = J.solve(J.IntegralProblem(jdos_integrand(js, 0.2), jbz, jnp.asarray(om)), J.PTR(npt=npt))
    got = T.solve(T.IntegralProblem(tdos_integrand(ts, 0.2), tbz, om), T.PTR(npt=npt))
    u = got.u.numpy()
    assert u.shape == np.shape(want.u)
    assert np.max(np.abs(u - np.asarray(want.u)) / np.abs(np.asarray(want.u))) <= 1e-10
    assert got.numevals == want.numevals
    assert got.retcode is True and want.retcode


@pytest.mark.parametrize("npt", [6, 11])
@pytest.mark.parametrize("kind", KINDS)
def test_numevals_counts_rule_points(kind, npt):
    _, bz = _bzs(kind, 3)
    sol = T.solve(T.IntegralProblem(tdos_integrand(ttb.tb_integer(3), 0.3), bz, 0.1), T.PTR(npt=npt))
    want = npt**3 if bz.is_full else len(symptr_rule(npt, 3, bz.syms)[0])
    assert sol.numevals == want


def test_generic_fourier_integrand_matches_reference():
    """A user kernel other than dos_trace takes the vmapped path."""
    def kernel(hv, om):
        return hv.s[0, 0].real * om + hv.x[0]

    js = jtb.synthetic_wannier(2, nr=3)
    ts = series_from_arrays(np.asarray(js.c), js.offset, js.period, js.sndim)
    jbz, tbz = _bzs("CubicSymIBZ", 3)
    want = J.solve(J.IntegralProblem(J.FourierIntegrand(kernel, js, rep=J.TrivialRep()), jbz, 1.5),
                   J.PTR(npt=6))
    got = T.solve(T.IntegralProblem(T.FourierIntegrand(kernel, ts, rep=T.TrivialRep()), tbz, 1.5),
                  T.PTR(npt=6))
    assert abs(float(got.u) - float(want.u)) <= 1e-12 * abs(float(want.u))
    assert got.numevals == want.numevals


def test_unknown_rep_array_result_recomputes_on_full_zone():
    """An array-valued integrand without a declared rep on an IBZ warns and
    re-solves on the full zone, as the reference does."""
    def kernel(hv, om):
        return torch.stack([hv.s[0, 0].real, hv.s[0, 0].real * om])

    ts = ttb.tb_integer(3)
    bz_ibz, bz_fbz = T.load_bz(T.CubicSymIBZ(), np.eye(3)), T.load_bz(T.FBZ(), np.eye(3))
    with pytest.warns(UserWarning, match="full BZ"):
        got = T.solve(T.IntegralProblem(T.FourierIntegrand(kernel, ts), bz_ibz, 0.5), T.PTR(npt=6))
    want = T.solve(T.IntegralProblem(T.FourierIntegrand(kernel, ts), bz_fbz, 0.5), T.PTR(npt=6))
    assert torch.allclose(got.u, want.u, rtol=0, atol=1e-12)
    assert got.numevals == 6**3


def test_lattice_rep_symmetrizes_like_reference():
    rng = np.random.default_rng(5)
    x = rng.normal(size=(3, 3))
    jbz, tbz = _bzs("CubicSymIBZ", 3)
    want = np.asarray(J.LatticeRep().symmetrize(jbz, jnp.asarray(x)))
    got = T.LatticeRep().symmetrize(tbz, torch.as_tensor(x)).numpy()
    np.testing.assert_allclose(got, want, rtol=0, atol=1e-12)


def test_bz_from_arrays_matches_load_bz():
    for kind in KINDS:
        jbz, tbz = _bzs(kind, 3)
        got = bz_from_arrays(jbz.A, jbz.B, jbz.syms)
        assert got.nsyms == tbz.nsyms and type(got.lims) is type(tbz.lims)
        assert got.lims == tbz.lims


def test_parameter_merge_algebra_matches_reference():
    cases = [(NullParameters(), 1.0), (MixedParameters(1, a=2), MixedParameters(3, a=4, b=5)),
             (MixedParameters(1), {"eta": 0.1}), (2.0, (3.0, 4.0)), (MixedParameters(a=1), NullParameters())]
    for p, q in cases:
        got = merge_parameters(p, q)
        jp = J.MixedParameters(*p.args, **p.kwargs) if isinstance(p, MixedParameters) else (
            J.NullParameters() if isinstance(p, NullParameters) else p)
        jq = J.MixedParameters(*q.args, **q.kwargs) if isinstance(q, MixedParameters) else (
            J.NullParameters() if isinstance(q, NullParameters) else q)
        want = J.parameters.merge_parameters(jp, jq)
        assert got.args == want.args and got.kwargs == want.kwargs


def test_integral_solver_functor_and_resolve():
    ts = ttb.tb_integer(2)
    bz = T.load_bz(T.FBZ(), np.eye(2))
    solver = T.IntegralSolver(tdos_integrand(ts, 0.2), bz, T.PTR(npt=12))
    a, b = solver(0.3), solver(-0.7)
    for om, val in ((0.3, a), (-0.7, b)):
        want = T.solve(T.IntegralProblem(tdos_integrand(ts, 0.2), bz, om), T.PTR(npt=12)).u
        assert float(val) == float(want)


def test_unported_zone_kinds_raise():
    class IBZ:
        pass

    with pytest.raises(NotImplementedError, match="A8"):
        T.load_bz(IBZ(), np.eye(3))


@pytest.mark.parametrize("wrapper", ["plain", "batch", "inplace"])
def test_integrand_wrappers_match_reference(wrapper):
    """The generic batched path: pointwise (vmapped), BatchIntegrand and
    InplaceIntegrand give the reference's PTR value of a smooth integrand."""
    def f_np(x, p, xp):
        return xp.cos(2 * math.pi * x[..., 0]) ** 2 + p * x[..., 1] * x[..., 2]

    def build(pkg, xp):
        if wrapper == "batch":
            return pkg.BatchIntegrand(lambda xs, p: f_np(xs, p, xp))
        if wrapper == "inplace":
            proto = xp.zeros(2)

            def fill(y, x, p):
                return y + xp.stack([f_np(x, p, xp), 2 * f_np(x, p, xp)])

            return pkg.InplaceIntegrand(fill, proto)
        return lambda x, p: f_np(x, p, xp)

    jbz, tbz = _bzs("FBZ", 3)
    want = J.solve(J.IntegralProblem(build(J, jnp), jbz, 0.7), J.PTR(npt=5))
    got = T.solve(T.IntegralProblem(build(T, torch), tbz, 0.7), T.PTR(npt=5))
    np.testing.assert_allclose(np.asarray(got.u), np.asarray(want.u), rtol=1e-12, atol=0)
    assert got.numevals == want.numevals == 125


def test_tree_helpers_match_reference():
    from autobzcore_tpu.utils import tree as jt
    from autobzcore_torch.utils import tree as tt

    rng = np.random.default_rng(2)
    a = (rng.normal(size=3), {"x": rng.normal(size=(4, 2))})
    b = (rng.normal(size=3), {"x": rng.normal(size=(4, 2))})
    w = rng.random(4)
    ja, jb = jax_tree(a), jax_tree(b)
    ta, tb = torch_tree(a), torch_tree(b)
    for jfn, tfn in ((jt.tree_add, tt.tree_add), (jt.tree_sub, tt.tree_sub)):
        np.testing.assert_allclose(tt.tree_leaves(tfn(ta, tb))[1].numpy(),
                                   np.asarray(jfn(ja, jb)[1]["x"]), rtol=1e-15)
    np.testing.assert_allclose(tt.tree_scale(2.5, ta)[0].numpy(), np.asarray(jt.tree_scale(2.5, ja)[0]))
    np.testing.assert_allclose(
        tt.tree_weighted_sum(torch.as_tensor(w), ta[1])["x"].numpy(),
        np.asarray(jt.tree_weighted_sum(jnp.asarray(w), ja[1])["x"]), rtol=1e-14)
    assert abs(float(tt.tree_norm(ta)) - float(jt.tree_norm(ja))) <= 1e-14 * float(jt.tree_norm(ja))


def jax_tree(t):
    return (jnp.asarray(t[0]), {"x": jnp.asarray(t[1]["x"])})


def torch_tree(t):
    return (torch.as_tensor(t[0]), {"x": torch.as_tensor(t[1]["x"])})


def test_solve_fn_and_unwrap_integrand():
    """The sweep-form solve function returns the solve's value, certificate
    and count; unwrap_integrand evaluates a batch integrand pointwise."""
    from autobzcore_torch.wrappers import unwrap_integrand

    prob = T.IntegralProblem(tdos_integrand(ttb.tb_integer(3), 0.2), T.load_bz(T.CubicSymIBZ(), np.eye(3)))
    cache = T.init(prob, T.PTR(npt=8))
    u, resid, conv, ne = cache.alg.solve_fn(cache.cacheval)(merge_parameters(cache.p, 0.4), None, None)
    want = T.solve(T.IntegralProblem(prob.f, prob.dom, 0.4), T.PTR(npt=8))
    assert float(u) == float(want.u) and conv and ne == want.numevals and resid == 0.0
    g = unwrap_integrand(T.BatchIntegrand(lambda xs, p: xs.sum(-1) * p))
    assert float(g(torch.tensor([1.0, 2.0], dtype=torch.float64), 3.0)) == 9.0
