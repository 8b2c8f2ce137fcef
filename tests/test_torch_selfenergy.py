"""Parity of the port's matrix self-energy family (``models.selfenergy``:
the Sigma carriers, the pointwise integrands, SigmaDOSSolver,
SigmaTransportSolver, certified_sigma_dos and
SigmaKineticCoefficientSolver, through the plain versions of kernels K27
and K28) with the JAX package on the CPU: every case of
``tests/test_selfenergy.py`` on the port, then both packages on the same
numpy-built models with a non-diagonal, causal, frequency-dependent Sigma
crossed by ``interop.sigma_from_arrays``.

Tolerances: values 1e-12 relative to the largest (both packages evaluate
the same closed forms; H comes from another Fourier evaluation, and the
determinant from LU in both), 1e-9 where the reference's own test uses it;
``numevals`` and retcodes identical on every adaptive case; every physical
identity at the reference test's own tolerance."""
import numpy as np
import pytest
import torch

import autobzcore_torch as T
import autobzcore_tpu as J
from autobzcore_torch.interop import series_from_arrays, sigma_from_arrays
from autobzcore_torch.models import observables as tobs
from autobzcore_torch.models import selfenergy as ts
from autobzcore_torch.models import tight_binding as ttb
from autobzcore_torch.parallel.sweep import SweepSolver
from autobzcore_tpu.models import observables as jobs
from autobzcore_tpu.models import selfenergy as js
from autobzcore_tpu.models import tight_binding as jtb

torch.set_num_threads(2)


def rel(got, want):
    got, want = np.asarray(got), np.asarray(want)
    return float(np.max(np.abs(got - want)) / np.max(np.abs(want)))


def const_sigma(val):
    return lambda om: torch.as_tensor(np.asarray(val, dtype=np.complex128))


def bzs(kind, d=2):
    return J.load_bz(getattr(J, kind)(), np.eye(d)), T.load_bz(getattr(T, kind)(), np.eye(d))


def model(name, **kw):
    """The same model in both packages (the port's series from the JAX
    package's numpy fields)."""
    if name == "flagship":
        import jax.numpy as jnp

        import __graft_entry__

        hj = __graft_entry__._flagship_series(jnp.complex128)
    else:
        hj = getattr(jtb, name)(**kw)
    return hj, series_from_arrays(np.asarray(hj.c), hj.offset, hj.period, hj.sndim, device="cpu")


def fermi_liquid(m, n=41, lo=-8.0, hi=8.0):
    """A tabulated causal, orbital-resolved Fermi-liquid self-energy on
    both packages: Sigma(w) = R - i Gamma(w), R real symmetric (diagonal
    0.10 ... -0.05, off-diagonal 0.05), Gamma real symmetric positive
    definite (diagonal eta_i + a_i w^2, off-diagonal 0.02)."""
    w = np.linspace(lo, hi, n)
    R = np.full((m, m), 0.05)
    np.fill_diagonal(R, np.linspace(0.10, -0.05, m))
    eta, a = np.linspace(0.05, 0.11, m), np.linspace(0.02, 0.04, m)
    vals = np.empty((n, m, m), complex)
    for i, x in enumerate(w):
        G = np.full((m, m), 0.02)
        np.fill_diagonal(G, eta + a * x * x)
        vals[i] = R - 1j * G
    Sj = js.SigmaInterpolant(w, vals)
    return Sj, sigma_from_arrays(Sj.omegas, Sj.values_re, Sj.values_im, device="cpu")


# --- the reference's cases on the port ----------------------------------------------------


def test_sigma_interpolant_linear_exact():
    w = np.linspace(-1, 1, 11)
    vals = (2.0 + 3.0j) * w[:, None, None] * np.eye(2)
    S = ts.SigmaInterpolant(w, vals, device="cpu")
    np.testing.assert_allclose(S(0.37).numpy(), (2 + 3j) * 0.37 * np.eye(2), atol=1e-12)
    np.testing.assert_allclose(S(5.0).numpy(), vals[-1], atol=1e-12)
    np.testing.assert_allclose(S(-5.0).numpy(), vals[0], atol=1e-12)


def test_constant_sigma_matches_eta_dos():
    h = ttb.tb_integer(2, device="cpu")
    bz = T.load_bz(T.FBZ(), np.eye(2))
    eta, om = 0.2, 0.3
    ref = float(T.IntegralSolver(T.IntegralProblem(tobs.dos_integrand(h, eta=eta), bz), T.PTR(npt=32, device="cpu"))(om=om))
    fi = ts.dos_integrand_sigma(h, const_sigma(-1j * eta))
    got = float(T.IntegralSolver(T.IntegralProblem(fi, bz), T.PTR(npt=32, device="cpu"))(om=om))
    assert got == pytest.approx(ref, rel=1e-12)


def test_real_shift_translates_dos():
    h = ttb.tb_integer(1, device="cpu")
    bz = T.load_bz(T.FBZ(), np.eye(1))
    eta, delta = 0.15, 0.4
    om = np.linspace(-3, 3, 7)
    s0 = ts.SigmaDOSSolver(h, bz, 64, const_sigma(-1j * eta))
    s1 = ts.SigmaDOSSolver(h, bz, 64, const_sigma(delta - 1j * eta))
    np.testing.assert_allclose(s1(om + delta), s0(om), rtol=1e-10)


def _block_models():
    C1 = np.zeros((3, 1, 1), dtype=complex)
    C1[0, 0, 0] = C1[2, 0, 0] = 0.5
    C2 = np.zeros((3, 1, 1), dtype=complex)
    C2[0, 0, 0] = C2[2, 0, 0] = 1.0
    Cb = np.zeros((3, 2, 2), dtype=complex)
    Cb[:, 0, 0], Cb[:, 1, 1] = C1[:, 0, 0], C2[:, 0, 0]
    return [T.FourierSeries(C, period=1.0, offset=(-1,), ndim=1, device="cpu") for C in (Cb, C1, C2)]


def test_orbital_selective_broadening():
    hb, h1, h2 = _block_models()
    bz = T.load_bz(T.FBZ(), np.eye(1))
    eta1, eta2 = 0.1, 0.3
    om = np.linspace(-2.5, 2.5, 9)
    Db = ts.SigmaDOSSolver(hb, bz, 128, const_sigma(np.diag([-1j * eta1, -1j * eta2])))(om)
    D1 = ts.SigmaDOSSolver(h1, bz, 128, const_sigma(-1j * eta1))(om)
    D2 = ts.SigmaDOSSolver(h2, bz, 128, const_sigma(-1j * eta2))(om)
    np.testing.assert_allclose(Db, D1 + D2, rtol=1e-10)


def _graphene_sigma():
    w = np.linspace(-6, 6, 25)
    vals = np.empty((25, 2, 2), complex)
    for i, x in enumerate(w):
        vals[i] = np.diag([-0.05j - 0.02j * x**2, 0.1 * x - 0.08j])
    return w, vals


def test_grid_engine_matches_adaptive_and_ibz():
    h = ttb.tb_graphene(device="cpu")
    S = ts.SigmaInterpolant(*_graphene_sigma(), device="cpu")
    om = 0.7
    bz = T.load_bz(T.FBZ(), np.eye(2))
    grid = float(ts.SigmaDOSSolver(h, bz, 768, S)([om])[0])
    fi = ts.dos_integrand_sigma(h, S)
    adaptive = float(T.IntegralSolver(T.IntegralProblem(fi, bz), T.IAI(inner_cap=64, device="cpu"), abstol=1e-6)(om=om))
    assert grid == pytest.approx(adaptive, abs=1e-5)
    pat = ttb.integer_lattice(2)
    Cb = np.zeros((3, 3, 2, 2), dtype=complex)
    Cb[:, :, 0, 0] = 2.0 * pat
    Cb[:, :, 1, 1] = 4.0 * pat
    Cb[:, :, 0, 1] = Cb[:, :, 1, 0] = 0.6 * pat
    hsq = T.FourierSeries(Cb, period=1.0, offset=(-1, -1), ndim=2, device="cpu")
    Df = float(ts.SigmaDOSSolver(hsq, T.load_bz(T.FBZ(), np.eye(2)), 96, S)([om])[0])
    Di = float(ts.SigmaDOSSolver(hsq, T.load_bz(T.InversionSymIBZ(), np.eye(2)), 96, S)([om])[0])
    assert Di == pytest.approx(Df, rel=1e-10)


def test_sum_rule():
    h = ttb.tb_graphene(device="cpu")
    bz = T.load_bz(T.FBZ(), np.eye(2))
    om = np.linspace(-40, 40, 4001)
    D = ts.SigmaDOSSolver(h, bz, 24, const_sigma(np.diag([-0.2j, 0.3 - 0.1j])))(om)
    assert np.trapezoid(D, om) == pytest.approx(2 * np.linalg.det(np.asarray(bz.B)), rel=2e-2)


def test_transport_distribution_sigma_reduces_to_eta():
    eta = 0.15
    for h in (ttb.tb_graphene(device="cpu"), ttb.synthetic_wannier(3, nr=3, ndim=2, seed=3, device="cpu")):
        js_ = T.JacobianSeries(h)
        k = torch.as_tensor([0.13, 0.41], dtype=torch.float64)
        hv = T.FourierValue(k, js_(k))
        ref = tobs.transport_distribution(hv, 0.37, eta=eta).numpy()
        got = ts.transport_distribution_sigma(hv, 0.37, Sigma=const_sigma(-1j * eta)).numpy()
        np.testing.assert_allclose(got, ref, rtol=1e-10, atol=1e-12)


def test_inv_small_matches_linalg():
    rng = np.random.default_rng(5)
    for m in (1, 2, 3, 4):
        M = rng.normal(size=(4, m, m)) + 1j * rng.normal(size=(4, m, m))
        np.testing.assert_allclose(tobs._inv_small(torch.as_tensor(M)).numpy(), np.linalg.inv(M), rtol=1e-10)


def test_projected_dos_sums_to_total():
    hb, h1, _ = _block_models()
    bz = T.load_bz(T.FBZ(), np.eye(1))
    S = const_sigma(np.diag([-0.1j, -0.3j]))
    om = np.linspace(-2.5, 2.5, 9)
    P = ts.SigmaDOSSolver(hb, bz, 128, S, project=True)(om)
    D = ts.SigmaDOSSolver(hb, bz, 128, S)(om)
    assert P.shape == (9, 2)
    np.testing.assert_allclose(P.sum(axis=1), D, rtol=1e-12)
    D1 = ts.SigmaDOSSolver(h1, bz, 128, const_sigma(-0.1j))(om)
    np.testing.assert_allclose(P[:, 0], D1, rtol=1e-10)


def test_sigma_transport_solver_matches_eta_engine():
    h = ttb.tb_graphene(device="cpu")
    eta = 0.12
    om = np.linspace(-3, 3, 5)
    for kind in (T.FBZ(), T.InversionSymIBZ()):
        bz = T.load_bz(kind, np.eye(2))
        ref = tobs.TransportSolver(h, bz, 24, eta)(om)
        got = ts.SigmaTransportSolver(h, bz, 24, const_sigma(-1j * eta))(om)
        assert got.shape == ref.shape == (5, 2, 2)
        np.testing.assert_allclose(got, ref, rtol=1e-9, atol=1e-12)


def test_certified_sigma_dos():
    h = ttb.tb_graphene(device="cpu")
    bz = T.load_bz(T.FBZ(), np.eye(2))
    om = np.linspace(-1, 1, 8)
    S = const_sigma(np.diag([-0.3j, -0.4j]))
    res = ts.certified_sigma_dos(h, bz, om, S, abstol=1e-5, nmin=16, nmax=256)
    assert res.retcode and res.resid <= 1e-5
    ref = ts.SigmaDOSSolver(h, bz, 2 * res.npts[-1], S)(om)
    assert np.abs(res.u - ref).max() <= 1e-5


def test_sigma_interpolant_rejects_unsorted_grid():
    with pytest.raises(ValueError, match="ascending"):
        ts.SigmaInterpolant(np.linspace(1, -1, 5), np.zeros((5,), complex), device="cpu")


def test_sigma_kinetic_matches_scalar_eta():
    from autobzcore_torch.models.transport import KineticCoefficientSolver

    h = ttb.tb_graphene(device="cpu")
    bz = T.load_bz(T.InversionSymIBZ(), np.eye(2))
    eta, beta, mu = 0.1, 20.0, 0.4
    Om = [0.0, 0.5]
    for alpha in (0, 1):
        ref = KineticCoefficientSolver(h, bz, 24, eta, beta, alpha=alpha, mu=mu)(Om, abstol=1e-7)
        slv = ts.SigmaKineticCoefficientSolver(h, bz, 24, const_sigma(-1j * eta), beta, alpha=alpha, mu=mu)
        got = slv(Om, abstol=1e-7)
        np.testing.assert_allclose(got, ref, rtol=1e-9, atol=1e-9)
        assert slv.retcode


# --- parity with the JAX package ------------------------------------------------------------


@pytest.mark.parametrize("m", [1, 2, 3, 4])
def test_inv_small_matches_reference(m):
    rng = np.random.default_rng(40 + m)
    M = rng.normal(size=(6, m, m)) + 1j * rng.normal(size=(6, m, m))
    want = np.asarray(jobs._inv_small(np.asarray(M)))
    got = tobs._inv_small(torch.as_tensor(M)).numpy()
    assert rel(got, want) <= 1e-12


def _z_pairs(rng, B, m):
    """B matrices Z = w I - Sigma with a causal, non-Hermitian Sigma = R - i
    Gamma (R Hermitian, Gamma Hermitian positive definite)."""
    a = rng.normal(size=(B, m, m)) + 1j * rng.normal(size=(B, m, m))
    R = 0.15 * (a + a.conj().transpose(0, 2, 1))
    g = rng.normal(size=(B, m, m)) + 1j * rng.normal(size=(B, m, m))
    Gam = 0.05 * np.einsum("bij,bkj->bik", g, g.conj()) + 0.05 * np.eye(m)
    return rng.uniform(-3, 3, B)[:, None, None] * np.eye(m) - (R - 1j * Gam)


@pytest.mark.parametrize("m,d", [(1, 1), (1, 3), (2, 1), (2, 2), (2, 3), (3, 1), (3, 2), (3, 3), (4, 2), (4, 3)])
def test_sigma_pairs_sum_plain_matches_reference_at_unequal_pairs(m, d):
    """K28's plain version at unequal frequency pairs (Z2 is not Z1, as a
    kinetic trip hands them over) against the reference's two-frequency
    integrand (``selfenergy.py:380-393``: two spectral functions by
    ``_inv_small``, v_a A1 and v_b A2 by einsum, the real trace, the
    weighted k-sum and the scale) on random Hermitian H and v_a, 7 pairs:
    1e-12 of the value scale."""
    import jax.numpy as jnp

    rng = np.random.default_rng(70 + 10 * m + d)
    K, B = 60, 7
    H = rng.normal(size=(K, m, m)) + 1j * rng.normal(size=(K, m, m))
    H = (H + H.conj().transpose(0, 2, 1)) / 2
    V = rng.normal(size=(K, d, m, m)) + 1j * rng.normal(size=(K, d, m, m))
    V = (V + V.conj().transpose(0, 1, 3, 2)) / 2
    w = rng.random(K) + 0.5
    Z1, Z2 = _z_pairs(rng, B, m), _z_pairs(rng, B, m)

    def spectral(Z):
        G = jobs._inv_small(jnp.asarray(Z)[None] - jnp.asarray(H))
        return (G - jnp.conj(jnp.swapaxes(G, -1, -2))) / (-2j * jnp.pi)

    want = []
    for b in range(B):
        A1, A2 = spectral(Z1[b]), spectral(Z2[b])
        vA1 = jnp.einsum("kaij,kjn->kain", V, A1)
        vA2 = jnp.einsum("kbij,kjn->kbin", V, A2)
        Gam = jnp.real(jnp.einsum("kaij,kbji->kab", vA1, vA2))
        want.append(np.asarray(jnp.einsum("k,kab->ab", w, Gam) * 0.7))
    got = ts.sigma_pairs_sum_plain(torch.as_tensor(H), torch.as_tensor(V), torch.as_tensor(w), torch.as_tensor(Z1),
                                   torch.as_tensor(Z2), 0.7).numpy()
    assert got.shape == (B, d, d)
    assert rel(got, np.stack(want)) <= 1e-12


@pytest.mark.parametrize("matrix", [False, True])
def test_sigma_interpolant_matches_reference(matrix):
    """Inside, at and outside the grid, one frequency and a vector of them:
    the same lerp, bit for bit."""
    rng = np.random.default_rng(7)
    w = np.sort(rng.uniform(-3, 3, 12))
    shape = (12, 3, 3) if matrix else (12,)
    vals = rng.normal(size=shape) + 1j * rng.normal(size=shape)
    Sj = js.SigmaInterpolant(w, vals)
    St = sigma_from_arrays(Sj.omegas, Sj.values_re, Sj.values_im, device="cpu")
    pts = np.concatenate([w[[0, 5, 11]], [-7.0, 9.0, 0.123, w[3] + 1e-9], rng.uniform(-3, 3, 9)])
    for om in list(pts[:4]) + [pts]:
        assert np.array_equal(St(om).numpy(), np.asarray(Sj(om)))


DOS_CASES = {
    "graphene-FBZ": ("tb_graphene", {}, "FBZ", 2, 24),
    "graphene-InversionSymIBZ": ("tb_graphene", {}, "InversionSymIBZ", 2, 24),
    "flagship-FBZ": ("flagship", {}, "FBZ", 3, 10),
    "wannier4-FBZ": ("synthetic_wannier", dict(nbands=4, nr=3, ndim=2, seed=1), "FBZ", 2, 12),
    "wannier4-InversionSymIBZ": ("synthetic_wannier", dict(nbands=4, nr=3, ndim=2, seed=1), "InversionSymIBZ", 2, 12),
}


def _dos_setup(case):
    name, kw, kind, d, npt = DOS_CASES[case]
    (hj, ht), (bzj, bzt) = model(name, **kw), bzs(kind, d)
    m = 3 if name == "flagship" else (4 if name == "synthetic_wannier" else 2)
    return hj, ht, bzj, bzt, npt, fermi_liquid(m)


@pytest.mark.parametrize("case", sorted(DOS_CASES))
@pytest.mark.parametrize("project", [False, True])
def test_sigma_dos_solver_matches_reference(case, project):
    """A non-diagonal causal Sigma(w): the trace DOS and the orbital
    projection (m > 3 through the solve route), 1e-12 relative."""
    hj, ht, bzj, bzt, npt, (Sj, St) = _dos_setup(case)
    om = np.linspace(-4.0, 5.0, 13)
    want = np.asarray(js.SigmaDOSSolver(hj, bzj, npt, Sj, mu=0.1, project=project)(om))
    got = ts.SigmaDOSSolver(ht, bzt, npt, St, mu=0.1, project=project, omega_chunk=5)(om)
    assert got.shape == want.shape
    assert rel(got, want) <= 1e-12


@pytest.mark.parametrize("case", ["graphene-FBZ", "graphene-InversionSymIBZ", "flagship-FBZ",
                                  "wannier4-InversionSymIBZ"])
def test_sigma_transport_solver_matches_reference(case):
    hj, ht, bzj, bzt, npt, (Sj, St) = _dos_setup(case)
    om = np.linspace(-3.0, 3.0, 7)
    want = np.asarray(js.SigmaTransportSolver(hj, bzj, npt, Sj, mu=0.1)(om))
    got = ts.SigmaTransportSolver(ht, bzt, npt, St, mu=0.1)(om)
    assert got.shape == want.shape
    assert rel(got, want) <= 1e-12


@pytest.mark.parametrize("alpha", [0, 1])
def test_sigma_kinetic_matches_reference(alpha):
    """The adaptive frequency integral over K28's two-frequency sums: the
    same values, numevals and retcode as the reference's solver."""
    (hj, ht), (bzj, bzt) = model("tb_graphene"), bzs("InversionSymIBZ")
    Sj, St = fermi_liquid(2)
    kj = js.SigmaKineticCoefficientSolver(hj, bzj, 16, Sj, 20.0, alpha=alpha, mu=0.4)
    kt = ts.SigmaKineticCoefficientSolver(ht, bzt, 16, St, 20.0, alpha=alpha, mu=0.4)
    want = np.asarray(kj([0.0, 0.5], abstol=1e-7))
    got = kt([0.0, 0.5], abstol=1e-7)
    assert rel(got, want) <= 1e-12
    assert kt.numevals == kj.numevals and kt.retcode == kj.retcode


def test_sigma_kinetic_negative_omega_and_certified_dos_match_reference():
    """The inherited per-Omega loop (a negative photon frequency) and the
    certified ladder: the same values, counts, rungs and retcodes."""
    (hj, ht), (bzj, bzt) = model("tb_graphene"), bzs("FBZ")
    Sj, St = fermi_liquid(2)
    kj = js.SigmaKineticCoefficientSolver(hj, bzj, 12, Sj, 10.0, mu=0.2)
    kt = ts.SigmaKineticCoefficientSolver(ht, bzt, 12, St, 10.0, mu=0.2)
    assert rel(kt([-0.3], abstol=1e-6), np.asarray(kj([-0.3], abstol=1e-6))) <= 1e-12
    assert kt.numevals == kj.numevals and kt.retcode == kj.retcode
    om = np.linspace(-1, 1, 6)
    rj = js.certified_sigma_dos(hj, bzj, om, Sj, abstol=1e-4, nmin=12, nmax=96)
    rt = ts.certified_sigma_dos(ht, bzt, om, St, abstol=1e-4, nmin=12, nmax=96)
    assert rt.npts == tuple(rj.npts) and rt.retcode == rj.retcode
    assert rel(rt.u, rj.u) <= 1e-12


def test_dos_integrand_sigma_matches_reference_under_ptr_iai_and_tai():
    """The batched integrand (K27's pointwise entry on the card) under PTR,
    IAI and TAI: the reference's values and evaluation counts."""
    (hj, ht), (bzj, bzt) = model("tb_graphene"), bzs("FBZ")
    Sj, St = fermi_liquid(2)
    fj, ft = js.dos_integrand_sigma(hj, Sj), ts.dos_integrand_sigma(ht, St)
    assert ft.batched and isinstance(ft.rep, T.TrivialRep)
    uj = float(J.IntegralSolver(J.IntegralProblem(fj, bzj), J.PTR(npt=32))(om=0.7))
    ut = float(T.IntegralSolver(T.IntegralProblem(ft, bzt), T.PTR(npt=32, device="cpu"))(om=0.7))
    assert abs(ut - uj) <= 1e-12 * abs(uj)
    for alg_j, alg_t, tol in ((J.IAI(inner_cap=64), T.IAI(inner_cap=64, device="cpu"), 1e-5),
                              (J.TAI(), T.TAI(device="cpu"), 1e-3)):
        sj = J.solve(J.IntegralProblem(fj, bzj, 0.7), alg_j, abstol=tol)
        st = T.solve(T.IntegralProblem(ft, bzt, 0.7), alg_t, abstol=tol)
        assert st.numevals == sj.numevals and bool(st.retcode) == bool(sj.retcode)
        assert abs(float(st.u) - float(sj.u)) <= 1e-12 * abs(float(sj.u))


def test_dos_integrand_sigma_two_lane_sweeps_match_reference():
    """Two frequencies swept as lanes: PTR lane by lane and IAI as one
    batched pool (one frequency per point at the leaf), each lane the
    reference's solve at its frequency with its count."""
    (hj, ht), (bzj, bzt) = model("tb_graphene"), bzs("FBZ")
    Sj, St = fermi_liquid(2)
    fj, ft = js.dos_integrand_sigma(hj, Sj), ts.dos_integrand_sigma(ht, St)
    oms = np.array([-0.4, 0.9])
    got = SweepSolver(T.IntegralProblem(ft, bzt), T.PTR(npt=24, device="cpu"), chunk=2)(oms)
    want = [float(J.IntegralSolver(J.IntegralProblem(fj, bzj), J.PTR(npt=24))(om=float(om))) for om in oms]
    assert rel(got, want) <= 1e-12
    sw = SweepSolver(T.IntegralProblem(ft, bzt), T.IAI(inner_cap=64, device="cpu"), abstol=1e-4, chunk=2, scan=True)
    lanes = sw(oms)
    ref = [J.solve(J.IntegralProblem(fj, bzj, float(om)), J.IAI(inner_cap=64), abstol=1e-4) for om in oms]
    assert sw.retcode and list(sw.lane_numevals) == [r.numevals for r in ref]
    assert rel(lanes, [float(r.u) for r in ref]) <= 1e-12


def test_pointwise_integrands_match_reference():
    """greens_trace_sigma and transport_distribution_sigma at one point and
    over a batch of points with one frequency per point (m = 2, 3, and 4
    through solve)."""
    from autobzcore_tpu.fourier import FourierValue as JValue
    from autobzcore_tpu.fourier import JacobianSeries as JJac

    rng = np.random.default_rng(11)
    for name, kw in (("tb_graphene", {}), ("flagship", {}), ("synthetic_wannier", dict(nbands=4, nr=3, ndim=2,
                                                                                         seed=1))):
        hj, ht = model(name, **kw)
        m = ht.valshape[-1]
        Sj, St = fermi_liquid(m)
        d = ht.sndim
        X = rng.random((5, d))
        jac_j, jac_t = JJac(hj), T.JacobianSeries(ht)
        oms = rng.uniform(-3, 3, 5)
        for i in range(5):
            vj = JValue(X[i], jac_j(X[i]))
            vt = T.FourierValue(torch.as_tensor(X[i]), jac_t(torch.as_tensor(X[i])))
            want = np.asarray(js.transport_distribution_sigma(vj, oms[i], Sigma=Sj, mu=0.1))
            got = ts.transport_distribution_sigma(vt, oms[i], Sigma=St, mu=0.1).numpy()
            assert rel(got, want) <= 1e-12
            wj = complex(np.asarray(js.greens_trace_sigma(JValue(X[i], hj(X[i])), oms[i], Sigma=Sj, mu=0.1)))
            wt = complex(ts.greens_trace_sigma(T.FourierValue(None, ht(torch.as_tensor(X[i]))), oms[i], Sigma=St,
                                               mu=0.1))
            assert abs(wt - wj) <= 1e-12 * abs(wj)
        Hb = ht.eval_points(torch.as_tensor(X))
        batch = ts.dos_trace_sigma(T.FourierValue(None, Hb), torch.as_tensor(oms), Sigma=St, mu=0.1).numpy()
        single = [float(ts.dos_trace_sigma(T.FourierValue(None, Hb[i]), oms[i], Sigma=St, mu=0.1)) for i in range(5)]
        assert rel(batch, single) <= 1e-14


# --- K27 at m <= 3: the identities its kernels run, in numpy, against the plain versions -------------


def _k27_lanes(rng, H, W, eta):
    """W lane matrices Z = (om + i eta) I - R + i G: half at random om, half
    on an eigenvalue of some H_k (a pole at small eta), with a small
    non-diagonal causal Sigma (R real symmetric, G positive semidefinite)."""
    m = H.shape[-1]
    ev = np.linalg.eigvalsh(H[rng.integers(0, H.shape[0], W // 2)])
    om = np.concatenate([rng.uniform(-4.0, 4.0, W - W // 2), ev[np.arange(W // 2), rng.integers(0, m, W // 2)]])
    R = rng.normal(scale=0.02, size=(W, m, m))
    a = rng.normal(scale=0.01, size=(W, m, m))
    return (om + 1j * eta)[:, None, None] * np.eye(m) - (R + np.swapaxes(R, 1, 2)) / 2 \
        + 1j * (a @ np.swapaxes(a, 1, 2))


@pytest.mark.parametrize("eta", [1e-3, 0.05])
@pytest.mark.parametrize("diagonal", [False, True], ids=["trace", "diagonal"])
def test_k27_trace_expansion_matches_plain(diagonal, eta):
    """K27's trace and diagonal sums at m = 3 (csrc/sigma_trace.cu): the
    expansion of det, e2 and the minors in a lane's and a k's invariants,
    with near-pole pairs redone from M formed directly, against
    sigma_trace_sum_plain on random Hermitian H and general Z, lanes on
    eigenvalues included (relative 1e-12)."""
    from torch_parity import k27_trace_terms, random_hermitian

    rng = np.random.default_rng(27)
    K, W, scale = 240, 24, 0.37
    H = random_hermitian(rng, K, 3)
    w = rng.random(K) + 0.5
    Z = _k27_lanes(rng, H, W, eta)
    terms, redone = k27_trace_terms(H, Z, diagonal)
    got = -scale / np.pi * np.einsum("wk...,k->w...", terms, w)
    want = ts.sigma_trace_sum_plain(torch.as_tensor(H), torch.as_tensor(w), torch.as_tensor(Z), scale,
                                    diagonal).numpy()
    assert got.shape == want.shape
    assert rel(got, want) <= 1e-12
    if eta < 0.01:  # the guard's route runs at the poles
        assert redone > 0


@pytest.mark.parametrize("m", [1, 2, 3])
@pytest.mark.parametrize("per_point", [False, True], ids=["one_Z", "Z_per_point"])
def test_k27_trace_points_direct_form_matches_plain(m, per_point):
    """K27's pointwise entry at m <= 3: M = Z - (H + H^H) / 2 formed
    directly, its adjugate and one reciprocal of det, against
    sigma_trace_points_plain, near-pole points included (relative 1e-12)."""
    from torch_parity import k27_direct_inverse, random_hermitian

    rng = np.random.default_rng(270 + m)
    N = 200
    H = random_hermitian(rng, N, m)
    Z = _k27_lanes(rng, H, N, 1e-3) if per_point else _k27_lanes(rng, H, 2, 1e-3)[1]
    got = np.trace(k27_direct_inverse(H, Z), axis1=-2, axis2=-1)
    want = ts.sigma_trace_points_plain(torch.as_tensor(H), torch.as_tensor(Z)).numpy()
    assert rel(got, want) <= 1e-12
