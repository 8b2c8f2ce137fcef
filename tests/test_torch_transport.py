"""Parity of the port's transport family (``models.observables``' spectral
velocity pack, ``TransportSolver`` and certified ladder, ``models.transport``'
kinetic coefficients and electron counting, through the plain versions of
kernels K18-K20) with the JAX package on the CPU: every case of
``tests/test_transport.py`` and the transport cases of
``tests/test_observables.py`` run through both packages, then the flagship
at npt 10 and the ``transport_example_torch.py`` entry point.

Tolerances: values 1e-10 relative to the largest; ``numevals`` and retcodes
equal; energies and the velocity pairs 1e-12 relative (nondegenerate models:
the pairs are invariant under the eigenvectors' phases, not under a rotation
inside a degenerate subspace); mu 1e-9. Where a case asserts a physical
identity, the port is held to it at the reference's own tolerance."""
import os
import subprocess
import sys
from pathlib import Path

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import __graft_entry__
import autobzcore_torch as T
import autobzcore_tpu as J
from autobzcore_torch.interop import pack_from_arrays, pack_to_arrays
from autobzcore_torch.models import observables as tobs
from autobzcore_torch.models import tight_binding as ttb
from autobzcore_torch.models import transport as ttr
from autobzcore_torch.parallel.sweep import SweepSolver
from autobzcore_tpu.models import observables as jobs
from autobzcore_tpu.models import tight_binding as jtb
from autobzcore_tpu.models import transport as jtr

torch.set_num_threads(2)


def rel(got, want):
    got, want = np.asarray(got), np.asarray(want)
    return float(np.max(np.abs(got - want)) / np.max(np.abs(want)))


def bzs(kind, d=2):
    return J.load_bz(getattr(J, kind)(), np.eye(d)), T.load_bz(getattr(T, kind)(), np.eye(d))


def jpack_arrays(pack):
    return (np.asarray(pack.e), np.asarray(pack.Wmat), float(pack.scale), pack.Savg, np.asarray(pack.weights),
            pack.ndim, pack.npt)


@pytest.fixture(scope="module")
def setup():
    """The reference's fixture on both packages: tb_integer(2), FBZ, npt 16,
    eta 0.3, beta 4."""
    hj, ht = jtb.tb_integer(2), ttb.tb_integer(2, device="cpu")
    bzj, bzt = bzs("FBZ")
    kj = jtr.KineticCoefficientSolver(hj, bzj, 16, eta=0.3, beta=4.0)
    kt = ttr.KineticCoefficientSolver(ht, bzt, 16, eta=0.3, beta=4.0)
    return {"h": (hj, ht), "bz": (bzj, bzt), "kc": (kj, kt)}


def test_fermi_window_identities():
    beta = 7.0
    ws = np.linspace(-6, 6, 2001)
    w0 = ttr.fermi_window(ws, 0.0, beta).numpy()
    assert np.all(w0 >= 0)
    fp = beta * np.exp(beta * ws) / (1 + np.exp(beta * ws)) ** 2
    assert np.max(np.abs(w0 - fp)) < 1e-12
    for Om in (0.0, 0.3, 2.0):
        lo, hi = ttr.fermi_window_limits(Om, beta, wtol=1e-12)
        assert (lo, hi) == jtr.fermi_window_limits(Om, beta, wtol=1e-12)
        xs = np.linspace(lo, hi, 20001)
        win = ttr.fermi_window(xs, Om, beta).numpy()
        assert rel(win, jtr.fermi_window(xs, Om, beta)) <= 1e-12
        assert np.trapezoid(win, xs) == pytest.approx(1.0, abs=1e-9)
    big = float(ttr.fermi_window(1e6, 0.0, beta))
    assert np.isfinite(big) and big < 1e-200
    assert rel(ttr.fermi(np.linspace(-800, 800, 41)), jtr.fermi(np.linspace(-800, 800, 41))) <= 1e-15


def test_fermi_window_no_cancellation_near_dc():
    beta = 40.0
    ws = np.linspace(-0.5, 0.5, 101)
    w_dc = ttr.fermi_window(ws, 0.0, beta).numpy()
    w_eps = ttr.fermi_window(ws, 1e-12, beta).numpy()
    assert np.max(np.abs(w_eps - w_dc) / w_dc.max()) < 1e-10
    assert rel(w_eps, jtr.fermi_window(ws, 1e-12, beta)) <= 1e-12


def test_equal_frequency_reduces_to_transport_solver(setup):
    (hj, ht), (bzj, bzt), (kj, kt) = setup["h"], setup["bz"], setup["kc"]
    om = 0.37
    win = float(ttr.fermi_window(om, 0.0, 4.0))
    G_kc = kt._integrand(torch.tensor(om, dtype=torch.float64), 0.0).numpy() / win
    G_ts = tobs.TransportSolver(ht, bzt, 16, eta=0.3)(np.array([om]))[0]
    assert np.max(np.abs(G_kc - G_ts)) < 1e-10
    assert rel(G_ts, np.asarray(jobs.TransportSolver(hj, bzj, 16, eta=0.3)(np.array([om])))[0]) <= 1e-10
    assert rel(G_kc * win, kj._integrand(jnp.asarray(om), jnp.asarray(0.0))) <= 1e-10


@pytest.mark.parametrize("Om", [0.0, 0.8])
def test_adaptive_matches_reference_and_dense_trapezoid(setup, Om):
    kj, kt = setup["kc"]
    want = kj(np.array([Om]), abstol=1e-7)[0]
    got = kt(np.array([Om]), abstol=1e-7)[0]
    assert rel(got, want) <= 1e-10
    assert kt.retcode is kj.retcode is True
    # the same integrand on both sides through a dense trapezoid, in one batched call
    lo, hi = ttr.fermi_window_limits(Om, 4.0, wtol=1e-12)
    ws = np.linspace(lo, hi, 1501)
    vals = kt._integrand(torch.as_tensor(ws), Om).numpy()
    assert np.max(np.abs(got - np.trapezoid(vals, ws, axis=0))) < 1e-5
    assert got[0, 0] == pytest.approx(got[1, 1], rel=1e-8)
    assert abs(got[0, 1]) < 1e-10 * got[0, 0]


def test_counts_match_reference():
    """``numevals`` of one solve, a sweep and a negative-frequency solve."""
    hj, ht = jtb.tb_integer(2), ttb.tb_integer(2, device="cpu")
    bzj, bzt = bzs("FBZ")
    kj = jtr.KineticCoefficientSolver(hj, bzj, 16, eta=0.3, beta=4.0)
    kt = ttr.KineticCoefficientSolver(ht, bzt, 16, eta=0.3, beta=4.0)
    for call in (lambda k: k(np.array([0.8]), abstol=1e-7),
                 lambda k: k.sweep(np.array([0.0, 0.4, 0.8]), abstol=1e-7, chunk=2),
                 lambda k: k(np.array([-0.5, 0.3]), abstol=1e-7)):
        want, got = call(kj), call(kt)
        assert rel(got, want) <= 1e-10
        assert (kt.numevals, kt.retcode) == (kj.numevals, kj.retcode)


def test_ibz_matches_fbz(setup):
    (hj, ht), (_, bzt), (_, kt) = setup["h"], setup["bz"], setup["kc"]
    bzji, bzti = bzs("InversionSymIBZ")
    kti = ttr.KineticCoefficientSolver(ht, bzti, 16, eta=0.3, beta=4.0)
    gi = kti(np.array([0.8]), abstol=1e-7)[0]
    gf = kt(np.array([0.8]), abstol=1e-7)[0]
    assert np.max(np.abs(gi - gf)) < 1e-10 * max(1.0, gf[0, 0])
    kji = jtr.KineticCoefficientSolver(hj, bzji, 16, eta=0.3, beta=4.0)
    assert rel(gi, kji(np.array([0.8]), abstol=1e-7)[0]) <= 1e-10
    assert kti.numevals == kji.numevals


def test_moments_and_one_shot(setup):
    (hj, ht), (bzj, bzt), (_, kt) = setup["h"], setup["bz"], setup["kc"]
    kt1 = ttr.KineticCoefficientSolver(ht, bzt, 16, eta=0.3, beta=4.0, alpha=1)
    a1 = kt1(np.array([0.5]), abstol=1e-7)[0]
    assert np.isfinite(a1).all()
    kj1 = jtr.KineticCoefficientSolver(hj, bzj, 16, eta=0.3, beta=4.0, alpha=1)
    assert rel(a1, kj1(np.array([0.5]), abstol=1e-7)[0]) <= 1e-10
    assert kt1.numevals == kj1.numevals
    sig = ttr.optical_conductivity(ht, bzt, 16, eta=0.3, beta=4.0, Omegas=[0.8], abstol=1e-7)
    ref = kt(np.array([0.8]), abstol=1e-7)
    assert np.max(np.abs(sig - ref)) < 1e-8
    assert rel(sig, jtr.optical_conductivity(hj, bzj, 16, eta=0.3, beta=4.0, Omegas=[0.8], abstol=1e-7)) <= 1e-10


def test_mu_shifts_the_window(setup):
    (hj, ht), (bzj, bzt), (_, kt) = setup["h"], setup["bz"], setup["kc"]
    kt_mu = ttr.KineticCoefficientSolver(ht, bzt, 16, eta=0.3, beta=4.0, mu=-30.0)
    g0 = kt(np.array([0.0]), abstol=1e-7)[0][0, 0]
    gmu = kt_mu(np.array([0.0]), abstol=1e-7)[0]
    assert gmu[0, 0] < 1e-3 * g0
    kj_mu = jtr.KineticCoefficientSolver(hj, bzj, 16, eta=0.3, beta=4.0, mu=-30.0)
    assert rel(gmu, kj_mu(np.array([0.0]), abstol=1e-7)[0]) <= 1e-10
    assert kt_mu.numevals == kj_mu.numevals


def test_sweep_matches_per_omega(setup):
    kt = setup["kc"][1]
    Oms = np.array([0.0, 0.4, 0.8])
    ref = kt(Oms, abstol=1e-7)
    got = kt.sweep(Oms, abstol=1e-7, chunk=2)
    assert got.shape == ref.shape == (3, 2, 2)
    assert np.max(np.abs(got - ref)) < 1e-6


def test_electron_count_and_find_mu():
    hj, ht = jtb.tb_integer(2), ttb.tb_integer(2, device="cpu")
    bzj, bzt = bzs("FBZ")
    ec = ttr.ElectronCountSolver(ht, bzt, 32)
    ecj = jtr.ElectronCountSolver(hj, bzj, 32)
    assert ec.nbands == 1
    assert ec(0.0, 5.0) == pytest.approx(0.5, abs=1e-12)
    assert ec(0.0, np.inf) == pytest.approx(0.5, abs=0.02)
    assert ec(-10.0, 5.0) < 1e-6
    assert ec(10.0, 5.0) > 1 - 1e-6
    for mu, beta in ((0.7, 5.0), (-1.3, 40.0), (0.2, np.inf), (-3.9, 2.0)):
        assert ec(mu, beta) == pytest.approx(ecj(mu, beta), rel=1e-12, abs=1e-15)
    _, bzti = bzs("InversionSymIBZ")
    eci = ttr.ElectronCountSolver(ht, bzti, 32)
    assert eci(0.7, 5.0) == pytest.approx(ec(0.7, 5.0), abs=1e-12)
    mu = ec.find_mu(0.3, 5.0)
    assert ec(mu, 5.0) == pytest.approx(0.3, abs=1e-8)
    assert mu == pytest.approx(ecj.find_mu(0.3, 5.0), abs=1e-9)
    with pytest.raises(ValueError):
        ec.find_mu(1.5, 5.0)


def test_validation_and_pack_sharing(setup):
    (_, ht), (_, bzt), (_, kt) = setup["h"], setup["bz"], setup["kc"]
    with pytest.raises(ValueError, match="non-negative"):
        ttr.KineticCoefficientSolver(ht, bzt, 16, eta=0.3, beta=4.0, alpha=-1)
    with pytest.raises(ValueError, match="finite"):
        ttr.fermi_window_limits(0.0, np.inf)
    pack = tobs.spectral_velocity_pack(ht, bzt, 16)
    kt_shared = ttr.KineticCoefficientSolver(ht, bzt, 16, eta=0.3, beta=4.0, pack=pack)
    got = kt_shared(np.array([0.8]), abstol=1e-7)
    assert np.array_equal(got, kt(np.array([0.8]), abstol=1e-7))
    assert kt_shared.pack is pack
    ec_cheap = ttr.ElectronCountSolver(ht, bzt, 16)
    ec_pack = ttr.ElectronCountSolver(ht, bzt, 16, pack=pack)
    assert ec_cheap(0.4, 5.0) == pytest.approx(ec_pack(0.4, 5.0), abs=1e-12)
    with pytest.raises(NotImplementedError):
        kt.sweep(np.array([0.1]), mesh=object())
    with pytest.raises(ValueError, match=">= 0"):
        kt.sweep(np.array([-0.1]))


def test_zero_omega_takes_equal_frequencies_and_kernels_are_arguments(setup):
    """At Omega = 0 the integrand hands the contraction the same node
    tensors (K19's equal frequencies), elsewhere new ones; the contraction
    and the count are arguments, and the results do not change."""
    (_, ht), (_, bzt), (_, kt) = setup["h"], setup["bz"], setup["kc"]
    seen = []

    def gamma(e, Wmat, y1, g1, y2, g2, scale):
        seen.append(y2 is y1 and g2 is g1)
        return tobs.transport_gamma_plain(e, Wmat, y1, g1, y2, g2, scale)

    ks = ttr.KineticCoefficientSolver(ht, bzt, 16, eta=0.3, beta=4.0, pack=kt.pack, gamma=gamma)
    assert np.array_equal(ks(np.array([0.0]), abstol=1e-7), kt(np.array([0.0]), abstol=1e-7))
    assert seen and all(seen)
    seen.clear()
    assert np.array_equal(ks(np.array([0.0, 0.8]), abstol=1e-7), kt(np.array([0.0, 0.8]), abstol=1e-7))
    assert seen and not any(seen)
    seen.clear()
    ws = torch.linspace(-1, 1, 5, dtype=torch.float64)
    assert torch.equal(ks._integrand(ws, 0.0), ks._integrand(ws, torch.zeros(5, dtype=torch.float64)))
    assert seen == [True, False]
    calls = []

    def count(*args):
        calls.append(args)
        return ttr.fermi_count_plain(*args)

    ec = ttr.ElectronCountSolver(ht, bzt, 16, count=count)
    assert ec(0.4, 5.0) == ttr.ElectronCountSolver(ht, bzt, 16)(0.4, 5.0) and len(calls) == 1


def test_sweep_sets_retcode(setup):
    (hj, ht), (bzj, bzt) = setup["h"], setup["bz"]
    kt_ok = ttr.KineticCoefficientSolver(ht, bzt, 16, eta=0.3, beta=4.0)
    kt_ok.sweep(np.array([0.0, 0.4]), abstol=1e-6, chunk=2)
    assert kt_ok.retcode is True
    assert kt_ok.numevals > 100
    kt_bad = ttr.KineticCoefficientSolver(ht, bzt, 16, eta=0.3, beta=4.0, cap=8)
    got = kt_bad.sweep(np.array([0.0, 0.4]), abstol=1e-14, chunk=2)
    assert kt_bad.retcode is False
    kj_bad = jtr.KineticCoefficientSolver(hj, bzj, 16, eta=0.3, beta=4.0, cap=8)
    assert rel(got, kj_bad.sweep(np.array([0.0, 0.4]), abstol=1e-14, chunk=2)) <= 1e-10
    assert (kt_bad.numevals, kt_bad.retcode) == (kj_bad.numevals, kj_bad.retcode)


def test_scalar_self_energy(setup):
    (hj, ht), (bzj, bzt), (_, kt) = setup["h"], setup["bz"], setup["kc"]
    kt_const = ttr.KineticCoefficientSolver(ht, bzt, 16, eta=0.3, beta=4.0, self_energy=lambda w: -0.3j)
    ref = kt(np.array([0.5]), abstol=1e-7)
    got = kt_const(np.array([0.5]), abstol=1e-7)
    assert np.max(np.abs(got - ref)) < 1e-9
    kt_fl = ttr.KineticCoefficientSolver(ht, bzt, 16, eta=0.3, beta=4.0,
                                         self_energy=lambda w: 0.05 * w - 1j * (0.3 + 0.2 * w**2))
    fl = kt_fl(np.array([0.5]), abstol=1e-7)
    assert kt_fl.retcode
    assert np.isfinite(fl).all()
    assert np.max(np.abs(fl - ref)) > 1e-3
    kj_fl = jtr.KineticCoefficientSolver(hj, bzj, 16, eta=0.3, beta=4.0,
                                         self_energy=lambda w: 0.05 * w - 1j * (0.3 + 0.2 * w**2))
    assert rel(fl, kj_fl(np.array([0.5]), abstol=1e-7)) <= 1e-10
    assert kt_fl.numevals == kj_fl.numevals


def test_electron_count_pack_npt_mismatch_safe():
    h = ttb.tb_graphene(device="cpu")
    _, bz = bzs("FBZ")
    pack = tobs.spectral_velocity_pack(h, bz, 16)
    n_ref = ttr.ElectronCountSolver(h, bz, 16)(0.0, 50.0)
    n_pack = ttr.ElectronCountSolver(h, bz, 999, pack=pack)(0.0, 50.0)
    assert abs(n_pack - n_ref) < 1e-12
    assert n_ref == pytest.approx(jtr.ElectronCountSolver(jtb.tb_graphene(), bzs("FBZ")[0], 16)(0.0, 50.0),
                                  abs=1e-12)


# --- the transport cases of tests/test_observables.py ----------------------------------------


def test_transport_integrand_under_ptr():
    _, bzt = bzs("FBZ")
    fi = tobs.transport_integrand(ttb.tb_integer(2, device="cpu"), eta=0.1)
    G = T.solve(T.IntegralProblem(fi, bzt, T.MixedParameters(0.0)), T.PTR(npt=20, device="cpu")).u.numpy()
    assert G.shape == (2, 2)
    assert G[0, 0] > 0 and G[0, 0] == pytest.approx(G[1, 1], rel=1e-8)
    assert abs(G[0, 1]) < 1e-8 * G[0, 0]
    bzj, _ = bzs("FBZ")
    want = J.solve(J.IntegralProblem(jobs.transport_integrand(jtb.tb_integer(2), eta=0.1), bzj,
                                     J.MixedParameters(0.0)), J.PTR(npt=20)).u
    assert rel(G, want) <= 1e-10


def test_transport_sweep_matches_per_omega_solve():
    h = ttb.tb_integer(2, device="cpu")
    bzji, bzti = bzs("InversionSymIBZ")
    _, bz_full = bzs("FBZ")
    omegas = np.array([-1.0, 0.0, 1.5])
    sweep = tobs.transport_sweep(h, bzti, 40, omegas, eta=0.3)
    assert sweep.shape == (3, 2, 2)
    assert rel(sweep, jobs.transport_sweep(jtb.tb_integer(2), bzji, 40, omegas, eta=0.3)) <= 1e-10
    ptr = T.PTR(npt=40, device="cpu")
    for i, om in enumerate(omegas):
        sol = T.solve(T.IntegralProblem(tobs.transport_integrand(h, eta=0.3), bz_full, T.MixedParameters(float(om))),
                      ptr)
        assert np.allclose(sweep[i], sol.u.numpy(), rtol=1e-8, atol=1e-10), om
    sol_ibz = T.solve(T.IntegralProblem(tobs.transport_integrand(h, eta=0.3), bzti, T.MixedParameters(0.0)), ptr)
    sol_fbz = T.solve(T.IntegralProblem(tobs.transport_integrand(h, eta=0.3), bz_full, T.MixedParameters(0.0)), ptr)
    assert np.allclose(sol_ibz.u.numpy(), sol_fbz.u.numpy(), rtol=1e-9, atol=1e-10)


def test_certified_transport_sweep():
    bzj, bz = bzs("FBZ")
    h = ttb.tb_haldane(t2=0.1, M=0.3, device="cpu")
    om = np.linspace(-2, 2, 8)
    res = tobs.certified_transport_sweep(h, bz, om, eta=0.1, abstol=1e-4, nmin=16, nmax=256)
    want = jobs.certified_transport_sweep(jtb.tb_haldane(t2=0.1, M=0.3), bzj, om, eta=0.1, abstol=1e-4,
                                          nmin=16, nmax=256)
    assert res.retcode and res.resid <= 1e-4
    assert res.npts == want.npts and res.retcode == want.retcode
    assert rel(res.u, want.u) <= 1e-10
    ref = tobs.TransportSolver(h, bz, 2 * res.npts[-1], 0.1)(om)
    assert np.abs(res.u - ref).max() <= 1e-4
    assert all(b > a for a, b in zip(res.npts, res.npts[1:]))
    res2 = tobs.certified_transport_sweep(ttb.tb_graphene(device="cpu"), bz, om, eta=0.2, abstol=1e-8, nmin=16,
                                          nmax=40)
    assert not res2.retcode
    want2 = jobs.certified_transport_sweep(jtb.tb_graphene(), bzj, om, eta=0.2, abstol=1e-8, nmin=16, nmax=40)
    assert res2.npts == want2.npts


# --- the pack, the kernels' plain versions, carried weights --------------------------------


def test_tb_haldane_matches_reference():
    for kw in ({}, {"t2": 0.1, "M": 0.3, "phi": 0.7, "period": 2.0}):
        hj, ht = jtb.tb_haldane(**kw), ttb.tb_haldane(device="cpu", **kw)
        assert np.array_equal(ht.c.numpy(), np.asarray(hj.c))
        assert tuple(ht.offset) == tuple(hj.offset) and tuple(ht.period) == tuple(hj.period)


def _wannier(period=1.0):
    return (jtb.synthetic_wannier(3, nr=3, seed=5, period=period),
            ttb.synthetic_wannier(3, nr=3, seed=5, period=period, device="cpu"))


@pytest.mark.parametrize("case", ["wannier3-InversionSymIBZ-8", "wannier3-period2.5-FBZ-6", "flagship-FBZ-10"])
def test_pack_matches_reference(case):
    """Energies and velocity pairs (nondegenerate models), weights, scale and
    group average; the grid helpers at a period other than 1 (derivatives
    with respect to z = x/t on both sides)."""
    if case.startswith("flagship"):
        hj, ht = __graft_entry__._flagship_series(jnp.complex128), ttb.flagship_series(device="cpu")
    else:
        hj, ht = _wannier(2.5 if "period" in case else 1.0)
    kind, npt = case.split("-")[-2], int(case.split("-")[-1])
    bzj, bzt = bzs(kind, d=3)
    pj, pt = jobs.spectral_velocity_pack(hj, bzj, npt), tobs.spectral_velocity_pack(ht, bzt, npt)
    assert pt.e.shape == np.asarray(pj.e).shape and pt.Wmat.shape == np.asarray(pj.Wmat).shape
    assert rel(pt.e.numpy(), pj.e) <= 1e-12
    assert rel(pt.Wmat.numpy(), pj.Wmat) <= 1e-12
    assert np.array_equal(pt.weights, np.asarray(pj.weights)) and (pt.ndim, pt.npt) == (pj.ndim, pj.npt)
    assert pt.scale == pytest.approx(pj.scale, rel=1e-15)
    assert (pt.Savg is None) == (pj.Savg is None)
    if pt.Savg is not None:
        assert all(np.array_equal(a, b) for a, b in zip(pt.Savg[:2], pj.Savg[:2])) and pt.Savg[2] == pj.Savg[2]
    rj = jobs.reduced_grid(bzj, npt, hj.period)
    rt = tobs.reduced_grid(bzt, npt, ht.period)
    assert (rt[0] is None and rj[0] is None) or np.array_equal(rt[0], rj[0])
    assert all(np.array_equal(a, b) for a, b in zip(rt[2], rj[2]))
    hk, vk = tobs.gathered_grid(ht, 3, rt[2], rt[0], jacobian=True)
    hkj, vkj = jobs.gathered_grid(hj, 3, rj[2], rj[0], jacobian=True)
    assert rel(hk.numpy(), hkj) <= 1e-12 and rel(vk.numpy(), vkj) <= 1e-12
    assert rel(tobs.gathered_grid(ht, 3, rt[2], rt[0]).numpy(), jobs.gathered_grid(hj, 3, rj[2], rj[0])) <= 1e-12


def test_pack_round_trip_and_gamma_on_identical_packs():
    """A JAX pack carried into the port (whatever basis eigh picked) gives
    the reference's Gamma through K19's plain version, at equal and unequal
    frequencies and at a self-energy shift, and carries back unchanged."""
    hj = jtb.tb_graphene()
    bzj = J.load_bz(J.InversionSymIBZ(), np.eye(2))
    pj = jobs.spectral_velocity_pack(hj, bzj, 12)
    pt = pack_from_arrays(*jpack_arrays(pj), device="cpu")
    back = pack_to_arrays(pt)
    for a, b in zip(back, jpack_arrays(pj)):
        if isinstance(a, tuple):
            assert all(np.array_equal(x, y) for x, y in zip(a, b))
        else:
            assert np.array_equal(a, b)
    om = np.linspace(-3.1, 2.9, 7)
    want = np.asarray(jobs.TransportSolver(None, None, None, 0.2, pack=pj)(om))
    got = tobs.TransportSolver(None, None, None, 0.2, pack=pt)(om)
    assert rel(got, want) <= 1e-10
    kj = jtr.KineticCoefficientSolver(None, bzj, None, eta=0.2, beta=3.0, mu=0.1, pack=pj)
    kt = ttr.KineticCoefficientSolver(None, T.load_bz(T.InversionSymIBZ(), np.eye(2)), None, eta=0.2, beta=3.0,
                                      mu=0.1, pack=pt)
    ws = np.linspace(-2.5, 1.5, 9)
    batch = kt._integrand(torch.as_tensor(ws), 0.45).numpy()
    assert rel(batch, np.stack([np.asarray(kj._integrand(jnp.asarray(w), jnp.asarray(0.45))) for w in ws])) <= 1e-10
    # the node-chunked plain K19 gives each chunk's rows whatever the chunk size
    y = torch.as_tensor(ws)
    g = torch.full_like(y, 0.2)
    full = tobs.transport_gamma_plain(pt.e, pt.Wmat, y, g, y + 0.45, g, pt.scale)
    assert rel(tobs.transport_gamma_plain(pt.e, pt.Wmat, y, g, y + 0.45, g, pt.scale, chunk=2).numpy(),
               full.numpy()) <= 1e-14


def test_batch_integrand_sweeps_lanes_in_one_call_per_trip():
    """A BatchIntegrand under swept lanes gets one call per GK trip with
    every live node and its lane's parameter, and solves each lane as a
    pointwise integrand does (the reference's BatchIntegrand sweep)."""
    calls = []

    def batch(xs, q):
        calls.append((xs.shape[0], tuple(q.shape)))
        return torch.exp(-q * xs) * torch.cos(3 * xs)

    prob_b = T.IntegralProblem(T.BatchIntegrand(batch), 0.0, 2.0)
    prob_p = T.IntegralProblem(lambda x, q: torch.exp(-q * x) * torch.cos(3 * x), 0.0, 2.0)
    ps = np.array([0.5, 1.0, 4.0])
    sb = SweepSolver(prob_b, T.QuadGKJL(device="cpu"), abstol=1e-10, chunk=3, scan=True)
    sp = SweepSolver(prob_p, T.QuadGKJL(device="cpu"), abstol=1e-10, chunk=3, scan=True)
    ub, up = sb(ps), sp(ps)
    assert rel(ub, up) <= 1e-14
    assert np.array_equal(sb.lane_numevals, sp.lane_numevals) and sb.retcode and sp.retcode
    assert all(n == s[0] for n, s in calls) and len(calls) == sb.stats.trips[1] + 1
    assert calls[0][0] == 3 * 15  # the cold trip: every lane's one segment
    # the reference on the same problem
    from autobzcore_tpu.parallel.sweep import SweepSolver as JSweepSolver

    sj = JSweepSolver(J.IntegralProblem(lambda x, q: jnp.exp(-q * x) * jnp.cos(3 * x), 0.0, 2.0), J.QuadGKJL(),
                      abstol=1e-10, chunk=3, scan=True)
    assert rel(ub, sj(ps)) <= 1e-12 and sb.numevals == sj.numevals
    # the parameter a batched integrand gets: the shared one, or the lane values per point
    from autobzcore_torch.parameters import LaneParams

    lanes = torch.tensor([2, 0, 0, 1])
    assert LaneParams(0.25).batch_params(None) == 0.25
    assert torch.equal(LaneParams(None, torch.tensor(ps), merge=False).batch_params(lanes), torch.tensor(ps)[lanes])


def test_flagship_slice_matches_reference():
    """The slice as a whole at a small size: the flagship at npt 10, mu at
    filling 1, two photon frequencies at eta 0.05, abstol 1e-3, then the
    alpha=1 numerator at Omega = 0."""
    hj, ht = __graft_entry__._flagship_series(jnp.complex128), ttb.flagship_series(device="cpu")
    bzj, bzt = bzs("FBZ", d=3)
    pj, pt = jobs.spectral_velocity_pack(hj, bzj, 10), tobs.spectral_velocity_pack(ht, bzt, 10)
    assert rel(pt.Wmat.numpy(), pj.Wmat) <= 1e-12
    ecj, ect = jtr.ElectronCountSolver(hj, bzj, 10, pack=pj), ttr.ElectronCountSolver(ht, bzt, 10, pack=pt)
    mu = ect.find_mu(1.0, 40.0)
    assert mu == pytest.approx(ecj.find_mu(1.0, 40.0), abs=1e-9)
    assert ttr.ElectronCountSolver(ht, bzt, 10)(7.0, np.inf) == 3.0
    Oms = np.array([0.0, 0.9])
    kj = jtr.KineticCoefficientSolver(hj, bzj, 10, eta=0.05, beta=40.0, mu=mu, pack=pj)
    kt = ttr.KineticCoefficientSolver(ht, bzt, 10, eta=0.05, beta=40.0, mu=mu, pack=pt)
    want, got = kj.sweep(Oms, abstol=1e-3), kt.sweep(Oms, abstol=1e-3)
    assert rel(got, want) <= 1e-10
    assert (kt.numevals, kt.retcode) == (kj.numevals, kj.retcode)
    kj1 = jtr.KineticCoefficientSolver(hj, bzj, 10, eta=0.05, beta=40.0, alpha=1, mu=mu, pack=pj)
    kt1 = ttr.KineticCoefficientSolver(ht, bzt, 10, eta=0.05, beta=40.0, alpha=1, mu=mu, pack=pt)
    assert rel(kt1(np.array([0.0]), abstol=1e-3), kj1(np.array([0.0]), abstol=1e-3)) <= 1e-10
    assert (kt1.numevals, kt1.retcode) == (kj1.numevals, kj1.retcode)


def test_example_runs_on_cpu(tmp_path):
    """``examples/transport_example_torch.py --device cpu --flagship --npt 8
    --nomega 3``: the printed mu and sigma against the reference's flow on
    the same series."""
    env = dict(os.environ, JAX_PLATFORMS="cpu", OMP_NUM_THREADS="2")
    example = Path(__file__).resolve().parents[1] / "examples" / "transport_example_torch.py"
    out = subprocess.run([sys.executable, str(example), "--flagship", "--device", "cpu", "--npt", "8",
                          "--nomega", "3", "--out", str(tmp_path / "sigma.npz")],
                         capture_output=True, text=True, timeout=300, env=env, cwd=tmp_path)
    assert out.returncode == 0, out.stderr[-2000:]
    lines = out.stdout.splitlines()
    mu = float(lines[0].split(" = ")[1].split(" eV")[0])
    s0 = float(next(ln for ln in lines if "sigma_xx(0)" in ln).split("= ")[1])
    smax = float(next(ln for ln in lines if "sigma_xx(max)" in ln).split("= ")[1])
    a1 = float(next(ln for ln in lines if "A1_xx(0)" in ln).split("= ")[1].split(" ")[0])
    hj = __graft_entry__._flagship_series(jnp.complex128)
    bzj = J.load_bz(J.FBZ(), np.eye(3))
    pj = jobs.spectral_velocity_pack(hj, bzj, 8)
    mu_j = jtr.ElectronCountSolver(hj, bzj, 8, pack=pj).find_mu(1.0, 40.0)
    assert mu == pytest.approx(mu_j, abs=1e-9)
    kj = jtr.KineticCoefficientSolver(hj, bzj, 8, eta=5e-3, beta=40.0, alpha=0, mu=mu, pack=pj)
    sig = kj.sweep(np.linspace(0.0, 2.0, 3), abstol=1e-5)
    assert s0 == pytest.approx(sig[0, 0, 0], rel=1e-10) and smax == pytest.approx(sig[-1, 0, 0], rel=1e-10)
    kj1 = jtr.KineticCoefficientSolver(hj, bzj, 8, eta=5e-3, beta=40.0, alpha=1, mu=mu, pack=pj)
    assert a1 == pytest.approx(kj1(np.array([0.0]), abstol=1e-5)[0][0, 0], rel=1e-10)
    assert f"certified={kj.retcode}" in out.stdout
    saved = np.load(tmp_path / "sigma.npz")
    assert saved["sigma"].shape == (3, 3, 3) and float(saved["mu"]) == mu


def test_hr_files_absent_give_a_clear_error(tmp_path):
    example = Path(__file__).resolve().parents[1] / "examples" / "transport_example_torch.py"
    out = subprocess.run([sys.executable, str(example), "--device", "cpu"], capture_output=True, text=True,
                         timeout=120, cwd=tmp_path, env=dict(os.environ, JAX_PLATFORMS="cpu"))
    assert out.returncode != 0 and "not found; pass --flagship" in out.stderr


def test_entry_points_default_to_the_card():
    if torch.cuda.is_available():
        pytest.skip("the default device exists here")
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        ttr.KineticCoefficientSolver(ttb.tb_integer(2), T.load_bz(T.FBZ(), np.eye(2)), 8, eta=0.3, beta=4.0)
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        ttb.tb_haldane()
