"""Parity of the port's Berry family (``models.berry``: the pack and its
queries, the lattice Chern number, Wilson loops and Z2, the flux integrand
and the certified ladder, through the plain versions of kernels K21-K24)
with the JAX package on the CPU: every case of ``tests/test_berry.py`` run
through both packages on the same numpy-built models, then pointwise pack
parity on Haldane, graphene and the 3-D Weyl model, Kane-Mele by its
queries, K24's plain version on identical packs carried across by
``interop.berry_pack_from_arrays``, and ``topology_example_torch.py point``.

Tolerances: pointwise fields (e, Om, Mm, vd, the metric) 1e-10 of max|F|,
compared only where they are gauge-invariant (the eigenvectors' phases
differ between the closed-form eigh2 and LAPACK, and Kane-Mele at M = 0 is
doubly degenerate at every k, so its per-band fields depend on the
solver's mixing inside each pair); zone averages on identical packs 1e-13
of the result's scale (the sums run in another order); queries through the
whole build 1e-10 of the result's scale; Wilson centres 1e-10 modulo 1
after sorting; every physical identity at the reference test's own
tolerance."""
import os
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest
import torch

import autobzcore_torch as T
import autobzcore_tpu as J
from autobzcore_torch.interop import berry_pack_from_arrays, berry_pack_to_arrays
from autobzcore_torch.models import berry as tb
from autobzcore_torch.models import tight_binding as ttb
from autobzcore_torch.parallel.sweep import SweepSolver, sweep_solve
from autobzcore_torch.parameters import MixedParameters as TMixed
from autobzcore_tpu.models import berry as jb
from autobzcore_tpu.models import tight_binding as jtb
from autobzcore_tpu.parameters import MixedParameters as JMixed

torch.set_num_threads(2)

SZ = np.diag([0.5, 0.5, -0.5, -0.5])


def scale_err(got, want):
    """max|got - want| over max|want| (or 1 where want is zero)."""
    got, want = np.asarray(got, dtype=np.float64), np.asarray(want, dtype=np.float64)
    return float(np.max(np.abs(got - want)) / max(float(np.max(np.abs(want))), 1e-300))


def fbz(d=2, A=None):
    A = np.eye(d) if A is None else A
    return J.load_bz(J.FBZ(), A), T.load_bz(T.FBZ(), A)


def model(name, **kw):
    """The same numpy-built model in both packages."""
    return getattr(jtb, name)(**kw), getattr(ttb, name)(**kw, device="cpu")


@pytest.fixture(scope="module")
def solvers():
    """Solvers on both packages, built once per (model, kwargs, lattice, npt)."""
    cache = {}

    def get(name, npt, A=None, **kw):
        key = (name, npt, None if A is None else np.asarray(A).tobytes(), tuple(sorted(kw.items())))
        if key not in cache:
            (hj, ht), (bzj, bzt) = model(name, **kw), fbz(3 if name == "tb_weyl" else 2, A)
            cache[key] = (jb.BerryCurvatureSolver(hj, bzj, npt), tb.BerryCurvatureSolver(ht, bzt, npt))
        return cache[key]

    return get


HALDANE = dict(t1=1.0, t2=0.1, phi=np.pi / 2, M=0.0)


def test_haldane_chern_topological(solvers):
    sj, st = solvers("tb_haldane", 72, **HALDANE)
    C = st.chern()
    assert abs(abs(C[0]) - 1) < 1e-6
    assert abs(C[0] + C[1]) < 1e-9
    assert scale_err(C, sj.chern()) <= 1e-10


def test_haldane_chern_sign_flips_with_phi(solvers):
    Cp = solvers("tb_haldane", 54, t2=0.1, phi=np.pi / 2)[1].chern()
    sjm, stm = solvers("tb_haldane", 54, t2=0.1, phi=-np.pi / 2)
    Cm = stm.chern()
    assert np.allclose(Cp, -Cm, atol=1e-6)
    assert abs(abs(Cp[0]) - 1) < 1e-5
    assert scale_err(Cm, sjm.chern()) <= 1e-10


def test_haldane_chern_trivial_phase(solvers):
    sj, st = solvers("tb_haldane", 54, t1=1.0, t2=0.1, phi=np.pi / 2, M=1.0)
    C = st.chern()
    assert np.allclose(C, 0.0, atol=1e-6)
    assert np.max(np.abs(C - np.asarray(sj.chern()))) <= 1e-10


def test_ahc_gap_quantization(solvers):
    sj, st = solvers("tb_haldane", 72, **HALDANE)
    C = st.chern()
    I = st.ahc(mu=0.0, beta=None)
    assert abs(I[0, 1] - C[0] / (2 * np.pi)) < 1e-6  # det B = 1
    assert abs(I[0, 1] + I[1, 0]) < 1e-9
    assert abs(I[0, 0]) < 1e-9 and abs(I[1, 1]) < 1e-9
    assert scale_err(I, sj.ahc(mu=0.0, beta=None)) <= 1e-10


def test_ahc_basis_invariance(solvers):
    A = np.array([[1.0, 0.5], [0.0, 2.0]])
    sj, st = solvers("tb_haldane", 54, A=A, **HALDANE)
    I, C = st.ahc(mu=0.0, beta=None), st.chern()
    detB = np.linalg.det(np.asarray(st.bz.B))
    assert abs(I[0, 1] - np.sign(detB) * C[0] / (2 * np.pi)) < 1e-6
    assert scale_err(I, sj.ahc(mu=0.0, beta=None)) <= 1e-10
    # the skewed lattice changes only the host tail: the fractional pack is the square lattice's
    for f in ("e", "Om", "Mm", "vd"):
        assert scale_err(getattr(st.pack, f).numpy(), np.asarray(getattr(sj.pack, f))) <= 1e-10


def test_ahc_finite_temperature_interpolates(solvers):
    sj, st = solvers("tb_haldane", 54, **HALDANE)
    I0 = st.ahc(mu=0.0, beta=None)[0, 1]
    Ilow, Ihigh = st.ahc(mu=0.0, beta=200.0)[0, 1], st.ahc(mu=0.0, beta=0.5)[0, 1]
    assert abs(Ilow - I0) < 1e-3 * abs(I0) + 1e-8
    assert abs(Ihigh) < abs(I0)
    assert scale_err([Ilow, Ihigh], [sj.ahc(mu=0.0, beta=200.0)[0, 1], sj.ahc(mu=0.0, beta=0.5)[0, 1]]) <= 1e-10


def test_requires_full_zone():
    h = ttb.tb_haldane(t2=0.1, device="cpu")
    bz = T.load_bz(T.InversionSymIBZ(), np.eye(2))
    with pytest.raises(ValueError, match="full-zone"):
        tb.BerryCurvatureSolver(h, bz, npt=12)
    with pytest.raises(ValueError, match="full-zone"):
        tb.lattice_chern(h, bz, 12)


def test_chern_grid_convergence(solvers):
    kw = dict(t1=1.0, t2=0.2, phi=np.pi / 3, M=0.3)
    (cj, coarse), (fj, fine) = ((s[0].chern(), s[1].chern()) for s in (solvers("tb_haldane", 24, **kw),
                                                                        solvers("tb_haldane", 96, **kw)))
    assert abs(coarse[0] - round(fine[0])) < 1e-3
    assert abs(fine[0] - round(fine[0])) < 1e-8
    assert scale_err(coarse, cj) <= 1e-10 and scale_err(fine, fj) <= 1e-10


def test_lattice_chern_exact_on_coarse_grid(solvers):
    (hj, ht), (bzj, bzt) = model("tb_haldane", **HALDANE), fbz()
    C = tb.lattice_chern(ht, bzt, 12, bands=[0])
    assert abs(C - round(C)) < 1e-12 and round(C) in (-1, 1)
    assert abs(C - jb.lattice_chern(hj, bzj, 12, bands=[0])) < 1e-12
    assert round(C) == round(float(solvers("tb_haldane", 72, **HALDANE)[1].chern()[0]))
    assert tb.lattice_chern(ht, bzt, 12) == C
    assert round(tb.lattice_chern(ht, bzt, 12, bands=[1])) == -round(C)
    both = tb.lattice_chern(ht, bzt, 12, bands=[0, 1])
    assert round(both) == 0 and abs(both - jb.lattice_chern(hj, bzj, 12, bands=[0, 1])) < 1e-12


def test_lattice_chern_trivial():
    (hj, ht), (bzj, bzt) = model("tb_haldane", t1=1.0, t2=0.1, phi=np.pi / 2, M=1.0), fbz()
    C = tb.lattice_chern(ht, bzt, 16, bands=[0])
    assert round(C) == 0 and abs(C - jb.lattice_chern(hj, bzj, 16, bands=[0])) < 1e-12


def test_orbital_magnetization_streda_slope(solvers):
    sj, st = solvers("tb_haldane", 72, **HALDANE)
    e = st.pack.e.numpy()
    lo, hi = e[:, 0].max(), e[:, 1].min()
    assert hi - lo > 0.3
    C = float(st.chern()[0])
    mus = lo + np.array([0.2, 0.8]) * (hi - lo)
    M = [float(st.orbital_magnetization(mu=m)[0, 1]) for m in mus]
    slope = (M[1] - M[0]) / (mus[1] - mus[0])
    assert abs(slope - C / (2 * np.pi)) < 1e-9
    Mt = st.orbital_magnetization(mu=mus[0])
    assert abs(Mt[0, 1] + Mt[1, 0]) < 1e-12
    assert scale_err(Mt, sj.orbital_magnetization(mu=mus[0])) <= 1e-10


def test_orbital_magnetization_finite_temperature(solvers):
    sj, st = solvers("tb_haldane", 54, **HALDANE)
    m0 = float(st.orbital_magnetization(mu=0.0)[0, 1])
    mlow = float(st.orbital_magnetization(mu=0.0, beta=500.0)[0, 1])
    assert abs(mlow - m0) < 1e-6 + 1e-6 * abs(m0)
    assert scale_err([m0, mlow], [sj.orbital_magnetization(mu=0.0)[0, 1],
                                  sj.orbital_magnetization(mu=0.0, beta=500.0)[0, 1]]) <= 1e-10


def test_orbital_magnetization_trs_zero(solvers):
    sj, st = solvers("tb_graphene", 36)
    assert abs(float(st.orbital_magnetization(mu=0.5)[0, 1])) < 1e-12
    assert abs(float(sj.orbital_magnetization(mu=0.5)[0, 1])) < 1e-12


def test_kane_mele_spin_hall_quantized(solvers):
    sj, st = solvers("tb_kane_mele_sz", 72, lam_so=0.1, M=0.0)
    I_c = float(st.ahc(mu=0.0)[0, 1])
    I_s = float(st.operator_hall(SZ, mu=0.0)[0, 1])
    assert abs(I_c) < 1e-12
    assert abs(I_s - (-1.0) / (2 * np.pi)) < 1e-6
    assert float(st.operator_hall(SZ, mu=0.0)[0, 1]) == I_s  # the operator cache: a pure reduction
    assert abs(I_s - float(np.asarray(sj.operator_hall(SZ, mu=0.0))[0, 1])) <= 1e-10 * abs(I_s)


def test_kane_mele_spin_hall_trivial_phase(solvers):
    sj, st = solvers("tb_kane_mele_sz", 54, lam_so=0.1, M=1.0)
    I_s = float(st.operator_hall(SZ, mu=0.0)[0, 1])
    assert abs(I_s) < 1e-6
    assert abs(I_s - float(np.asarray(sj.operator_hall(SZ, mu=0.0))[0, 1])) <= 1e-12


def test_operator_hall_identity_reduces_to_ahc(solvers):
    sj, st = solvers("tb_haldane", 36, **HALDANE)
    I1 = st.operator_hall(np.eye(2), mu=0.0)
    np.testing.assert_allclose(I1, st.ahc(mu=0.0), atol=1e-12)
    assert scale_err(I1, sj.operator_hall(np.eye(2), mu=0.0)) <= 1e-10


def test_weyl_slice_chern_scan():
    (hj, ht), (bzj, bzt) = model("tb_weyl", m=2.0), fbz()
    kzs = (0.0, 0.2, 0.3, 0.5)
    C = [tb.lattice_chern(ht.contract(kz), bzt, 24, bands=[0]) for kz in kzs]
    assert all(abs(c + 1) < 1e-12 for c in C[:2]), C
    assert all(abs(c) < 1e-12 for c in C[2:]), C
    Cj = [jb.lattice_chern(hj.contract(np.float64(kz)), bzj, 24, bands=[0]) for kz in kzs]
    assert np.max(np.abs(np.subtract(C, Cj))) < 1e-12


def test_berry_flux_through_solve_pipeline():
    """The reference's case: the Chern number through PTR, AutoPTR (at the
    reference's rungs and count) and EvalCounter."""
    (hj, ht), (bzj, bzt) = model("tb_haldane", **HALDANE), fbz()
    fi = tb.berry_flux_integrand(ht)
    detB = np.linalg.det(np.asarray(bzt.B))
    u = float(T.IntegralSolver(T.IntegralProblem(fi, bzt), T.PTR(npt=48, device="cpu"))(mu=0.0))
    assert abs(u / (detB * 2 * np.pi) + 1) < 1e-10
    uj = float(J.IntegralSolver(J.IntegralProblem(jb.berry_flux_integrand(hj), bzj), J.PTR(npt=48))(mu=0.0))
    assert abs(u - uj) <= 1e-12 * abs(uj)
    auto = T.solve(T.IntegralProblem(fi, bzt, TMixed(mu=0.0)), T.AutoPTR(device="cpu"), abstol=1e-6)
    autoj = J.solve(J.IntegralProblem(jb.berry_flux_integrand(hj), bzj, JMixed(mu=0.0)), J.AutoPTR(), abstol=1e-6)
    assert abs(float(auto.u) / (detB * 2 * np.pi) + 1) < 1e-10
    assert abs(float(auto.u) - float(autoj.u)) <= 1e-12 * abs(float(autoj.u))
    assert auto.numevals == autoj.numevals and bool(auto.retcode) == bool(autoj.retcode)
    sol = T.solve(T.IntegralProblem(fi, bzt, TMixed(mu=0.0)), T.EvalCounter(T.PTR(npt=10, device="cpu")))
    solj = J.solve(J.IntegralProblem(jb.berry_flux_integrand(hj), bzj, JMixed(mu=0.0)), J.EvalCounter(J.PTR(npt=10)))
    assert sol.numevals == 100 == solj.numevals
    assert abs(float(sol.u) - float(solj.u)) <= 1e-12 * abs(float(solj.u))


def test_berry_flux_swept_over_mu_matches_reference():
    """A sweep over mu hands the batched integrand one mu per point (PTR's
    lanes, the IAI leaf's lanes): each lane is the reference's solve at its
    mu, and the IAI lanes are the port's single solves with their counts."""
    (hj, ht), (bzj, bzt) = model("tb_haldane", **HALDANE), fbz()
    fi, fij = tb.berry_flux_integrand(ht), jb.berry_flux_integrand(hj)
    mus = np.array([-1.5, 0.0, 1.5])
    got = SweepSolver(T.IntegralProblem(fi, bzt), T.PTR(npt=24, device="cpu"), chunk=3)(mus)
    want = [float(J.IntegralSolver(J.IntegralProblem(fij, bzj), J.PTR(npt=24))(mu=float(mu))) for mu in mus]
    assert scale_err(got, want) <= 1e-12
    us = sweep_solve(T.IntegralProblem(fi, bzt), T.PTR(npt=24, device="cpu"), torch.as_tensor(mus))[0]
    assert scale_err(us.numpy(), want) <= 1e-12
    with pytest.raises(ValueError, match="one mu, or one per point"):
        T.IntegralSolver(T.IntegralProblem(fi, bzt), T.PTR(npt=8, device="cpu"))(mu=torch.zeros(2))
    iai = T.IAI(inner_cap=64, device="cpu")
    sw = SweepSolver(T.IntegralProblem(fi, bzt), iai, abstol=1e-3, chunk=2, scan=True)
    lanes = sw(mus[:2])
    single = [T.solve(T.IntegralProblem(fi, bzt, TMixed(mu=float(mu))), T.EvalCounter(iai), abstol=1e-3)
              for mu in mus[:2]]
    assert sw.retcode and list(sw.lane_numevals) == [s.numevals for s in single]
    assert scale_err(lanes, [float(s.u) for s in single]) <= 1e-12


def test_berry_flux_iai_adaptive():
    (hj, ht), (bzj, bzt) = model("tb_haldane", **HALDANE), fbz()
    detB = np.linalg.det(np.asarray(bzt.B))
    f = T.IntegralSolver(T.IntegralProblem(tb.berry_flux_integrand(ht), bzt), T.IAI(inner_cap=128, device="cpu"),
                         abstol=1e-5)
    u = float(f(mu=0.0))
    assert abs(u / (detB * 2 * np.pi) + 1) < 1e-6
    fj = J.IntegralSolver(J.IntegralProblem(jb.berry_flux_integrand(hj), bzj), J.IAI(inner_cap=128), abstol=1e-5)
    assert abs(u - float(fj(mu=0.0))) <= 1e-9


def test_weyl_3d_ahc_node_separation(solvers):
    sj, st = solvers("tb_weyl", 64, m=2.0)
    I = st.ahc(mu=0.0)
    assert abs(I[0, 1] + 1 / (4 * np.pi)) < 2e-4
    assert abs(I[0, 2]) < 1e-12 and abs(I[1, 2]) < 1e-12
    assert abs(I[0, 1] + I[1, 0]) < 1e-12
    assert abs(I[0, 1] - float(np.asarray(sj.ahc(mu=0.0))[0, 1])) <= 1e-10 * abs(I[0, 1])


def wrap_diff(a, b):
    """max |a - b| modulo 1 (Wilson centres near +-1/2 may wrap either way)."""
    d = np.asarray(a) - np.asarray(b)
    return float(np.max(np.abs(d - np.round(d))))


def test_wilson_loop_center_winding_equals_chern():
    (hj, ht), (bzj, bzt) = model("tb_haldane", **HALDANE), fbz()
    th = tb.wilson_loop_spectrum(ht, 48, bands=[0])
    flow = th[:, 0]
    dd = np.diff(np.concatenate([flow, [flow[0]]]))
    winding = ((dd + 0.5) % 1.0 - 0.5).sum()
    C = tb.lattice_chern(ht, bzt, 24, bands=[0])
    assert abs(winding - round(C)) < 1e-9
    assert wrap_diff(th, jb.wilson_loop_spectrum(hj, 48, bands=[0])) < 1e-10


def test_z2_invariant_kane_mele_phases():
    for (lam, M, npt, want) in ((0.1, 0.0, 48, 1), (0.1, 1.0, 48, 0), (0.02, 0.3, 64, 0)):
        hj, ht = model("tb_kane_mele_sz", lam_so=lam, M=M)
        assert tb.z2_invariant(ht, npt) == want == jb.z2_invariant(hj, npt)


def test_kane_mele_rashba_z2_and_dequantized_spin_hall(solvers):
    np.testing.assert_allclose(ttb.tb_kane_mele(lam_so=0.1, M=0.2, device="cpu").c.numpy(),
                               ttb.tb_kane_mele_sz(lam_so=0.1, M=0.2, device="cpu").c.numpy(), atol=1e-15)
    kw = dict(lam_so=0.06, lam_r=0.05, M=0.0)
    hj, ht = model("tb_kane_mele", **kw)
    assert tb.z2_invariant(ht, 48) == 1
    assert tb.z2_invariant(ttb.tb_kane_mele(lam_so=0.06, lam_r=0.05, M=0.8, device="cpu"), 48) == 0
    assert wrap_diff(tb.wilson_loop_spectrum(ht, 24), jb.wilson_loop_spectrum(hj, 24)) < 1e-10
    sj, st = solvers("tb_kane_mele", 60, **kw)
    I_c = float(st.ahc(mu=0.0)[0, 1])
    I_s = float(st.operator_hall(SZ, mu=0.0)[0, 1])
    assert abs(I_c) < 1e-10
    q = -1 / (2 * np.pi)
    assert abs(I_s - q) > 1e-3 and abs(I_s - q) < 0.2 * abs(q)
    assert abs(I_s - float(np.asarray(sj.operator_hall(SZ, mu=0.0))[0, 1])) <= 1e-10 * abs(I_s)


def test_quantum_metric_curvature_inequality(solvers):
    sj, st = solvers("tb_haldane", 48, **HALDANE)
    g = st.quantum_metric().numpy()
    Om = st.pack.Om.numpy()[:, :, 0, 1]
    np.testing.assert_allclose(g, g.swapaxes(-1, -2), atol=1e-12)
    detg = g[..., 0, 0] * g[..., 1, 1] - g[..., 0, 1] * g[..., 1, 0]
    assert np.all(g[..., 0, 0] >= -1e-12) and np.all(g[..., 1, 1] >= -1e-12)
    assert np.all(detg + 1e-10 >= (Om / 2) ** 2)
    np.testing.assert_allclose(g[:, 0], g[:, 1], atol=1e-10)
    assert st.quantum_metric() is st.quantum_metric()
    assert scale_err(g, sj.quantum_metric()) <= 1e-10


def _bcd_model(lib, M, s=0.0, device=None):
    """The reference test's inversion-probe model, in the package ``lib``."""
    c = np.array(jtb.tb_haldane(t2=0.1, phi=np.pi / 2, M=M).c)
    c[1, 1, 0, 1] *= (1 + s)  # strengthen one NN bond (keeps inversion)
    c[1, 1, 1, 0] *= (1 + s)
    if device is None:
        return J.FourierSeries(c, period=1.0, offset=(-1, -1), ndim=2)
    return T.FourierSeries(c, period=1.0, offset=(-1, -1), ndim=2, device=device)


def test_berry_curvature_dipole_symmetry_anchors():
    (bzj, bzt) = fbz()
    mu_metal, beta = 0.8, 40.0
    for s in (0.0, 0.2):
        D = tb.BerryCurvatureSolver(_bcd_model(ttb, 0.0, s, "cpu"), bzt, npt=72).berry_curvature_dipole(
            mu=mu_metal, beta=beta)
        assert np.abs(D).max() < 1e-14
    slv = tb.BerryCurvatureSolver(_bcd_model(ttb, 0.3, device="cpu"), bzt, npt=96)
    assert np.abs(slv.berry_curvature_dipole(mu=0.0, beta=80.0)).max() < 1e-8
    D96 = slv.berry_curvature_dipole(mu=mu_metal, beta=beta)
    D192 = tb.BerryCurvatureSolver(_bcd_model(ttb, 0.3, device="cpu"), bzt, npt=192).berry_curvature_dipole(
        mu=mu_metal, beta=beta)
    assert np.abs(D96).max() > 1e-3
    np.testing.assert_allclose(D96, D192, atol=1e-8 + 5e-3 * np.abs(D192).max())
    np.testing.assert_allclose(D96, -D96.transpose(0, 2, 1), atol=1e-15)
    Dj = jb.BerryCurvatureSolver(_bcd_model(jtb, 0.3), bzj, npt=96).berry_curvature_dipole(mu=mu_metal, beta=beta)
    assert scale_err(D96, Dj) <= 1e-10


def test_synthetic_wannier_hermitian_even_nr():
    for nr in (3, 4, 5, 6):
        h = ttb.synthetic_wannier(3, nr=nr, ndim=2, seed=1, device="cpu")
        H = h(np.array([0.13, 0.37])).numpy()
        assert np.abs(H - H.conj().T).max() < 1e-12, nr
        assert np.abs(h.c.numpy() - np.asarray(jtb.synthetic_wannier(3, nr=nr, ndim=2, seed=1).c)).max() == 0.0


def test_quantum_metric_degtol_not_stale():
    (hj, ht), (bzj, bzt) = model("tb_haldane", **HALDANE), fbz()
    slv = tb.BerryCurvatureSolver(ht, bzt, npt=12)
    g1 = slv.quantum_metric(degtol=1e-8).numpy()
    g2 = slv.quantum_metric(degtol=1e3).numpy()
    assert np.abs(g2).max() == 0.0 and np.abs(g1).max() > 0.0


def test_anomalous_nernst_mott_relation(solvers):
    sj, st = solvers("tb_haldane", 200, t2=0.1)
    mu, beta = 0.8, 200.0
    N = float(st.anomalous_nernst(mu=mu, beta=beta)[0, 1])
    d = 1e-3
    Ip = float(st.ahc(mu=mu + d, beta=beta)[0, 1])
    Im_ = float(st.ahc(mu=mu - d, beta=beta)[0, 1])
    mott = (np.pi**2 / (3 * beta)) * (Ip - Im_) / (2 * d)
    assert abs(N - mott) < 5e-3 * abs(mott)
    assert abs(float(st.anomalous_nernst(mu=0.0, beta=beta)[0, 1])) < 1e-20
    assert abs(N - float(np.asarray(sj.anomalous_nernst(mu=mu, beta=beta))[0, 1])) <= 1e-10 * abs(N)


@pytest.mark.parametrize("what,kw", [
    ("chern", dict(abstol=1e-4, nmin=18, nmax=240)),
    ("chern", dict(abstol=1e-12, nmin=12, nmax=30)),
    ("ahc", dict(abstol=1e-4, nmin=18, nmax=240, mu=0.0, beta=None)),
], ids=["chern_haldane", "honest_truncation", "ahc_kwargs"])
def test_certified_berry(what, kw):
    """The reference's three certified_berry cases on the port, with the rung
    sequence and the retcode of the reference's ladder."""
    (hj, ht), (bzj, bzt) = model("tb_haldane", **HALDANE), fbz()
    res = tb.certified_berry(ht, bzt, what=what, **kw)
    resj = jb.certified_berry(hj, bzj, what=what, **kw)
    assert res.npts == resj.npts and res.retcode == resj.retcode
    assert scale_err(res.u, resj.u) <= 1e-10
    u = np.asarray(res.u)
    if kw["abstol"] == 1e-12:
        assert not res.retcode and res.resid > 1e-12 and res.npts[-1] >= 30
    elif what == "chern":
        assert res.retcode
        exact = np.array([1.0, -1.0]) * np.sign(u[0])
        assert np.all(np.abs(u - exact) <= max(res.resid, 1e-4))
        assert abs(abs(u[0]) - 1) < 1e-4 and abs(u[0] + u[1]) < 1e-9
        assert len(res.npts) >= 2 and res.npts[-1] > res.npts[0]
    else:
        assert res.retcode and abs(abs(u[0, 1]) - 1 / (2 * np.pi)) < 2e-4


# --- beyond the reference's cases --------------------------------------------------------------


@pytest.mark.parametrize("name,npt,kw", [
    ("tb_haldane", 24, HALDANE),
    ("tb_haldane", 24, dict(t2=0.2, phi=np.pi / 3, M=0.3)),
    ("tb_graphene", 24, {}),
    ("tb_weyl", 12, dict(m=2.0)),
], ids=["haldane", "haldane_massive", "graphene", "weyl3d"])
def test_pack_matches_reference(solvers, name, npt, kw):
    """Pointwise pack parity (e, Om, Mm, vd and the metric, 1e-10 of
    max|F|): gauge-invariant fields of nondegenerate bands. tb_weyl(2) puts
    its nodes on the grid (k = (0, 0, +-1/4)); both packages mask the same
    pairs there."""
    sj, st = solvers(name, npt, **kw)
    g, gj = st.quantum_metric().numpy(), np.asarray(sj.quantum_metric())
    assert scale_err(g, gj) <= 1e-10
    for f in ("e", "Om", "Mm", "vd"):
        got, want = getattr(st.pack, f).numpy(), np.asarray(getattr(sj.pack, f))
        # Om and Mm are the imaginary parts of the pair sums whose real part is
        # the metric: where they vanish by symmetry (graphene), the sums' scale
        # is the metric's
        scale = max(np.abs(want).max(), np.abs(gj).max() if f in ("Om", "Mm") else 0.0)
        assert np.abs(got - want).max() <= 1e-10 * scale, f
    assert st.pack.ndim == sj.pack.ndim and st.pack.npt == sj.pack.npt


def test_kane_mele_queries_match_reference(solvers):
    """Kane-Mele at M = 0 is doubly degenerate at every k: only its
    occupied-band queries are comparable, not its per-band fields."""
    sj, st = solvers("tb_kane_mele_sz", 24, lam_so=0.1, M=0.0)
    assert np.max(np.abs(st.ahc(mu=0.0) - np.asarray(sj.ahc(mu=0.0)))) < 1e-12
    assert scale_err(st.operator_hall(SZ, mu=0.0), sj.operator_hall(SZ, mu=0.0)) <= 1e-10
    assert scale_err(st.operator_hall(SZ, mu=0.0, beta=30.0), sj.operator_hall(SZ, mu=0.0, beta=30.0)) <= 1e-10
    assert scale_err(st.operator_hall(SZ, mu=0.0, beta=np.inf), sj.operator_hall(SZ, mu=0.0, beta=np.inf)) <= 1e-10
    assert scale_err(st.pack.e.numpy(), np.asarray(sj.pack.e)) <= 1e-10


QUERIES = {
    "chern": ("chern", {}),
    "ahc_step": ("ahc", dict(mu=0.1)),
    "ahc_fermi": ("ahc", dict(mu=0.8, beta=7.0)),
    "ahc_beta_inf": ("ahc", dict(mu=0.1, beta=np.inf)),
    "nernst": ("anomalous_nernst", dict(mu=0.8, beta=25.0)),
    "nernst_cold": ("anomalous_nernst", dict(mu=0.3, beta=400.0)),
    "dipole": ("berry_curvature_dipole", dict(mu=0.8, beta=40.0)),
    "orbital_zero_t": ("orbital_magnetization", dict(mu=0.2)),
    "orbital_finite_t": ("orbital_magnetization", dict(mu=0.9, beta=30.0)),
}


@pytest.fixture(scope="module")
def identical_packs():
    """The reference's pack of the inversion-broken Haldane model (npt 48,
    a skewed lattice), carried into the port by berry_pack_from_arrays."""
    A = np.array([[1.0, 0.5], [0.0, 2.0]])
    (hj, _), (bzj, bzt) = model("tb_haldane", t2=0.1, phi=np.pi / 2, M=0.3), fbz(2, A)
    sj = jb.BerryCurvatureSolver(hj, bzj, 48)
    arrays = tuple(np.asarray(x) for x in sj.pack[:4]) + (sj.pack.ndim, sj.pack.npt)
    st = tb.BerryCurvatureSolver(None, bzt, 48, pack=berry_pack_from_arrays(*arrays, device="cpu"))
    return sj, st, arrays


@pytest.mark.parametrize("case", list(QUERIES))
def test_zone_average_on_identical_packs(identical_packs, case):
    """K24's plain version (every weight mode: step, Fermi, entropy, -df/de
    x vd, grand potential, per band) against the reference's queries on the
    same pack: 1e-13 of the result's scale (the two sum in other orders)."""
    sj, st, _ = identical_packs
    name, kw = QUERIES[case]
    got, want = getattr(st, name)(**kw), np.asarray(getattr(sj, name)(**kw))
    assert got.shape == want.shape
    assert float(np.max(np.abs(want))) > 1e-6
    assert scale_err(got, want) <= 1e-13


def test_pack_round_trip(identical_packs):
    _, st, arrays = identical_packs
    back = berry_pack_to_arrays(st.pack)
    assert all(np.array_equal(a, b) for a, b in zip(back[:4], arrays[:4])) and back[4:] == arrays[4:]


def test_entropy_weight_is_exact_above_softplus_threshold():
    """torch's softplus returns x above its threshold of 20, which would put a
    ~4 % error into the entropy weight near x = 25; the port's form is the
    reference's logaddexp(x, 0) at every x."""
    import jax

    x = np.linspace(-60.0, 60.0, 481)
    e = torch.as_tensor(x[None, :] / 2.0)
    got = tb.zone_weights(e, "entropy", mu=0.0, beta=2.0).numpy()[0]
    want = np.asarray(jax.nn.softplus(x) - x * jax.nn.sigmoid(x))
    assert np.max(np.abs(got - want) / np.maximum(np.abs(want), 1e-300)) <= 1e-12
    grand = tb.zone_weights(e, "grand", mu=0.0, beta=2.0).numpy()[0]
    assert np.max(np.abs(grand - np.asarray(jax.nn.softplus(-x)) / 2.0) / np.abs(grand)) <= 1e-12


def test_lattice_chern_field_is_gauge_invariant():
    """K22's plain version on frames from the closed-form eigh2 and from
    LAPACK's eigh (the reference's choice at berry.py:314): the same field to
    rounding, though the frames' phases differ."""
    from autobzcore_torch.ops.eigh3 import eigh2
    from autobzcore_torch.ops.fourier_eval import evaluate_grid

    h = ttb.tb_haldane(t2=0.2, phi=np.pi / 3, M=0.3, device="cpu")
    u = [np.arange(20) / 20, np.arange(18) / 18]
    H = evaluate_grid(h.c, 2, u, h.offset, h.period)
    V1 = eigh2(H)[1][..., :1].contiguous()
    V2 = torch.linalg.eigh(H)[1][..., :1].contiguous()
    assert float((V1 - V2).abs().max()) > 1e-3  # different gauges
    F1, F2 = float(tb.plaquette_flux(V1)), float(tb.plaquette_flux(V2))
    assert abs(F1 - F2) < 1e-12 and abs(F1 / (2 * np.pi) - round(F1 / (2 * np.pi))) < 1e-12
    W1, W2 = tb.wilson_loops(V1), tb.wilson_loops(V2)
    assert float((W1 - W2).abs().max()) < 1e-12  # nb = 1: the loop is a gauge-invariant number


def test_example_point_mode_matches_reference(tmp_path):
    """``examples/topology_example_torch.py point --device cpu --npt 24``: the
    printed Chern number, I_xy and Streda slope against the reference's
    solver at the same npt."""
    env = dict(os.environ, JAX_PLATFORMS="cpu", OMP_NUM_THREADS="2")
    example = Path(__file__).resolve().parents[1] / "examples" / "topology_example_torch.py"
    out = subprocess.run([sys.executable, str(example), "point", "--device", "cpu", "--npt", "24"],
                         capture_output=True, text=True, timeout=300, env=env, cwd=tmp_path)
    assert out.returncode == 0, out.stderr[-2000:]
    lines = out.stdout.splitlines()
    I_xy = float(next(ln for ln in lines if "I_xy =" in ln).split("= ")[1].split(" ")[0])
    slope = float(next(ln for ln in lines if "dM/dmu" in ln).split("= ")[1].split(" ")[0])
    lc = float(next(ln for ln in lines if "Wilson-loop C" in ln).split(": ")[1])
    hj, _ = model("tb_haldane", t2=0.1, phi=np.pi / 2, M=0.0)
    sj = jb.BerryCurvatureSolver(hj, fbz()[0], 24)
    Cj = np.asarray(sj.chern())
    e = np.asarray(sj.pack.e)
    lo = e[:, 0].max()
    slope_j = (float(np.asarray(sj.orbital_magnetization(mu=lo + 0.3))[0, 1])
               - float(np.asarray(sj.orbital_magnetization(mu=lo + 0.1))[0, 1])) / 0.2
    assert I_xy == pytest.approx(float(np.asarray(sj.ahc(mu=0.0))[0, 1]), rel=1e-10)
    assert slope == pytest.approx(slope_j, rel=1e-9) and slope == pytest.approx(Cj[0] / (2 * np.pi), rel=1e-8)
    assert lc == round(jb.lattice_chern(hj, fbz()[0], 12))
    assert "min(det g - (Om/2)^2)" in out.stdout


def test_entry_points_default_to_the_card():
    if torch.cuda.is_available():
        pytest.skip("the default device exists here")
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        ttb.tb_weyl()
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        ttb.tb_kane_mele_sz()
    example = Path(__file__).resolve().parents[1] / "examples" / "topology_example_torch.py"
    out = subprocess.run([sys.executable, str(example), "point", "--npt", "8"], capture_output=True, text=True,
                         timeout=120, env=dict(os.environ, JAX_PLATFORMS="cpu"))
    assert out.returncode != 0 and "CUDA is not available" in out.stderr


def test_berry_flux_under_tai_matches_reference():
    """The batched flux integrand under TAI's box pool (one call per trip):
    the reference's value and evaluation count."""
    (hj, ht), (bzj, bzt) = model("tb_haldane", **HALDANE), fbz()
    sol = T.solve(T.IntegralProblem(tb.berry_flux_integrand(ht), bzt, TMixed(mu=0.0)), T.TAI(device="cpu"),
                  abstol=1e-4)
    solj = J.solve(J.IntegralProblem(jb.berry_flux_integrand(hj), bzj, JMixed(mu=0.0)), J.TAI(), abstol=1e-4)
    assert sol.numevals == solj.numevals
    assert abs(float(sol.u) - float(solj.u)) <= 1e-10 * abs(float(solj.u))
    detB = np.linalg.det(np.asarray(bzt.B))
    assert abs(float(sol.u) / (detB * 2 * np.pi) + 1) < 1e-3
