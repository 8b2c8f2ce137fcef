"""Parity of the port's linear tetrahedron method (``autobzcore_torch.dos.LTM``,
kernel K10's plain version ``tetra_dos_plain``) with the JAX package's
``LTM`` on the CPU: every LTM case of the reference's
``tests/test_tetrahedron.py:20-105`` through both packages, then the
flagship series at npt = 16.

DOS and N(E) agree within 1e-12 relative (1e-14 absolute where the value is
near 0: the two packages sum the same terms in another order), values
outside the bands are exactly 0.0 in both, ``numevals`` are identical and
Fermi levels agree within 1e-10. At an energy equal to a grid eigenvalue the
one-sided closed form turns on the eigenvalue's last bit, where H(k) of the
two packages differs by an ulp (ROADMAP C), so such energies are held to
the band-count check only. Also here: C1's route for m > 3 PTR sums
(eigenvalues, then K8's plain version) against the JAX ``dos_trace`` PTR
sum."""
import os
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest
import torch

import autobzcore_torch as T
import autobzcore_tpu as J
from autobzcore_torch import dos as tdos
from autobzcore_torch.dos import tetrahedron as ttet
from autobzcore_torch.models import observables as tobs
from autobzcore_torch.models import tight_binding as ttb
from autobzcore_tpu import dos as jdos
from autobzcore_tpu.models import tight_binding as jtb
from test_dos import dos_graphene_exact, dos_integer_1d_exact, dos_integer_2d_exact, dos_integer_3d_exact

torch.set_num_threads(2)

CASES = [
    ("int1d", 1, dos_integer_1d_exact, 2, "FBZ", 400),
    ("int2d", 2, dos_integer_2d_exact, 4, "FBZ", 150),
    ("int3d", 3, dos_integer_3d_exact, 6, "FBZ", 60),
    ("int2d", 2, dos_integer_2d_exact, 4, "InversionSymIBZ", 150),
    ("int3d", 3, dos_integer_3d_exact, 6, "CubicSymIBZ", 60),
    ("graphene", 2, dos_graphene_exact, 4, "FBZ", 150),
]
SAMPLE = (-0.85, -0.55, -0.3, 0.2, 0.45, 0.75)


def _models(name, ndim):
    if name == "graphene":
        return jtb.tb_graphene(), ttb.tb_graphene(device="cpu")
    return jtb.tb_integer(ndim), ttb.tb_integer(ndim, device="cpu")


def _caches(name, ndim, kind, npt, domain=0.0, models=None):
    jm, tm = models or _models(name, ndim)
    jc = jdos.init(J.DOSProblem(jm, domain, J.load_bz(getattr(J, kind)(), np.eye(ndim))), jdos.LTM(npt=npt))
    tc = tdos.init(T.DOSProblem(tm, domain, T.load_bz(getattr(T, kind)(), np.eye(ndim))), tdos.LTM(npt=npt))
    return jc, tc


def _same(got, want, Es=None, cache=None):
    """1e-12 relative, 1e-14 absolute near 0, and exact zeros where the
    reference is exactly zero; with ``Es`` and the port's ``cache``, only at
    energies that are not grid eigenvalues to 1e-12."""
    got, want = np.asarray(got, np.float64), np.asarray(want, np.float64)
    assert got.shape == want.shape
    keep = np.ones(got.shape, dtype=bool)
    if Es is not None:
        e = np.unique(cache.cacheval["eg"].numpy())
        i = np.clip(np.searchsorted(e, Es), 1, len(e) - 1)
        near = np.minimum(np.abs(Es - e[i - 1]), np.abs(Es - e[i]))
        keep = near > 1e-12 * (e[-1] - e[0])
        assert keep.mean() > 0.99
    assert np.all((np.abs(got - want) <= 1e-12 * np.abs(want) + 1e-14)[keep])
    assert np.array_equal(got == 0.0, want == 0.0)


@pytest.mark.parametrize("name,ndim,exact,bandwidth,kind,npt", CASES)
def test_ltm_vs_exact_matches_reference(name, ndim, exact, bandwidth, kind, npt):
    jc, tc = _caches(name, ndim, kind, npt)
    assert tc.cacheval["numevals"] == jc.cacheval["numevals"]
    Es = np.array([f * bandwidth for f in SAMPLE] + [bandwidth + 1.0, -bandwidth - 1.0])
    got = tdos.LTM(npt).dos_sweep(tc.cacheval, Es)
    _same(got, jdos.LTM(npt).dos_sweep(jc.cacheval, Es))
    for e, g in zip(Es[:6], got):
        assert g == pytest.approx(exact(e), abs=2e-2), f"E={e}"
    # outside the band: exactly zero (no broadening tails), pointwise too
    assert got[-1] == got[-2] == 0.0
    tc.domain = bandwidth + 1.0
    sol = tdos.solve_(tc)
    assert sol.u == 0.0 and sol.retcode and sol.numevals == jc.cacheval["numevals"]
    _same(tdos.LTM(npt).nos_sweep(tc.cacheval, Es), jdos.LTM(npt).nos_sweep(jc.cacheval, Es))


def test_ltm_symmetry_scatter_exact():
    """The symmetry-reduced eigensolve and orbit scatter give the full
    grid's value, in both packages."""
    vals = []
    for kind in ("FBZ", "CubicSymIBZ"):
        jc, tc = _caches("int3d", 3, kind, 24, domain=0.8)
        jv, tv = float(jdos.solve_(jc).u), float(tdos.solve_(tc).u)
        assert tv == pytest.approx(jv, rel=1e-12)
        vals.append(tv)
    assert vals[0] == pytest.approx(vals[1], rel=1e-12)


def test_ltm_band_normalization():
    """Each band carries unit fractional weight: the integral of D(E) is the
    band count (graphene: 2)."""
    jc, tc = _caches("graphene", 2, "FBZ", 60)
    Es = np.linspace(-4.0, 4.0, 3001)
    D = tdos.LTM(60).dos_sweep(tc.cacheval, Es)
    _same(D, jdos.LTM(60).dos_sweep(jc.cacheval, Es), Es, tc)  # E = +-1 are eigenvalues of the grid
    assert np.trapezoid(D, Es) == pytest.approx(2.0, abs=2e-2)


def test_ltm_sweep_matches_pointwise():
    jc, tc = _caches("int2d", 2, "InversionSymIBZ", 80)
    Es = np.linspace(-4.5, 4.5, 61)
    sweep = tdos.LTM(80).dos_sweep(tc.cacheval, Es)
    _same(sweep, jdos.LTM(80).dos_sweep(jc.cacheval, Es))
    for i in (5, 30, 55):
        tc.domain = Es[i]
        assert tdos.solve_(tc).u == pytest.approx(sweep[i], rel=1e-12)


def test_ltm_nos_and_fermi_level():
    """N(E) is the closed-form integral of D(E); half filling of a
    particle-hole-symmetric band pins E_F at the band center."""
    jc, tc = _caches("int2d", 2, "FBZ", 100)
    alg, jalg = tdos.LTM(100), jdos.LTM(100)
    Es = np.linspace(-5.0, 5.0, 501)
    N = alg.nos_sweep(tc.cacheval, Es)
    _same(N, jalg.nos_sweep(jc.cacheval, Es))
    assert N[0] == 0.0 and N[-1] == pytest.approx(1.0, abs=1e-12)
    assert np.all(np.diff(N) >= -1e-12)  # monotone
    D = alg.dos_sweep(tc.cacheval, Es)
    mask = (np.abs(Es) > 0.5) & (np.abs(Es) < 3.5)
    assert np.allclose(np.gradient(N, Es)[mask], D[mask], atol=5e-2)
    for nstates in (0.5, 0.95, 0.3):
        ef = alg.fermi_level(tc.cacheval, nstates)
        assert ef == pytest.approx(jalg.fermi_level(jc.cacheval, nstates), abs=1e-10)
    assert alg.fermi_level(tc.cacheval, 0.5) == pytest.approx(0.0, abs=1e-3)
    assert alg.fermi_level(tc.cacheval, 0.95) > 2.0


def test_flagship_ltm_matches_reference():
    """The slice as a whole: the flagship 3-band series on the full zone
    through DOSProblem, init, dos_sweep, nos_sweep and fermi_level, npt 16."""
    import jax.numpy as jnp

    import __graft_entry__

    models = (__graft_entry__._flagship_series(jnp.complex128), ttb.flagship_series(device="cpu"))
    jc, tc = _caches(None, 3, "FBZ", 16, models=models)
    assert tc.cacheval["numevals"] == jc.cacheval["numevals"] == 16**3
    Es = np.linspace(-6.0, 7.0, 131)
    _same(tdos.LTM(16).dos_sweep(tc.cacheval, Es), jdos.LTM(16).dos_sweep(jc.cacheval, Es))
    N = tdos.LTM(16).nos_sweep(tc.cacheval, Es)
    _same(N, jdos.LTM(16).nos_sweep(jc.cacheval, Es))
    assert N[-1] == pytest.approx(3.0, abs=1e-12)
    assert tdos.LTM(16).fermi_level(tc.cacheval, 1.5) == pytest.approx(
        jdos.LTM(16).fermi_level(jc.cacheval, 1.5), abs=1e-10)


@pytest.mark.parametrize("d,npt", [(1, 13), (2, 12), (3, 7)])
def test_corners_are_the_reference_corners(d, npt):
    """The plain version's sorted corners equal the reference's corner build
    (``tetrahedron.py:196-214``, rolls, a stack and the exchange network in
    jnp) on the same eigenvalue grid bit for bit, as K10's in-register
    corners do (min and max are exact)."""
    import jax.numpy as jnp

    from autobzcore_tpu.dos.tetrahedron import _SIMPLICES as JSIMPLICES

    eg = np.random.default_rng(d).normal(size=(2, npt**d))
    eg[:, ::3] = 0.5  # ties
    g = jnp.asarray(eg).reshape((2,) + (npt,) * d)
    cs = jnp.stack([jnp.roll(g, tuple(-((v >> j) & 1) for j in range(d)), axis=tuple(range(1, d + 1)))
                    for v in range(2**d)]).reshape(2**d, -1)
    vs = [jnp.stack([cs[sx[k]] for sx in JSIMPLICES[d]]) for k in range(d + 1)]
    nets = {2: [(0, 1)], 3: [(0, 1), (1, 2), (0, 1)], 4: [(0, 1), (2, 3), (0, 2), (1, 3), (1, 2)]}
    for i, j in nets[d + 1]:
        vs[i], vs[j] = jnp.minimum(vs[i], vs[j]), jnp.maximum(vs[i], vs[j])
    np.testing.assert_array_equal(ttet.sorted_corners(torch.as_tensor(eg), d).numpy(), np.asarray(jnp.stack(vs)))


def test_tetra_wrapper_takes_plain_version_on_cpu_without_counting():
    eg = torch.as_tensor(np.random.default_rng(0).normal(size=(2, 64)))
    E = torch.linspace(-3, 3, 9, dtype=torch.float64)
    before = ttet.tetra_dos.launches
    got = ttet.tetra_dos(eg, 2, E, 1e-9, 1 / 128)
    assert ttet.tetra_dos.launches == before
    assert torch.equal(got, ttet.tetra_dos_plain(eg, 2, E, 1e-9, 1 / 128))
    with pytest.raises(ValueError):
        ttet.tetra_dos(eg, 4, E, 1e-9, 1.0)
    with pytest.raises(ValueError):
        ttet.tetra_dos(eg.to(torch.float32), 2, E, 1e-9, 1.0)
    with pytest.raises(ValueError):
        ttet.tetra_dos(eg[:, :63].contiguous(), 2, E, 1e-9, 1.0)


def test_ltm_refuses_what_it_does_not_take():
    alg = tdos.LTM(8)
    bz = T.load_bz(T.FBZ(), np.eye(2))
    with pytest.raises(TypeError):
        alg.init_cacheval(np.zeros((3, 3)), 0.0, bz)
    with pytest.raises(TypeError):
        alg.init_cacheval(ttb.tb_integer(2, device="cpu"), 0.0, None)
    cache = tdos.init(T.DOSProblem(ttb.tb_integer(2, device="cpu"), np.zeros(2), bz), alg)
    with pytest.raises(TypeError):
        tdos.solve_(cache)


@pytest.mark.parametrize("m", [4, 5])
def test_four_band_ptr_route_matches_reference(m):
    """C1's route on CPU tensors: the eigenvalues of H(k) on the rule and
    K8's plain version with scale/pi, against the JAX package's dos_trace
    PTR sum over several etas."""
    from autobzcore_tpu.models.observables import dos_trace as jdos_trace

    npt = 10
    xs = np.linspace(-3.0, 3.0, 17)
    etas = np.where(np.arange(17) % 3 == 0, 0.2, 0.07)
    jprob = J.IntegralProblem(J.FourierIntegrand(jdos_trace, jtb.synthetic_wannier(m, nr=3), eta=etas),
                              J.load_bz(J.FBZ(), np.eye(3)), xs)
    want = np.asarray(J.solve(jprob, J.PTR(npt=npt)).u)
    tprob = T.IntegralProblem(tobs.dos_integrand(ttb.synthetic_wannier(m, nr=3, device="cpu"), etas),
                              T.load_bz(T.FBZ(), np.eye(3)), xs)
    cache = T.init(tprob, T.PTR(npt=npt, device="cpu"))
    w, H = cache.cacheval["inner"]["consts"]
    scale = (2 * np.pi) ** 3 / npt**3
    got = tobs.dos_eig_weighted_sum(H, w, torch.as_tensor(xs), torch.as_tensor(etas), scale)
    assert np.max(np.abs(got.numpy() - want)) <= 1e-12 * np.max(np.abs(want))
    # and the CPU's trace form through the public wrapper
    assert np.max(np.abs(T.solve(tprob, T.PTR(npt=npt, device="cpu")).u.numpy() - want)) <= 1e-12 * np.max(
        np.abs(want))


def test_example_runs_ltm_leg_on_cpu(tmp_path):
    env = dict(os.environ, JAX_PLATFORMS="cpu", OMP_NUM_THREADS="2")
    example = Path(__file__).resolve().parents[1] / "examples" / "aps_example_torch.py"
    out = subprocess.run([sys.executable, str(example), "--flagship", "--device", "cpu", "--skip-ptr",
                          "--with-ltm", "--npt", "12", "--out", str(tmp_path / "dos.npz")],
                         capture_output=True, text=True, timeout=300, env=env, cwd=tmp_path)
    assert out.returncode == 0, out.stderr[-2000:]
    assert "LTM(npt=12) sharp DOS (1001 omegas)" in out.stderr
    assert out.stdout.startswith("LTM DOS(0.5 eV) = ")
    saved = np.load(tmp_path / "dos.npz")["dos_ltm"]
    # each of the three bands integrates to |det B| over the window, which holds them
    assert saved.shape == (1001,) and np.trapezoid(saved, np.linspace(-6, 7, 1001)) == pytest.approx(
        3 * (2 * np.pi) ** 3, rel=2e-2)
