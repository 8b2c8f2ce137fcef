"""Parity of the port's Lindhard family (``models.lindhard``: LindhardSolver,
cooper_bubble and certified_chi0, through the plain versions of kernels
K25 and K26) with the JAX package on the CPU: every case of
``tests/test_lindhard.py`` on the port, then chi0 and the Cooper bubble on
both packages at the same numpy-built models (series crossed by
``interop.series_from_arrays`` where the JAX package builds them), and the
certified ladder's rungs.

Tolerances: chi0 1e-12 of max|chi0| over the curve (both sums run over
the same terms in another order; the eigenvectors' phases differ between
LAPACK builds, but |<u_n(k)|u_m(k+q)>|^2 does not depend on them away from
degeneracies, and the flagship's degenerate points carry a weight that
sums over the block); the Cooper bubble 1e-12 relative; the ladder's rungs
and retcodes identical, its resid 1e-12 of the curve's scale. Every
physical anchor at the reference test's own tolerance."""
import numpy as np
import pytest
import torch

import autobzcore_torch as T
import autobzcore_tpu as J
from autobzcore_torch.interop import series_from_arrays
from autobzcore_torch.models import lindhard as tl
from autobzcore_torch.models import tight_binding as ttb
from autobzcore_torch.models.transport import fermi as tfermi
from autobzcore_tpu.models import lindhard as jl
from autobzcore_tpu.models import tight_binding as jtb

torch.set_num_threads(2)


def fbz(d=2, A=None):
    A = np.eye(d) if A is None else A
    return J.load_bz(J.FBZ(), A), T.load_bz(T.FBZ(), A)


def model(name, **kw):
    """The same model in both packages: the JAX package's series, crossed
    into the port by its numpy fields."""
    if name == "flagship":
        import jax.numpy as jnp

        import __graft_entry__

        hj = __graft_entry__._flagship_series(jnp.complex128)
    else:
        hj = getattr(jtb, name)(**kw)
    return hj, series_from_arrays(np.asarray(hj.c), hj.offset, hj.period, hj.sndim, device="cpu")


def curve_err(got, want):
    got, want = np.asarray(got), np.asarray(want)
    return float(np.max(np.abs(got - want)) / np.max(np.abs(want)))


# --- the reference's cases on the port ----------------------------------------------------


def test_static_long_wavelength_compressibility():
    _, bz = fbz()
    beta, mu, npt = 20.0, 0.5, 96
    slv = tl.LindhardSolver(ttb.tb_integer(2, device="cpu"), bz, npt, beta, mu=mu, eta=1e-3)
    chi = complex(slv([1 / npt, 0.0], [0.0])[0])
    f = tfermi(beta * (slv._e - mu)).numpy()
    ref = -beta * slv._vol * np.mean(f * (1 - f))
    assert chi.real == pytest.approx(ref, rel=2e-2)
    assert abs(chi.imag) < 1e-10


def test_inversion_symmetry():
    _, bz = fbz()
    slv = tl.LindhardSolver(ttb.tb_integer(2, device="cpu"), bz, 64, beta=20.0, mu=0.5, eta=1e-3)
    c1 = complex(slv([0.25, 0.125], [0.7])[0])
    c2 = complex(slv([-0.25, -0.125], [0.7])[0])
    assert c1 == pytest.approx(c2, rel=1e-10)


def test_particle_hole_continuum_onset():
    _, bz = fbz()
    slv = tl.LindhardSolver(ttb.tb_haldane(t2=0.1, M=0.3, device="cpu"), bz, 96, beta=500.0, mu=0.0, eta=1e-3)
    c = slv([0.25, 0.0], [0.3, 2.0])
    assert abs(c[0].imag) < 5e-3
    assert abs(c[1].imag) > 10.0
    assert np.all(c.imag <= 1e-12)


def test_requires_full_zone():
    with pytest.raises(ValueError, match="full-zone"):
        tl.LindhardSolver(ttb.tb_integer(2, device="cpu"), T.load_bz(T.InversionSymIBZ(), np.eye(2)), 16, beta=10.0)


def test_q_dimension_validated():
    _, bz = fbz()
    slv = tl.LindhardSolver(ttb.tb_integer(2, device="cpu"), bz, 16, beta=10.0)
    with pytest.raises(ValueError, match="components"):
        slv([0.25, 0.0, 0.1], [0.0])
    with pytest.raises(ValueError, match="components"):
        tl.cooper_bubble(slv, [0.25])


def test_cooper_bubble_logarithm():
    from autobzcore_torch.dos import GGR, DOSProblem
    from autobzcore_torch.dos import init as dos_init
    from autobzcore_torch.dos import solve_ as dos_solve_

    _, bz = fbz()
    h = ttb.tb_integer(2, device="cpu")
    mu = 0.5
    chi = {b: tl.cooper_bubble(tl.LindhardSolver(h, bz, 384, b, mu=mu)) for b in (50.0, 100.0)}
    D = float(np.asarray(dos_solve_(dos_init(DOSProblem(h, mu, bz), GGR(npt=400))).u))
    expected = np.linalg.det(np.asarray(bz.B)) * D * np.log(2)
    assert chi[100.0] - chi[50.0] == pytest.approx(expected, rel=2e-2)
    chi_q = tl.cooper_bubble(tl.LindhardSolver(h, bz, 384, 100.0, mu=mu), q=[0.25, 0.0])
    assert chi_q < chi[100.0]


def test_certified_chi0_converges_and_bounds_error():
    h = ttb.tb_integer(2, device="cpu")
    _, bz = fbz(A=2 * np.pi * np.eye(2))
    q, oms = [0.25, 0.0], np.linspace(0.0, 2.0, 9)
    res = tl.certified_chi0(h, bz, q, oms, beta=8.0, eta=0.2, abstol=5e-4, nmin=16, nmax=256)
    assert res.retcode
    assert all(n % 4 == 0 for n in res.npts)
    ref = tl.LindhardSolver(h, bz, 512, beta=8.0, eta=0.2)(q, oms)
    assert float(np.max(np.abs(res.u - ref))) <= max(res.resid * 3, 5e-4)


def test_certified_chi0_truncation():
    _, bz = fbz(A=2 * np.pi * np.eye(2))
    res = tl.certified_chi0(ttb.tb_integer(2, device="cpu"), bz, [0.5, 0.0], np.asarray([0.5]), beta=50.0,
                            eta=1e-3, abstol=1e-12, nmin=8, nmax=24)
    assert not res.retcode


# --- parity with the JAX package ------------------------------------------------------------

CASES = {
    "integer2": ("tb_integer", dict(n=2), 2, 32, 20.0, 0.5),
    "haldane": ("tb_haldane", dict(t2=0.1, M=0.3), 2, 32, 20.0, 0.2),
    "flagship": ("flagship", {}, 3, 12, 40.0, 0.1),
}
QS = {2: {"on": [0.25, 0.125], "off": [0.3, -0.11], "negative": [-0.25, -0.375]},
      3: {"on": [0.25, 1 / 12, 0.0], "off": [0.3, -0.11, 0.52], "negative": [-0.25, -1 / 6, -0.5]}}


@pytest.fixture(scope="module")
def solvers():
    cache = {}

    def get(case):
        if case not in cache:
            name, kw, d, npt, beta, mu = CASES[case]
            (hj, ht), (bzj, bzt) = model(name, **kw), fbz(d)
            cache[case] = (jl.LindhardSolver(hj, bzj, npt, beta, mu=mu, eta=1e-2),
                           tl.LindhardSolver(ht, bzt, npt, beta, mu=mu, eta=1e-2))
        return cache[case]

    return get


@pytest.mark.parametrize("case", sorted(CASES))
@pytest.mark.parametrize("qkind", ["on", "off", "negative"])
def test_chi0_matches_reference(solvers, case, qkind):
    """chi0 over 17 frequencies at a q on the grid, off it (snapped) and
    negative (wrapped): 1e-12 of max|chi0|."""
    sj, st = solvers(case)
    q = QS[sj.ndim][qkind]
    om = np.linspace(0.0, 4.0, 17)
    want = np.asarray(sj(q, om))
    got = st(q, om)
    assert got.dtype == np.complex128 and got.shape == (17,)
    assert curve_err(got, want) <= 1e-12
    # frequencies handed over as a tensor give the same bits
    assert np.array_equal(st(q, torch.as_tensor(om)), got)


@pytest.mark.parametrize("case", ["integer2", "flagship"])
@pytest.mark.parametrize("W,eta", [(1, 1e-2), (9, 1e-2), (9, 1e-4)])
def test_chi0_plain_matches_reference_at_widths(case, W, eta):
    """chi0's plain version (K25's yardstick) at the widths K25 sizes its
    blocks to, one frequency and certified_chi0's nine, and at a broadening
    a hundred times smaller than the map's: 1e-12 of max|chi0|, and a
    frequency's value the same bits alone as among the nine. The reference's
    query runs on the port's grid (energies and eigenvectors): the two
    eigensolvers' energies differ by ~1e-15, which a term near resonance
    amplifies by 1/eta (1e-11 of max|chi0| at eta 1e-4 with each package's
    own grid), and this test is about the sum."""
    import jax.numpy as jnp

    name, kw, d, npt, beta, mu = CASES[case]
    (hj, ht), (bzj, bzt) = model(name, **kw), fbz(d)
    sj = jl.LindhardSolver(hj, bzj, npt, beta, mu=mu, eta=eta)
    st = tl.LindhardSolver(ht, bzt, npt, beta, mu=mu, eta=eta)
    sj._e, sj._Ur, sj._Ui = (jnp.asarray(a) for a in (st._e.numpy(), st._U.real.numpy(), st._U.imag.numpy()))
    q = QS[d]["on"]
    om = np.linspace(0.05, 3.0, W)
    got = st(q, om)
    assert got.shape == (W,)
    assert curve_err(got, np.asarray(sj(q, om))) <= 1e-12
    assert np.array_equal(st(q, om[-1:]), got[-1:])


@pytest.mark.parametrize("case", sorted(CASES))
def test_grid_and_occupations_match_reference(solvers, case):
    """The cached energies (1e-12 of their scale) and the occupations the
    kernels read, fermi(beta (e - mu)) of the port's energies."""
    sj, st = solvers(case)
    ej = np.asarray(sj._e)
    assert st._e.shape == ej.shape
    assert float(np.max(np.abs(st._e.numpy() - ej))) <= 1e-12 * float(np.max(np.abs(ej)))
    assert torch.equal(st._f, tfermi(st.beta * (st._e - st.mu)))
    assert st._vol == pytest.approx(sj._vol, rel=1e-15)


@pytest.mark.parametrize("case,q", [("integer2", None), ("integer2", [0.25, 0.0]), ("haldane", None),
                                    ("haldane", [0.125, 0.375]), ("flagship", None), ("flagship", [0.25, 0.0, -1 / 6])])
def test_cooper_bubble_matches_reference(solvers, case, q):
    sj, st = solvers(case)
    want = float(jl.cooper_bubble(sj, q))
    got = tl.cooper_bubble(st, q)
    assert isinstance(got, float)
    assert abs(got - want) <= 1e-12 * abs(want)


def test_cooper_partner_is_minus_k_plus_q():
    """The reference's code pairs k with -(k+q) (its docstring says -k+q).
    On Haldane, where e(k) != e(-k), at q = (1/4, 1/8) the port gives the
    reference's 13.8203, and the -k+q reading (computed here from the same
    grid) differs from it by more than 0.1."""
    (hj, ht), (bzj, bzt) = model("tb_haldane", t2=0.1, M=0.3), fbz()
    sj = jl.LindhardSolver(hj, bzj, 32, 20.0, mu=0.2)
    st = tl.LindhardSolver(ht, bzt, 32, 20.0, mu=0.2)
    q = [0.25, 0.125]
    got, want = tl.cooper_bubble(st, q), float(jl.cooper_bubble(sj, q))
    assert got == pytest.approx(13.8203, abs=1e-4)
    assert abs(got - want) <= 1e-12 * abs(want)
    # the -k+q reading: partner index (-i + s) mod npt on each axis
    e = st._e.numpy()
    npt, (s0, s1) = 32, (8, 4)
    i = np.arange(npt)
    xi = e - 0.2
    rev = xi[((-i + s0) % npt)[:, None], ((-i + s1) % npt)[None, :]]
    f1 = 1 / (1 + np.exp(20.0 * xi))
    f2 = 1 / (1 + np.exp(20.0 * rev))
    den = xi + rev
    tiny = np.abs(den) < 1e-10
    val = np.where(tiny, 20.0 * f1 * (1 - f1), (1 - f1 - f2) / np.where(tiny, 1.0, den))
    other = float(np.mean(val)) * st._vol
    assert other == pytest.approx(14.0674, abs=1e-4)
    assert abs(got - other) > 0.1


def test_cooper_bubble_degenerate_denominator_branch():
    """tb_integer(2) at mu = 0 with npt a multiple of 4: xi(k) + xi(-k)
    vanishes on the grid's lines k_1 + k_2 = 1/2, where the limit beta f
    (1 - f) is taken; the port follows the reference there."""
    (hj, ht), (bzj, bzt) = model("tb_integer", n=2), fbz()
    sj = jl.LindhardSolver(hj, bzj, 16, 10.0, mu=0.0)
    st = tl.LindhardSolver(ht, bzt, 16, 10.0, mu=0.0)
    xi = st._e.numpy()
    rev = np.roll(np.flip(xi, (0, 1)), (1, 1), (0, 1))
    assert np.count_nonzero(np.abs(xi + rev) < 1e-10) >= 16
    want = float(jl.cooper_bubble(sj))
    assert abs(tl.cooper_bubble(st) - want) <= 1e-12 * abs(want)


@pytest.mark.parametrize("q,nmin,nmax,abstol,beta,eta", [([0.25, 0.0], 16, 256, 5e-4, 8.0, 0.2),
                                                         ([0.5, 0.0], 8, 24, 1e-12, 50.0, 1e-3),
                                                         ([1 / 3, 0.25], 12, 96, 1e-3, 8.0, 0.3)])
def test_certified_chi0_matches_reference(q, nmin, nmax, abstol, beta, eta):
    """The same rungs (multiples of q's denominators' lcm) and retcode, the
    resid within 1e-12 of the curve's scale, the curve within 1e-12."""
    import jax.numpy as jnp

    (hj, ht), (bzj, bzt) = model("tb_integer", n=2), fbz(A=2 * np.pi * np.eye(2))
    oms = np.linspace(0.0, 2.0, 9)
    rj = jl.certified_chi0(hj, bzj, q, jnp.asarray(oms), beta=beta, eta=eta, abstol=abstol, nmin=nmin, nmax=nmax)
    rt = tl.certified_chi0(ht, bzt, q, oms, beta=beta, eta=eta, abstol=abstol, nmin=nmin, nmax=nmax)
    assert rt.npts == tuple(rj.npts)
    assert rt.retcode == rj.retcode
    scale = float(np.max(np.abs(np.asarray(rj.u))))
    assert abs(rt.resid - rj.resid) <= 1e-12 * scale
    assert curve_err(rt.u, rj.u) <= 1e-12
