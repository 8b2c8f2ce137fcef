"""Parity of the port's spectral-grid DOS (``dos.GGR`` and
``dos.AdaptiveGaussianBroadening``, through the plain versions of kernels
K11-K13) with the JAX package on the CPU, then the reference's own GGR and
AGB cases on the port at the reference's npt and tolerances.

Spectral data: energies within 1e-12 of max|e| (H differs by an ulp between
the packages' evaluations, and the eigensolvers round differently), the
velocities within 1e-10 of max|v|, identical weights and ``numevals``.
Sweeps within 1e-10 of max|D|. The reference's 3-D closed form cancels
catastrophically where one |v| is at rounding level and dw <= w1 (a
symmetric k-point of tb_integer(3)), and there its own jit and eager
evaluations differ (ROADMAP C8): the parity cases use series without such
points, and the 3-D integer-lattice rows are held to the exact curve."""
import numpy as np
import pytest
import torch

import autobzcore_torch as T
import autobzcore_tpu as J
from autobzcore_torch import dos as tdos
from autobzcore_torch.dos import ggr as tggr
from autobzcore_torch.interop import series_from_arrays
from autobzcore_torch.models import tight_binding as ttb
from autobzcore_tpu import dos as jdos
from autobzcore_tpu.fourier import FourierSeries as JFourierSeries
from autobzcore_tpu.models import tight_binding as jtb
from test_dos import dos_graphene_exact, dos_integer_1d_exact, dos_integer_2d_exact, dos_integer_3d_exact
from torch_parity import hermitian_series_arrays

torch.set_num_threads(2)


def _flagship_shaped():
    C, off = hermitian_series_arrays(seed=11)
    return JFourierSeries(C, period=1.0, offset=off, ndim=3), series_from_arrays(C, off, 1.0, 3, device="cpu")


def _wannier4():
    return (jtb.synthetic_wannier(4, nr=3, seed=3),
            ttb.synthetic_wannier(4, nr=3, seed=3, device="cpu"))


PARITY = {"flagship-FBZ-16": (_flagship_shaped, "FBZ", 16, (-6.0, 7.0)),
          "wannier4-InversionSymIBZ-12": (_wannier4, "InversionSymIBZ", 12, (-4.0, 4.0))}


@pytest.fixture(scope="module", params=list(PARITY))
def parity(request):
    make, kind, npt, window = PARITY[request.param]
    js, ts = make()
    jc = jdos.init(J.DOSProblem(js, 0.3, J.load_bz(getattr(J, kind)(), np.eye(3))), J.GGR(npt=npt))
    tc = tdos.init(T.DOSProblem(ts, 0.3, T.load_bz(getattr(T, kind)(), np.eye(3))), T.GGR(npt=npt))
    jdos.solve_(jc)
    tdos.solve_(tc)
    return {"j": jc, "t": tc, "npt": npt, "window": window, "series": (js, ts), "kind": kind}


def test_spectral_data_matches_reference(parity):
    jc, tc = parity["j"].cacheval, parity["t"].cacheval
    je, jv, jw = (np.asarray(jc[k]) for k in ("energies", "velocities", "weights"))
    te, tv, tw = (tc[k].numpy() for k in ("energies", "velocities", "weights"))
    assert te.shape == je.shape and tv.shape == jv.shape
    assert np.max(np.abs(te - je)) <= 1e-12 * np.max(np.abs(je))
    assert np.max(np.abs(tv - jv)) <= 1e-10 * np.max(np.abs(jv))
    assert np.array_equal(tw, jw)
    assert tc["numevals"] == jc["numevals"]


def _sweep_energies(window, order):
    """101 energies over the window; with ``order == "unsorted"`` shuffled
    from a seed, five of them repeated and two beyond every band appended
    (the sum there is exactly 0), as K13's wrapper takes them."""
    Es = np.linspace(*window, 101)
    if order == "grid":
        return Es
    rng = np.random.default_rng(5)
    return np.concatenate([rng.permutation(Es), Es[rng.integers(0, 101, 5)], [window[0] - 40.0, window[1] + 40.0]])


@pytest.mark.parametrize("order", ["grid", "unsorted"])
def test_sweep_matches_reference(parity, order):
    npt = parity["npt"]
    Es = _sweep_energies(parity["window"], order)
    got = tdos.GGR(npt).dos_sweep(parity["t"].cacheval, Es)
    want = np.asarray(J.GGR(npt).dos_sweep(parity["j"].cacheval, Es))
    assert got.shape == Es.shape and got.dtype == np.float64
    assert np.max(np.abs(got - want)) <= 1e-10 * np.max(np.abs(want))
    if order == "unsorted":
        assert np.all(got[-2:] == 0.0)
    sol = tdos.solve_(parity["t"])
    assert sol.retcode and sol.err is None and sol.numevals == parity["j"].cacheval["numevals"]
    assert sol.u == pytest.approx(float(jdos.solve_(parity["j"]).u), rel=1e-10)


@pytest.mark.parametrize("order", ["grid", "unsorted"])
def test_agb_sweep_matches_reference(parity, order):
    npt = parity["npt"]
    js, ts = parity["series"]
    kind = parity["kind"]
    jc = jdos.init(J.DOSProblem(js, 0.3, J.load_bz(getattr(J, kind)(), np.eye(3))),
                   jdos.AdaptiveGaussianBroadening(npt=npt))
    tc = tdos.init(T.DOSProblem(ts, 0.3, T.load_bz(getattr(T, kind)(), np.eye(3))),
                   tdos.AdaptiveGaussianBroadening(npt=npt))
    jdos.solve_(jc)
    tdos.solve_(tc)
    Es = _sweep_energies(parity["window"], order)
    got = tdos.AdaptiveGaussianBroadening(npt).dos_sweep(tc.cacheval, Es)
    want = np.asarray(jdos.AdaptiveGaussianBroadening(npt).dos_sweep(jc.cacheval, Es))
    assert np.max(np.abs(got - want)) <= 1e-10 * np.max(np.abs(want))
    assert np.max(np.abs(tc.cacheval["sigma"].numpy() - np.asarray(jc.cacheval["sigma"]))) \
        <= 1e-10 * np.max(np.asarray(jc.cacheval["sigma"]))


# the reference's tests/test_dos.py::CASES rows in 1-D and 2-D, graphene and
# one 3-D irreducible-zone row, at its npt
CASES = [
    ("graphene", 2, dos_graphene_exact, 4, "FBZ", 200),
    ("int1d", 1, dos_integer_1d_exact, 2, "FBZ", 200),
    ("int2d", 2, dos_integer_2d_exact, 4, "FBZ", 200),
    ("int1d", 1, dos_integer_1d_exact, 2, "InversionSymIBZ", 200),
    ("int2d", 2, dos_integer_2d_exact, 4, "InversionSymIBZ", 200),
    ("int1d", 1, dos_integer_1d_exact, 2, "CubicSymIBZ", 200),
    ("int2d", 2, dos_integer_2d_exact, 4, "CubicSymIBZ", 200),
    ("int3d", 3, dos_integer_3d_exact, 6, "CubicSymIBZ", 120),
]


@pytest.mark.parametrize("name,ndim,exact,bandwidth,kind,npt", CASES)
def test_ggr_vs_exact_on_port(name, ndim, exact, bandwidth, kind, npt):
    model = ttb.tb_graphene(device="cpu") if name == "graphene" else ttb.tb_integer(ndim, device="cpu")
    bz = T.load_bz(getattr(T, kind)(), np.eye(ndim))
    Bw = bandwidth
    energies = [-Bw - 1, -0.8 * Bw, -0.6 * Bw, -0.2 * Bw, 0.1 * Bw, 0.3 * Bw,
                0.5 * Bw, 0.7 * Bw, 0.9 * Bw, Bw + 2]
    cache = tdos.init(T.DOSProblem(model, 0.0, bz), T.GGR(npt=npt))
    for e in energies:
        cache.domain = e
        got = float(tdos.solve_(cache).u)
        assert got == pytest.approx(exact(e), abs=1e-2), f"E={e}"


def test_isfresh_invalidation_on_port():
    """Replacing H through the cache rebuilds the spectral data; doubling H
    halves the DOS at a regular energy (the reference's TestCacheSemantics)."""
    h = ttb.tb_integer(1, device="cpu")
    bz = T.load_bz(T.FBZ(), np.eye(1))
    cache = tdos.init(T.DOSProblem(h, 0.6, bz), T.GGR(npt=200))
    sol1 = tdos.solve_(cache)
    assert float(sol1.u) == pytest.approx(dos_integer_1d_exact(0.6), abs=1e-2)
    cache.H = T.FourierSeries(2 * h.c, period=h.period, offset=h.offset, ndim=1, device="cpu")
    cache.domain = 1.2
    sol2 = tdos.solve_(cache)
    assert float(sol2.u) == pytest.approx(float(sol1.u) / 2, abs=1e-2)


def test_sweep_reuses_eig_grid_on_port():
    h = ttb.tb_integer(2, device="cpu")
    bz = T.load_bz(T.InversionSymIBZ(), np.eye(2))
    alg = T.GGR(npt=100)
    cache = tdos.init(T.DOSProblem(h, 0.0, bz), alg)
    tdos.solve_(cache)
    Es = np.linspace(-4.5, 4.5, 181)
    sweep = alg.dos_sweep(cache.cacheval, Es)
    for i in (10, 50, 90):
        cache.domain = Es[i]
        assert float(tdos.solve_(cache).u) == pytest.approx(sweep[i], rel=1e-12)
    assert np.trapezoid(sweep, Es) == pytest.approx(1.0, abs=5e-2)


def test_many_band_ggr_on_port():
    """30 bands (BASELINE config 5's shape): finite, non-negative and
    integrating to ~30 (the reference's test_many_band_ggr)."""
    h = ttb.synthetic_wannier(30, nr=3, ndim=2, seed=1, device="cpu")
    bz = T.load_bz(T.InversionSymIBZ(), np.eye(2))
    alg = T.GGR(npt=48)
    cache = tdos.init(T.DOSProblem(h, 0.0, bz), alg)
    tdos.solve_(cache)
    e = cache.cacheval["energies"].numpy()
    Es = np.linspace(e.min() - 0.5, e.max() + 0.5, 241)
    sweep = alg.dos_sweep(cache.cacheval, Es)
    assert np.all(np.isfinite(sweep)) and np.all(sweep >= 0)
    assert np.trapezoid(sweep, Es) == pytest.approx(30.0, rel=0.05)


def test_interval_domain_returns_interpolant_on_port():
    h = ttb.tb_integer(2, device="cpu")
    bz = T.load_bz(T.InversionSymIBZ(), np.eye(2))
    alg = T.GGR(npt=60)
    sol = tdos.solve(T.DOSProblem(h, (-3.5, 3.5), bz), alg, abstol=5e-3)
    assert sol.retcode
    xs = np.linspace(-3.4, 3.4, 57)
    vals = sol.u(xs)
    assert vals.shape == (57,)
    cache = tdos.init(T.DOSProblem(h, 0.0, bz), alg)
    direct = alg.dos_sweep(cache.cacheval, xs)
    assert np.max(np.abs(vals - direct)) < 5 * 5e-3


SAMPLE = (-0.85, -0.55, -0.3, 0.2, 0.45, 0.75)


@pytest.mark.parametrize("ndim,exact,bandwidth,npt", [
    (1, dos_integer_1d_exact, 2, 400),
    (2, dos_integer_2d_exact, 4, 150),
])
def test_agb_vs_exact_on_port(ndim, exact, bandwidth, npt):
    model = ttb.tb_integer(ndim, device="cpu")
    bz = T.load_bz(T.FBZ(), np.eye(ndim))
    cache = tdos.init(T.DOSProblem(model, 0.0, bz), tdos.AdaptiveGaussianBroadening(npt=npt))
    for frac in SAMPLE:
        e = frac * bandwidth
        cache.domain = e
        assert float(tdos.solve_(cache).u) == pytest.approx(exact(e), abs=2e-2), f"E={e}"


def test_agb_matches_ggr_moderate_on_port():
    model = ttb.tb_integer(2, device="cpu")
    bz = T.load_bz(T.CubicSymIBZ(), np.eye(2))
    ca = tdos.init(T.DOSProblem(model, 0.0, bz), tdos.AdaptiveGaussianBroadening(npt=200))
    cg = tdos.init(T.DOSProblem(model, 0.0, bz), T.GGR(npt=200))
    for E in (0.8, 2.0, 3.1):
        ca.domain = E
        cg.domain = E
        assert float(tdos.solve_(ca).u) == pytest.approx(float(tdos.solve_(cg).u), abs=5e-3)


def test_agb_min_sigma_floors_the_widths():
    model = ttb.tb_integer(1, device="cpu")
    bz = T.load_bz(T.FBZ(), np.eye(1))
    cv = tdos.AdaptiveGaussianBroadening(npt=50, a=0.5, min_sigma=0.05).init_cacheval(model, 0.0, bz)
    assert float(cv["sigma"].min()) == 0.05
    assert cv["inv_total"] == 1.0 / 50


@pytest.mark.parametrize("precision", ["auto", "complex", "split", "rayleigh"])
def test_every_precision_runs_complex128(precision):
    """The reference's split-f64 tiers are TPU emulation: every precision
    gives the complex128 result here."""
    h = ttb.tb_graphene(device="cpu")
    bz = T.load_bz(T.FBZ(), np.eye(2))
    Es = np.linspace(-3.5, 3.5, 15)
    base = T.GGR(npt=40)
    want = base.dos_sweep(base.init_cacheval(h, 0.0, bz), Es)
    alg = T.GGR(npt=40, precision=precision)
    assert np.array_equal(alg.dos_sweep(alg.init_cacheval(h, 0.0, bz), Es), want)


def test_ltm_and_fullgrid_take_a_jacobian_series():
    """LTM and LorentzianFullGrid unwrap a JacobianSeries to its series, as
    the reference does, and give the same numbers."""
    h = ttb.tb_graphene(device="cpu")
    bz = T.load_bz(T.FBZ(), np.eye(2))
    Es = np.linspace(-3.5, 3.5, 31)
    ltm = tdos.LTM(npt=40)
    got = ltm.dos_sweep(ltm.init_cacheval(T.JacobianSeries(h), 0.0, bz), Es)
    assert np.array_equal(got, ltm.dos_sweep(ltm.init_cacheval(h, 0.0, bz), Es))
    C, off = hermitian_series_arrays(seed=11)
    s3 = series_from_arrays(C, off, 1.0, 3, device="cpu")
    bz3 = T.load_bz(T.FBZ(), np.eye(3))
    lfg = tdos.LorentzianFullGrid(0.2, nmin=8, nmax=12, device="cpu")
    a = lfg.dos_sweep(lfg.init_cacheval(T.JacobianSeries(s3), 0.0, bz3), Es, abstol=1e-1)
    b = lfg.dos_sweep(lfg.init_cacheval(s3, 0.0, bz3), Es, abstol=1e-1)
    assert np.array_equal(a, b)


def test_ggr_refuses_what_the_reference_refuses():
    alg = T.GGR(npt=8)
    bz2 = T.load_bz(T.FBZ(), np.eye(2))
    with pytest.raises(TypeError):
        alg.init_cacheval(np.zeros((3, 3)), 0.0, bz2)
    with pytest.raises(TypeError):
        alg.init_cacheval(ttb.tb_integer(2, device="cpu"), 0.0, None)
    vec = T.FourierSeries(np.zeros((3, 3, 2)), ndim=2, device="cpu")
    with pytest.raises(ValueError):
        alg.init_cacheval(vec, 0.0, bz2)
    rect = T.FourierSeries(np.zeros((3, 3, 2, 3)), ndim=2, device="cpu")
    with pytest.raises(ValueError):
        alg.init_cacheval(rect, 0.0, bz2)
    bz4 = T.load_bz(T.FBZ(), np.eye(4))
    with pytest.raises(ValueError):
        alg.init_cacheval(T.FourierSeries(np.zeros((3,) * 4), device="cpu"), 0.0, bz4)
    cache = tdos.init(T.DOSProblem(ttb.tb_integer(2, device="cpu"), np.zeros(2), bz2), alg)
    with pytest.raises(TypeError):
        tdos.solve_(cache)
    agb = tdos.AdaptiveGaussianBroadening(npt=8)
    cache = tdos.init(T.DOSProblem(ttb.tb_integer(2, device="cpu"), np.zeros(2), bz2), agb)
    with pytest.raises(TypeError):
        tdos.solve_(cache)


def test_k12_k13_wrappers_take_plain_versions_on_cpu_without_counting():
    rng = np.random.default_rng(7)
    a = rng.normal(size=(9, 4, 4)) + 1j * rng.normal(size=(9, 4, 4))
    U = torch.linalg.eigh(torch.as_tensor(a + a.conj().transpose(0, 2, 1)))[1].contiguous()
    dH = torch.as_tensor(rng.normal(size=(9, 3, 4, 4)) + 0j)
    e = torch.as_tensor(rng.normal(size=(9, 4)))
    w = torch.ones(9, dtype=torch.float64)
    E = torch.linspace(-2, 2, 7, dtype=torch.float64)
    counts = (tggr.band_velocity.launches, tggr.ggr_box_sum.launches, tggr.gaussian_sum.launches)
    assert torch.equal(tggr.band_velocity(U, dH), tggr.band_velocity_plain(U, dH))
    v = tggr.band_velocity(U, dH)
    assert torch.equal(tggr.ggr_box_sum(e, v, w, E, 0.05, 1e-10),
                       tggr.ggr_box_sum_plain(e, v, w, E, 0.05, 1e-10))
    s = torch.full_like(e, 0.3)
    assert torch.equal(tggr.gaussian_sum(e, s, 1 / s, w, E, 0.5), tggr.gaussian_sum_plain(e, s, 1 / s, w, E, 0.5))
    assert counts == (tggr.band_velocity.launches, tggr.ggr_box_sum.launches, tggr.gaussian_sum.launches)
    with pytest.raises(ValueError):
        tggr.band_velocity(U, dH[:, :, :3])
    with pytest.raises(ValueError):
        tggr.ggr_box_sum(e, v[:, :, :3].contiguous(), w, E, 0.05, 1e-10)
    with pytest.raises(ValueError):
        tggr.ggr_box_sum(e, torch.zeros(9, 4, 4, dtype=torch.float64), w, E, 0.05, 1e-10)
    with pytest.raises(ValueError):
        tggr.gaussian_sum(e, s.to(torch.float32), 1 / s, w, E, 0.5)


def test_symmetric_point_terms_follow_the_reference_closed_forms():
    """tb_integer(3) on the cubic wedge: at a symmetric k-point one |v| is at
    rounding level, and where dw <= w1 the reference's 3-D closed form is
    made of rounding errors (ROADMAP C8). The port's sum there is the
    reference's closed forms evaluated term by term on the same spectral
    data, within 1e-12 of max|D|."""
    import jax.numpy as jnp
    from autobzcore_tpu.dos.ggr import _ggr_3d

    npt = 30
    jc = jdos.init(J.DOSProblem(jtb.tb_integer(3), 0.3, J.load_bz(J.CubicSymIBZ(), np.eye(3))), J.GGR(npt=npt))
    tc = tdos.init(T.DOSProblem(ttb.tb_integer(3, device="cpu"), 0.3, T.load_bz(T.CubicSymIBZ(), np.eye(3))),
                   T.GGR(npt=npt))
    jdos.solve_(jc)
    tcv = tc.cacheval
    e, v, w = (np.asarray(jc.cacheval[k]) for k in ("energies", "velocities", "weights"))
    assert np.array_equal(tcv["energies"].numpy(), e) and np.array_equal(tcv["velocities"].numpy(), v)
    Es = np.linspace(-4.0, 4.0, 101)
    vt = jnp.moveaxis(jnp.asarray(v), 1, 2)
    want = np.array([float(np.sum(w[:, None] * np.asarray(_ggr_3d(tcv["b"], jnp.abs(E - jnp.asarray(e)), vt,
                                                                  tcv["vtol"])))) for E in Es])
    got = tdos.GGR(npt).dos_sweep(tcv, Es)
    assert np.max(np.abs(got - want)) <= 1e-12 * np.max(np.abs(want))
