"""The register eigensolver of K12's and K31's fused entries, by its PyTorch
mirror ``ops.eigh3.eigh3_jacobi``, against ``jnp.linalg.eigh``; the fused
routes' plain arithmetic (the mirror, then the velocities or G) against the
JAX package's GGR spectral data and transport distribution; and the fused
wrappers on the CPU.

Tolerances: eigenvalues within 1e-13 of the matrix's scale (max |h_ij|),
U^H U = I and H U = U diag(e) within 1e-13 (of the scale), projectors of
bands separated by more than 1e-3 of the scale within 1e-10 (an eigenvector
is conditioned by its gap); spectral data and G within 1e-12 of their
largest magnitude."""
import math

import numpy as np
import pytest
import torch

import jax.numpy as jnp

import autobzcore_torch as T
import autobzcore_tpu as J
from autobzcore_torch.algorithms.ptr import rule_points
from autobzcore_torch.dos import ggr as tggr
from autobzcore_torch.fourier import FourierSeries as TFourierSeries
from autobzcore_torch.fourier import FourierValue as TValue
from autobzcore_torch.models import observables as tobs
from autobzcore_torch.models import tight_binding as ttb
from autobzcore_torch.ops import fourier_eval as tfe
from autobzcore_torch.ops.eigh3 import eigh2, eigh3_jacobi, eigh_chunked
from autobzcore_tpu import dos as jdos
from autobzcore_tpu.fourier import FourierSeries as JFourierSeries
from autobzcore_tpu.fourier import FourierValue as JValue
from autobzcore_tpu.models import observables as jobs
from autobzcore_tpu.models import tight_binding as jtb

torch.set_num_threads(2)

KINDS = ("random", "scalar", "pair", "triple", "gap1e-9", "gap1e-15", "diagonal")


def _matrices(rng, kind, m, K=300):
    """K Hermitian m x m matrices of one kind, at unit scale."""
    if kind == "random":
        a = rng.normal(size=(K, m, m)) + 1j * rng.normal(size=(K, m, m))
        return (a + a.conj().transpose(0, 2, 1)) / 2
    if kind == "scalar":
        return np.eye(m)[None] * rng.normal(size=(K, 1, 1)) + 0j
    if kind == "diagonal":
        return np.einsum("kj,ij->kij", rng.normal(size=(K, m)), np.eye(m)) + 0j
    e = np.sort(rng.uniform(-1, 1, size=(K, m)), axis=1)
    if kind == "pair":
        e[:, 1] = e[:, 0]
    elif kind == "triple":
        e[:] = e[:, :1]
    else:
        e[:, 1] = e[:, 0] + float(kind[3:])
    Q, _ = np.linalg.qr(rng.normal(size=(K, m, m)) + 1j * rng.normal(size=(K, m, m)))
    return np.einsum("kij,kj,klj->kil", Q, e, Q.conj())


CASES = [(m, kind) for m in (1, 2, 3) for kind in KINDS
         if not (m == 1 and kind not in ("random", "scalar")) and not (m == 2 and kind == "triple")]


@pytest.mark.parametrize("scale", [1e-8, 1.0, 1e8])
@pytest.mark.parametrize("m,kind", CASES)
def test_eigh3_jacobi_matches_reference(m, kind, scale):
    rng = np.random.default_rng(1000 * m + KINDS.index(kind))
    h = _matrices(rng, kind, m) * scale
    e, U = eigh3_jacobi(torch.as_tensor(h))
    je, jU = (np.asarray(x) for x in jnp.linalg.eigh(jnp.asarray(h)))
    e, U = e.numpy(), U.numpy()
    sc = np.abs(h).max(axis=(1, 2), keepdims=True)[..., 0]  # (K, 1)
    assert np.all(np.abs(e - je) <= 1e-13 * sc)
    assert np.all(np.diff(e, axis=1) >= 0)
    eye = np.eye(m)
    assert np.abs(U.conj().transpose(0, 2, 1) @ U - eye).max() <= 1e-13
    assert np.all(np.abs(h @ U - U * e[:, None, :]).max(axis=1) <= 1e-13 * sc)
    # projectors of the bands separated from their neighbours by more than 1e-3 of the scale
    gaps = np.full(e.shape, np.inf)
    if m > 1:
        de = np.diff(je, axis=1)
        gaps[:, 1:] = de
        gaps[:, :-1] = np.minimum(gaps[:, :-1], de)
    for b in range(m):
        sep = gaps[:, b] > 1e-3 * sc[:, 0]
        P = np.einsum("ki,kj->kij", U[sep, :, b], U[sep, :, b].conj())
        jP = np.einsum("ki,kj->kij", jU[sep, :, b], jU[sep, :, b].conj())
        assert np.abs(P - jP).max(initial=0.0) <= 1e-10


def test_eigh3_jacobi_sweeps_suffice():
    """After its fixed sweeps every off-diagonal of U^H H U is within eps
    ||H||_F on hard 3 x 3 cases (so one more sweep would rotate nothing)."""
    rng = np.random.default_rng(7)
    h = np.concatenate([_matrices(rng, kind, 3, K=2000) for kind in KINDS])
    Ht = torch.as_tensor(h)
    e, U = eigh3_jacobi(Ht)
    D = U.conj().transpose(1, 2) @ Ht @ U
    off = (D - torch.diag_embed(torch.diagonal(D, dim1=1, dim2=2))).abs().amax(dim=(1, 2))
    fro = torch.linalg.matrix_norm(Ht)
    assert bool((off <= 8 * 2.0**-52 * fro).all())


@pytest.mark.parametrize("kind", ["random", "scalar", "pair", "gap1e-9", "diagonal"])
def test_eigh2_is_the_mirror_at_two_bands(kind):
    """One 2 x 2 form: eigh2 (K21's and K30's) and the mirror's m = 2 branch
    (the fused entries') give the same bits on Hermitian matrices, a single
    matrix too."""
    h = _matrices(np.random.default_rng(30 + KINDS.index(kind)), kind, 2)
    h = torch.as_tensor((h + h.conj().transpose(0, 2, 1)) / 2)  # exactly Hermitian
    e, U = eigh2(h)
    me, mU = eigh3_jacobi(h)
    assert torch.equal(e, me) and torch.equal(U, mU)
    e0, U0 = eigh2(h[0])
    assert torch.equal(e0, e[0]) and torch.equal(U0, U[0])


def _spectral_data_jacobi(ts, npt):
    """Energies and velocities by the fused route's plain arithmetic: K11's
    plain version at the FBZ rule's points, the mirror, the velocities."""
    frac, _ = rule_points(npt, 3, None, "cpu")
    X = (frac * torch.as_tensor(ts.period, dtype=torch.float64)).contiguous()
    Jt = tfe.fourier_points_derivs_plain(ts.c, X, ts.offset, ts.period, tfe.jacobian_orders(3))
    Jt = Jt.reshape(Jt.shape[:2] + (3, 3))
    e, U = eigh3_jacobi(Jt[:, 0])
    return e, tggr.band_velocity_plain(U, Jt[:, 1:])


def test_fused_velocities_match_reference_ggr_data():
    js, ts = jtb.synthetic_wannier(3), ttb.synthetic_wannier(3, device="cpu")
    npt = 8
    jc = jdos.init(J.DOSProblem(js, 0.3, J.load_bz(J.FBZ(), np.eye(3))), J.GGR(npt=npt)).cacheval
    je, jv = np.asarray(jc["energies"]), np.asarray(jc["velocities"])
    e, v = _spectral_data_jacobi(ts, npt)
    assert e.shape == je.shape and v.shape == jv.shape
    assert np.abs(e.numpy() - je).max() <= 1e-12 * np.abs(je).max()
    assert np.abs(v.numpy() - jv).max() <= 1e-12 * np.abs(jv).max()


def _graphene_dirac_point():
    """A Dirac point of tb_graphene in its fractional coordinates: the point
    of the 9 x 9 grid where H vanishes (to rounding)."""
    s = ttb.tb_graphene(device="cpu")
    X = torch.tensor([[i / 9, j / 9] for i in range(9) for j in range(9)], dtype=torch.float64)
    H = tfe.fourier_points(s.c, X, s.offset, s.period)
    k = int(torch.argmin(H.abs().amax(dim=(1, 2))))
    assert float(H[k].abs().max()) <= 1e-14
    return X[k]


def _degenerate_integer(n=3, pair=False):
    """tb_integer(n) times the 3 x 3 identity (every band degenerate at every
    k), or with ``pair`` a constant unitary rotation of diag(eps, eps, 2 eps
    + 1) (an exactly degenerate pair in exact arithmetic), as coefficient
    arrays for both packages."""
    C = ttb.integer_lattice(n)[..., None, None] * np.eye(3)
    if pair:
        Q, _ = np.linalg.qr(np.random.default_rng(3).normal(size=(3, 3)) + 1j * np.random.default_rng(4).normal(
            size=(3, 3)))
        C = np.einsum("ij,...jk,lk->...il", Q, C * np.diag([1.0, 1.0, 2.0]), Q.conj())
        C[(1,) * n] += Q @ np.diag([0.0, 0.0, 1.0]) @ Q.conj().T
    C = C.astype(np.complex128)
    return (JFourierSeries(C, period=1.0, offset=(-1,) * n, ndim=n),
            TFourierSeries(C, period=1.0, offset=(-1,) * n, ndim=n, device="cpu"))


def _transport_cases():
    """(name, packages' series, points (K, d)) for the degenerate cases."""
    rng = np.random.default_rng(11)
    cases = []
    s = ttb.tb_graphene(device="cpu")
    k = _graphene_dirac_point()
    cases.append(("graphene_dirac", (jtb.tb_graphene(), s), torch.stack([k, k + 1e-9, k + 1e-4])))
    for pair in (False, True):
        js, ts = _degenerate_integer(3, pair)
        X = torch.as_tensor(np.concatenate([[[0.0, 0.0, 0.0], [0.5, 0.5, 0.5], [0.25, 0.0, 0.5]],
                                            rng.uniform(0, 1, size=(20, 3))]))
        cases.append((f"integer_{'pair' if pair else 'triple'}", (js, ts), X))
    return cases


@pytest.mark.parametrize("case", range(3), ids=["graphene_dirac", "integer_triple", "integer_pair"])
def test_fused_transport_matches_reference_at_degenerate_points(case):
    name, (js, ts), X = _transport_cases()[case]
    d = X.shape[1]
    Jt = tfe.fourier_points_derivs_plain(ts.c, X.contiguous(), ts.offset, ts.period, tfe.jacobian_orders(d))
    m = ts.valshape[0]
    Jt = Jt.reshape(Jt.shape[:2] + (m, m))
    H, dH = Jt[:, 0], Jt[:, 1:]
    e, U = eigh3_jacobi(H)
    n = X.shape[0]
    for om in (0.0, 0.4):
        got = tobs.transport_points_plain(e, U, dH, torch.full((n,), om, dtype=torch.float64),
                                          torch.full((n,), 0.3, dtype=torch.float64)).numpy()
        want = np.stack([np.asarray(jobs.transport_distribution(JValue(None, (jnp.asarray(H[i].numpy()),
                                                                               jnp.asarray(dH[i].numpy()))),
                                                                om, eta=0.3)) for i in range(n)])
        assert np.abs(got - want).max() <= 1e-12 * np.abs(want).max(), name


def test_fused_wrappers_take_the_plain_route_on_cpu_without_counting():
    s = ttb.flagship_series(device="cpu")
    X = torch.rand(50, 3, dtype=torch.float64, generator=torch.Generator().manual_seed(2))
    Jt = tfe.fourier_points_derivs(s.c, X, s.offset, s.period, tfe.jacobian_orders(3)).reshape(50, 4, 3, 3)
    before = (tggr.band_velocity_eigh.launches, tobs.transport_points_eigh.launches)
    e, v = tggr.band_velocity_eigh(Jt)
    pe, pv = tggr.band_velocity_eigh_plain(Jt)
    assert torch.equal(e, pe) and torch.equal(v, pv)
    U = torch.linalg.eigh(Jt[:, 0])[1]
    assert torch.equal(e, torch.linalg.eigh(Jt[:, 0])[0]) and torch.equal(v, tggr.band_velocity_plain(U, Jt[:, 1:]))
    om = torch.linspace(-1, 1, 50, dtype=torch.float64)
    for w, g in ((0.3, 0.1), (om, 0.1), (torch.tensor(0.3, dtype=torch.float64), om)):
        G = tobs.transport_points_eigh(Jt[:, 0], Jt[:, 1:], w, g)
        ee, UU = eigh_chunked(Jt[:, 0])
        lane = [torch.broadcast_to(torch.as_tensor(x, dtype=torch.float64), (50,)) for x in (w, g)]
        assert torch.equal(G, tobs.transport_points_plain(ee, UU, Jt[:, 1:], *lane))
    assert before == (tggr.band_velocity_eigh.launches, tobs.transport_points_eigh.launches)


def test_fused_wrappers_refuse_more_than_three_bands_naming_the_route():
    J4 = torch.zeros((5, 4, 4, 4), dtype=torch.complex128)
    with pytest.raises(ValueError, match="eigh_chunked, then band_velocity"):
        tggr.band_velocity_eigh(J4)
    with pytest.raises(ValueError, match="eigh_chunked, then transport_points"):
        tobs.transport_points_eigh(J4[:, 0], J4[:, 1:], 0.0, 0.1)
    with pytest.raises(ValueError, match="m <= 3"):
        eigh3_jacobi(J4[:, 0])


def test_cpu_routes_stay_the_reference_operations():
    """On the CPU spectral_grid and the batched transport integrand keep
    eigh and the einsums (the fused entries are the card's route at m <= 3)."""
    s = ttb.synthetic_wannier(3, nr=3, seed=5, device="cpu")
    bz = T.load_bz(T.FBZ(), np.eye(3))
    e, v, w = tggr.spectral_grid(s, bz, 6)
    es, vs = [], []
    frac, _ = rule_points(6, 3, None, "cpu")
    X = (frac * torch.as_tensor(s.period, dtype=torch.float64)).contiguous()
    for _, ee, U, dH in tggr.eigen_chunks(s, X):
        es.append(ee)
        vs.append(tggr.band_velocity_plain(U, dH))
    assert torch.equal(e, torch.cat(es)) and torch.equal(v, torch.cat(vs))
    Hv = T.JacobianSeries(s).eval_points(X[:30])
    G = tobs.transport_distribution_points(TValue(X[:30], Hv), 0.2, eta=0.3)
    ee, UU = eigh_chunked(Hv[0])
    lanes = [torch.full((30,), x, dtype=torch.float64) for x in (0.2, 0.3)]
    assert torch.equal(G, tobs.transport_points_plain(ee, UU.contiguous(), Hv[1], *lanes))
    assert math.isfinite(float(G.abs().max()))
