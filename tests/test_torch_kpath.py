"""Parity of the port's k-path module (``models.kpath``: ``kpath``,
``band_structure``, ``expectation_path``, ``spectral_path``, through the
plain versions of kernels K29 and K30) with the JAX package on the CPU:
every case of ``tests/test_kpath.py`` run on the port, then the three path
functions against the reference on graphene, Haldane, ``tb_integer(2)``, the
flagship and Kane-Mele.

Tolerances: energies and spectral maps 1e-12 of their scale; expectations
1e-12 of the operator's scale, band by band where the bands are
non-degenerate and by the sum over each degenerate cluster elsewhere (only
that sum is gauge-free). The Sz-conserving Kane-Mele bands are degenerate
in pairs at every point; Kane-Mele with Rashba coupling at the
time-reversal-invariant points. There each band's value is held only to
the reference test's own identity (|<Sz>| = 1/2, which LAPACK's vectors of
a spin-block-diagonal H give in both packages)."""
import sys

import numpy as np
import pytest
import torch

import autobzcore_torch.models.kpath  # noqa: F401  (the module; models.kpath is the function)
import autobzcore_tpu.models.kpath  # noqa: F401
from autobzcore_torch.models import tight_binding as ttb
from autobzcore_tpu.models import tight_binding as jtb

tk = sys.modules["autobzcore_torch.models.kpath"]
jk = sys.modules["autobzcore_tpu.models.kpath"]

torch.set_num_threads(2)
REL = 1e-12
SZ = np.diag([0.5, 0.5, -0.5, -0.5])
X3 = np.array([[0.13, 0.41], [0.3, 0.1], [0.45, 0.27]])
MODELS = {
    "graphene": (dict(), 2),
    "haldane": (dict(t2=0.1, M=0.3), 2),
    "integer": (dict(), 2),
    "flagship": (dict(), 3),
    "kane_mele": (dict(lam_so=0.08, lam_r=0.08), 2),
}


def _model(name):
    kw, d = MODELS[name]
    if name == "flagship":
        import jax.numpy as jnp

        import __graft_entry__ as g

        hj = g._flagship_series(jnp.complex128)
        return hj, ttb.flagship_series(device="cpu"), d
    maker = {"graphene": "tb_graphene", "haldane": "tb_haldane", "integer": "tb_integer",
               "kane_mele": "tb_kane_mele"}[name]
    args = (2,) if name == "integer" else ()
    return getattr(jtb, maker)(*args, **kw), getattr(ttb, maker)(*args, **kw, device="cpu"), d


def _path(d):
    V = [[0, 0], [0.5, 0], [0.5, 0.5], [0, 0]] if d == 2 else \
        [[0, 0, 0], [0.5, 0, 0], [0.5, 0.5, 0], [0, 0, 0], [0.5, 0.5, 0.5], [0.5, 0, 0]]
    return tk.kpath(V, npts=20), jk.kpath(V, npts=20)


def _group_sums(e, vals, tol=1e-8):
    """Per point, the sums of ``vals`` over clusters of bands closer than
    ``tol`` (a single band where it is non-degenerate): the gauge-free
    content of band expectations. Returns the flattened sums."""
    out = []
    for ek, vk in zip(e, vals):
        start = 0
        for n in range(1, len(ek) + 1):
            if n == len(ek) or ek[n] - ek[n - 1] > tol:
                out.append(vk[start:n].sum())
                start = n
    return np.array(out)


def _close(got, want, rel=REL, scale=None):
    got, want = np.asarray(got), np.asarray(want)
    assert got.shape == want.shape
    scale = float(np.max(np.abs(want))) if scale is None else scale
    assert float(np.max(np.abs(got - want))) <= rel * scale


# --- the cases of tests/test_kpath.py on the port -----------------------------------------------


def test_kpath_geometry():
    V = [[0, 0], [0.5, 0], [0.5, 0.5]]
    p = tk.kpath(V, npts=10)
    assert isinstance(p, tk.KPath)
    np.testing.assert_allclose(p.X[p.ticks], V)
    assert np.all(np.diff(p.s) > 0)
    np.testing.assert_allclose(p.s[-1], 1.0, atol=1e-12)
    p2 = tk.kpath(V, npts=10, B=2 * np.eye(2))
    np.testing.assert_allclose(p2.s[-1], 2.0, atol=1e-12)
    with pytest.raises(ValueError):
        tk.kpath([[0, 0]], npts=10)


def test_band_structure_matches_pointwise():
    h = ttb.tb_graphene(device="cpu")
    p = tk.kpath([[0, 0], [0.5, 0.5]], npts=8)
    e = tk.band_structure(h, p).numpy()
    assert e.shape == (len(p.X), 2)
    hk = h(np.asarray(p.X[3])).numpy()
    np.testing.assert_allclose(e[3], np.linalg.eigvalsh(hk), atol=1e-12)


def test_graphene_dirac_point():
    e = tk.band_structure(ttb.tb_graphene(device="cpu"), np.array([[1 / 9, 2 / 9], [0.0, 0.0]])).numpy()
    assert abs(e[0, 1] - e[0, 0]) < 1e-10
    assert e[1, 1] - e[1, 0] > 1.0


def test_spectral_sum_rule():
    p = tk.kpath([[0, 0], [0.5, 0.0]], npts=4)
    om = np.linspace(-40, 40, 4001)
    A = tk.spectral_path(ttb.tb_integer(2, device="cpu"), p, om, eta=0.05).numpy()
    assert A.shape == (len(p.X), len(om))
    np.testing.assert_allclose(np.trapezoid(A, om, axis=1), 1.0, atol=1e-2)


def test_expectation_path_spin_texture():
    s_cons = tk.expectation_path(ttb.tb_kane_mele(lam_so=0.08, device="cpu"), X3, SZ).numpy()
    np.testing.assert_allclose(np.abs(s_cons), 0.5, atol=1e-12)
    ones = tk.expectation_path(ttb.tb_kane_mele(lam_so=0.08, device="cpu"), X3, np.eye(4)).numpy()
    np.testing.assert_allclose(ones, 1.0, atol=1e-12)
    s_rash = tk.expectation_path(ttb.tb_kane_mele(lam_so=0.08, lam_r=0.08, device="cpu"), X3, SZ).numpy()
    assert np.abs(np.abs(s_rash) - 0.5).max() > 1e-3


# --- parity with the JAX package ------------------------------------------------------------------


def test_kpath_matches_reference():
    for d in (2, 3):
        pt, pj = _path(d)
        np.testing.assert_array_equal(pt.X, pj.X)
        np.testing.assert_array_equal(pt.s, pj.s)
        np.testing.assert_array_equal(pt.ticks, pj.ticks)
    B = np.array([[1.0, 0.5], [0.0, 0.8]])
    pt, pj = tk.kpath([[0, 0], [0.5, 0.2], [0.1, 0.4]], 13, B, ["G", "A", "B"]), \
        jk.kpath([[0, 0], [0.5, 0.2], [0.1, 0.4]], 13, B, ["G", "A", "B"])
    np.testing.assert_array_equal(pt.s, pj.s)
    assert pt.labels == pj.labels


@pytest.mark.parametrize("name", sorted(MODELS))
def test_band_structure_and_spectral_path_match_reference(name):
    hj, ht, d = _model(name)
    pt, pj = _path(d)
    e = tk.band_structure(ht, pt)
    ej = np.asarray(jk.band_structure(hj, pj.X))
    _close(e.numpy(), ej)
    assert torch.equal(tk.band_structure(ht, torch.as_tensor(pt.X)), e)  # a raw (K, d) path
    om = np.linspace(-7, 8, 301)
    _close(tk.spectral_path(ht, pt, om, 0.07).numpy(), np.asarray(jk.spectral_path(hj, pj.X, om, 0.07)))


@pytest.mark.parametrize("name", ["graphene", "haldane", "flagship", "kane_mele"])
def test_expectation_path_matches_reference(name):
    """Band by band where bands are non-degenerate, and over each degenerate
    cluster (Kane-Mele's Kramers pairs at the time-reversal-invariant
    points) by its sum: at m = 2 the closed form eigh2 (K30's fused form),
    above it LAPACK's vectors, with a random Hermitian operator and the
    orbital projectors (which sum to 1 a band)."""
    hj, ht, d = _model(name)
    pt, pj = _path(d)
    m = ht.valshape[0]
    e = tk.band_structure(ht, pt).numpy()
    rng = np.random.default_rng(m)
    a = rng.normal(size=(m, m)) + 1j * rng.normal(size=(m, m))
    ops = [(a + a.conj().T) / 2] + [np.diag(np.eye(m)[i]) for i in range(m)]
    total = 0.0
    for O in ops:
        got = tk.expectation_path(ht, pt, O).numpy()
        want = np.asarray(jk.expectation_path(hj, pj.X, O))
        _close(_group_sums(e, got), _group_sums(e, want), scale=float(np.abs(O).max()))
        total = total + (got if O is not ops[0] else 0.0)
    np.testing.assert_allclose(total, 1.0, atol=1e-12)


def test_expectation_path_degenerate_pairs_match_reference_by_pair_sums():
    """Sz-conserving Kane-Mele: Kramers pairs at every k; each pair's sum of
    <O> is gauge-free for any O, and |<Sz>| = 1/2 a band holds in both."""
    hj, ht = jtb.tb_kane_mele(lam_so=0.08), ttb.tb_kane_mele(lam_so=0.08, device="cpu")
    pt, pj = _path(2)
    rng = np.random.default_rng(5)
    a = rng.normal(size=(4, 4)) + 1j * rng.normal(size=(4, 4))
    O = (a + a.conj().T) / 2
    e = tk.band_structure(ht, pt).numpy()
    pairs = np.abs(e[:, 1] - e[:, 0]) < 1e-10
    assert pairs.all() and (np.abs(e[:, 3] - e[:, 2]) < 1e-10).all()
    got = tk.expectation_path(ht, pt, O).numpy()
    want = np.asarray(jk.expectation_path(hj, pj.X, O))
    _close(got[:, :2].sum(1), want[:, :2].sum(1), scale=float(np.abs(O).max()))
    _close(got[:, 2:].sum(1), want[:, 2:].sum(1), scale=float(np.abs(O).max()))
    np.testing.assert_allclose(np.abs(tk.expectation_path(ht, pt, SZ).numpy()), 0.5, atol=1e-12)
    np.testing.assert_allclose(np.abs(np.asarray(jk.expectation_path(hj, pj.X, SZ))), 0.5, atol=1e-12)


def test_config5_band_structure_matches_numpy():
    """Config 5's 30-band synthetic model: eigvalsh in batches above three
    bands, against numpy at a subsample of the path."""
    hj = jtb.synthetic_wannier(30, nr=5, ndim=3, seed=0)
    ht = ttb.synthetic_wannier(30, nr=5, ndim=3, seed=0, device="cpu")
    pt, _ = _path(3)
    e = tk.band_structure(ht, pt).numpy()
    idx = np.arange(0, len(pt.X), 17)
    want = np.stack([np.linalg.eigvalsh(np.asarray(hj(np.asarray(pt.X[i])))) for i in idx])
    _close(e[idx], want)
    A = tk.spectral_path(ht, pt, np.linspace(-30, 30, 2001), 0.2).numpy()
    np.testing.assert_allclose(np.trapezoid(A, np.linspace(-30, 30, 2001), axis=1), 30.0, rtol=2e-2)
