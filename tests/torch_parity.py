"""Shared pieces of the port's parity tests (tests/test_torch_*.py)."""
import numpy as np
import pytest
import torch


@pytest.fixture
def cuda_device():
    """The first CUDA card; the test skips where there is none."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card (run on the GPU machine)")
    return torch.device("cuda", 0)


def random_hermitian(rng, K, m):
    """K random Hermitian m x m matrices from a numpy generator."""
    a = rng.normal(size=(K, m, m)) + 1j * rng.normal(size=(K, m, m))
    return (a + a.conj().transpose(0, 2, 1)) / 2


ERROR_KINDS = ("random", "cold_inf", "noise_floor", "ties", "quiet")


def dyadic_pool(rng, cap, segs, nsplit, kind):
    """One warm-start pool as numpy arrays (a, b, e, n): the segments of
    ``segs`` bisected ``nsplit`` times at random, in shuffled slots, with a
    few dead (zero-width) slots among the live ones and junk past ``n``.
    ``kind`` sets the errors: log-uniform, +inf (cold seeds), one constant
    (errors floored at evaluation noise), a few repeated values (ties), or
    all tiny but a few (cap pressure)."""
    ivs = [(segs[i], segs[i + 1]) for i in range(len(segs) - 1)]
    for _ in range(nsplit):
        a, b = ivs.pop(int(rng.integers(len(ivs))))
        ivs += [(a, (a + b) / 2), ((a + b) / 2, b)]
    ivs += [(0.0, 0.0)] * int(rng.integers(0, 3))
    ivs = [ivs[i] for i in rng.permutation(len(ivs))]
    n = len(ivs)
    assert n + 3 <= cap
    a, b, e = np.zeros(cap), np.zeros(cap), np.zeros(cap)
    a[:n], b[:n] = zip(*ivs)
    e[:n] = {"random": lambda: 10 ** rng.uniform(-12, -3, n), "cold_inf": lambda: np.full(n, np.inf),
             "noise_floor": lambda: np.full(n, 1e-8),
             "ties": lambda: rng.choice([1e-12, 1e-9, 1e-7], n),
             "quiet": lambda: np.where(rng.random(n) < 0.1, 1e-4, 1e-13)}[kind]()
    a[n:n + 3], b[n:n + 3], e[n:n + 3] = 0.7, 0.9, 1.0  # junk past the live slots
    return a, b, e, n


def dyadic_pools(rng, L, cap, segs, device):
    """L pools of :func:`dyadic_pool`, the error kinds in turn, each bisected
    between 3 and cap/2 times, stacked as tensors on ``device``: a, b, e
    (L, cap) float64 and n (L,) int64."""
    rows = [dyadic_pool(rng, cap, segs, int(rng.integers(3, cap // 2)), ERROR_KINDS[i % len(ERROR_KINDS)])
            for i in range(L)]
    a, b, e = (torch.as_tensor(np.stack([r[k] for r in rows]), device=device) for k in range(3))
    return a, b, e, torch.as_tensor([r[3] for r in rows], dtype=torch.int64, device=device)


def hermitian_series_arrays(seed=0, n=5, m=3, n2=None):
    """Coefficients (n, n2, n, m, m) and offsets of a random Hermitian 3-D
    series with radially decaying hoppings (the construction of the
    reference's ``tests/test_grid_sweep.py:11``), for both packages."""
    rng = np.random.default_rng(seed)
    n2 = n if n2 is None else n2
    C = rng.normal(size=(n, n2, n, m, m)) + 1j * rng.normal(size=(n, n2, n, m, m))
    r = np.linalg.norm(np.mgrid[: n, : n2, : n].astype(float)
                       - np.array([n // 2, n2 // 2, n // 2])[:, None, None, None],
                       axis=0)
    C *= np.exp(-r)[..., None, None]
    C = (C + np.flip(C, axis=(0, 1, 2)).conj().swapaxes(-1, -2)) / 2
    return C, (-(n // 2), -(n2 // 2), -(n // 2))


def dense_dos(C, offset, npt, omegas, eta):
    """``sum_k sum_b eta / ((omega - e_b(k))^2 + eta^2) / pi`` over the full
    npt^3 grid of nodes arange(npt)/npt, by dense numpy evaluation and
    ``numpy.linalg.eigvalsh`` (the reference's ``tests/test_grid_sweep.py:24``
    ``_dense_dos``)."""
    freqs = [offset[j] + np.arange(C.shape[j]) for j in range(3)]
    u = np.arange(npt) / npt
    ph = [np.exp(2j * np.pi * np.outer(u, f)) for f in freqs]
    hk = np.einsum("ka,lb,mc,abcij->klmij", ph[0], ph[1], ph[2], C, optimize=True)
    m = C.shape[-1]
    e = np.linalg.eigvalsh(hk.reshape(-1, m, m))
    t = np.asarray(omegas)[:, None, None] - e[None]
    return np.sum(eta / (t * t + eta * eta), axis=(1, 2)) / np.pi


def rel_err(got, want):
    got, want = np.asarray(got), np.asarray(want)
    return float(np.max(np.abs(got - want)) / np.max(np.abs(want)))


# --- K27's forms at m <= 3, in numpy: the identities its kernels run ---------------------------------

K27_GUARD = 2048.0  # csrc/sigma_trace.cu's kGuard: a pair whose expansion bound passes it is redone directly
_PAIRS3 = ((0, 1), (0, 2), (1, 2))


def hermitian_part(H):
    return (H + np.conj(np.swapaxes(H, -1, -2))) / 2


def adjugate3(X):
    """The adjugate of (..., 3, 3) matrices by cofactors."""
    A = np.empty_like(X)
    for i in range(3):
        for j in range(3):
            r = [k for k in range(3) if k != j]
            c = [k for k in range(3) if k != i]
            A[..., i, j] = (-1) ** (i + j) * (X[..., r[0], c[0]] * X[..., r[1], c[1]]
                                              - X[..., r[0], c[1]] * X[..., r[1], c[0]])
    return A


def det3(X):
    return np.einsum("...j,...j->...", X[..., 0, :], adjugate3(X)[..., :, 0])


def herm_reals(X):
    """A Hermitian matrix's nine reals: x00 x11 x22, Re and Im of x01, x02, x12."""
    cols = [X[..., i, i].real for i in range(3)]
    for i, j in _PAIRS3:
        cols += [X[..., i, j].real, X[..., i, j].imag]
    return np.stack(cols, -1)


def trace_coefficients(C):
    """c with tr(C X) = sum_r c[r] x[r] for Hermitian X (``herm_reals``):
    C00 C11 C22, then S_ij = C_ij + C_ji and D_ij = i (C_ji - C_ij)."""
    cols = [C[..., i, i] for i in range(3)]
    for i, j in _PAIRS3:
        cols += [C[..., i, j] + C[..., j, i], 1j * (C[..., j, i] - C[..., i, j])]
    return np.stack(cols, -1)


def k27_trace_terms(H, Z, diagonal, guard=K27_GUARD):
    """Im Tr (Z_w - H_k)^{-1} (W, K), or Im [(Z_w - H_k)^{-1}]_ii (W, K, 3),
    for m = 3 by K27's expansion: det M = det Z - tr(adj Z H) + tr(Z adj H) -
    det H, e2 M = e2 Z + e2 H - tr Z tr H + tr(Z H), minor_ii M = adj Z_ii +
    adj H_ii - (Z_kk h_jj + Z_jj h_kk - a S_jk - b D_jk), each trace a
    contraction of a lane's coefficients with a k's reals; pairs whose bound
    B = |det Z| + |det H| + |adj Z| |H| + |Z| |adj H| passes guard |det M|
    from M = Z - H formed directly (the kernel takes a tile's largest |H|,
    |adj H| and |det H|, a bound at least as large). Returns the terms and
    the redone share."""
    Hh = hermitian_part(H)
    aH = adjugate3(Hh)
    hr, ar = herm_reals(Hh), herm_reals(aH)
    detH = det3(Hh).real
    aZ = adjugate3(Z)
    detZ = det3(Z)
    cz, ca = trace_coefficients(Z), trace_coefficients(aZ)
    det = (detZ[:, None] - detH[None]) + cz @ ar.T - ca @ hr.T
    nrm = lambda X: np.sqrt((np.abs(X) ** 2).sum((-1, -2)))  # noqa: E731
    B = (np.abs(detZ)[:, None] + np.abs(detH)[None] + nrm(aZ)[:, None] * nrm(Hh)[None]
         + nrm(Z)[:, None] * nrm(aH)[None])
    redo = B > guard * np.abs(det)
    M = Z[:, None] - Hh[None]
    aM, detM = adjugate3(M), det3(M)
    if diagonal:
        terms = []
        for i in range(3):
            j, k = [q for q in range(3) if q != i]
            p = _PAIRS3.index((j, k))
            minor = (aZ[:, i, i][:, None] + aH[:, i, i][None] - Z[:, k, k][:, None] * hr[None, :, j]
                     - Z[:, j, j][:, None] * hr[None, :, k] + cz[:, None, 3 + 2 * p] * hr[None, :, 3 + 2 * p]
                     + cz[:, None, 4 + 2 * p] * hr[None, :, 4 + 2 * p])
            terms.append(np.where(redo, (aM[..., i, i] / detM).imag, (minor / det).imag))
        return np.stack(terms, -1), redo.mean()
    trZ, trH = np.trace(Z, axis1=1, axis2=2), hr[:, :3].sum(1)
    e2Z, e2H = np.trace(aZ, axis1=1, axis2=2), ar[:, :3].sum(1)
    e2 = e2Z[:, None] + e2H[None] - trZ[:, None] * trH[None] + cz @ hr.T
    e2M = np.trace(aM, axis1=-2, axis2=-1)
    return np.where(redo, (e2M / detM).imag, (e2 / det).imag), redo.mean()


def k27_direct_inverse(H, Z):
    """(Z - (H + H^H) / 2)^{-1} for m <= 3 by the adjugate and one
    reciprocal of det, the pointwise entries' form; Z broadcasts against H
    (a matrix, or a scalar z standing for z I)."""
    m = H.shape[-1]
    Z = np.asarray(Z)
    Zm = Z[..., None, None] * np.eye(m) if Z.ndim < 2 or Z.shape[-2:] != (m, m) else Z
    M = Zm - hermitian_part(H)
    if m == 1:
        return 1.0 / M
    if m == 2:
        adj = np.stack([np.stack([M[..., 1, 1], -M[..., 0, 1]], -1), np.stack([-M[..., 1, 0], M[..., 0, 0]], -1)], -2)
        det = M[..., 0, 0] * M[..., 1, 1] - M[..., 0, 1] * M[..., 1, 0]
    else:
        adj, det = adjugate3(M), det3(M)
    return adj * (1.0 / det)[..., None, None]


def k27_spectral_sum_z(H, w, z, scale):
    """scale sum_k w_k A(z I - H_k) (W, m, m) for m <= 3 by K27's z form:
    det in diagonal shifts d_i = z - h_ii (d0 d1 - p01, d2 A - d0 p12 - d1 p02
    - c), c_k = w_k / det, then G = z^2 S0 I + z S1 + S2 (m = 3), z S0 I +
    S1 (m = 2), S0 (m = 1) with S0 = sum c_k, S1 = sum c_k (H_k - tr H_k I),
    S2 = sum c_k adj H_k, and A = -(G - G^H) / (2 pi i)."""
    m = H.shape[-1]
    Hh = hermitian_part(H)
    d = z[:, None, None] - np.diagonal(Hh, axis1=1, axis2=2).real[None]  # (W, K, m)
    p = lambda i, j: np.abs(Hh[:, i, j]) ** 2  # noqa: E731
    if m == 1:
        det = d[..., 0]
    elif m == 2:
        det = d[..., 0] * d[..., 1] - p(0, 1)
    else:
        A = d[..., 0] * d[..., 1] - p(0, 1)
        c = 2 * (Hh[:, 0, 1] * Hh[:, 1, 2] * Hh[:, 2, 0]).real
        det = d[..., 2] * A - d[..., 0] * p(1, 2) - d[..., 1] * p(0, 2) - c
    ck = w[None] / det  # (W, K)
    eye = np.eye(m)
    S0 = ck.sum(1)
    if m == 1:
        G = S0[:, None, None] * eye
    else:
        Hp = Hh - np.trace(Hh, axis1=1, axis2=2)[:, None, None].real * eye
        S1 = np.einsum("wk,kab->wab", ck, Hp)
        if m == 2:
            G = z[:, None, None] * S0[:, None, None] * eye + S1
        else:
            S2 = np.einsum("wk,kab->wab", ck, adjugate3(Hh))
            G = (z ** 2)[:, None, None] * S0[:, None, None] * eye + z[:, None, None] * S1 + S2
    return scale * (G - np.conj(np.swapaxes(G, -1, -2))) / (-2j * np.pi)
