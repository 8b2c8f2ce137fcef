"""Closed-form eigenvalues of batched small Hermitian matrices (reference
``autobzcore_tpu/ops/eigh3.py``, kernel family B2).

The 2x2 forms and the trigonometric (Cardano) 3x3 forms are plain PyTorch,
with the reference's formulas: the scale-relative degeneracy guard for
(near-)scalar matrices, the clip before ``arccos`` and ascending output.
Larger matrices go to ``torch.linalg.eigvalsh``.

``eigvalsh_small`` is the wrapper of kernel K9 (``csrc/eigh_small.cu``): on
CUDA tensors with m <= 3 it launches the kernel (one thread per matrix, the
same closed forms); on CPU tensors it runs ``eigvalsh_small_plain``. The
reference's split-complex ``eigvalsh3_split`` is TPU emulation and is not
ported (ROADMAP "Not to port").

``eigh3_jacobi`` is the PyTorch mirror of the register eigensolver that K12's
and K31's fused entries run for m <= 3 (``csrc/small_eigen.cuh``
``eigh_rn``): the same correctly rounded operations in the same order, so
the two agree bit for bit. Its m = 2 form is ``eigh2``, which K21 and K30
run on the card too.
"""
from __future__ import annotations

import math

import numpy as np
import torch

from .._device import COMPLEX, REAL, check_tensor
from .cuda_lib import check_launch, load_kernels, stream_handle

# matrices per torch.linalg.eigvalsh call on the card: cuSOLVER's batched
# solver (cusolverDnXsyevBatched) took 16,384 complex 3x3 matrices and
# refused 32,768 and more with CUSOLVER_STATUS_INVALID_VALUE on an H100;
# larger matrices take proportionally fewer, in case the limit is on entries
EIGVALSH_CHUNK = 16384
# matrices per torch.linalg.eigh call on the card: cuSOLVER's batched eigh
# takes up to EIGVALSH_CHUNK matrices at m = 3 and m = 30, but its workspace
# grows with the batch, near 1 MiB a matrix at either m; a quarter of the cap
# holds one call to a few GB at a small cost in eigh time (chip_smoke.py
# phases 20-21 read both sizes)
EIGH_CHUNK = 4096


def eigvalsh_chunk(m):
    """Matrices of size m per batched ``torch.linalg.eigvalsh`` call."""
    return max(1, min(EIGVALSH_CHUNK, EIGVALSH_CHUNK * 9 // (m * m)))


def eigvalsh2(h):
    """Eigenvalues of batched Hermitian 2x2 ``h`` (..., 2, 2), ascending."""
    a = h[..., 0, 0].real
    c = h[..., 1, 1].real
    b2 = h[..., 0, 1].abs() ** 2
    mean = (a + c) / 2
    rad = torch.sqrt(((a - c) / 2) ** 2 + b2)
    return torch.stack([mean - rad, mean + rad], dim=-1)


def eigh2(h):
    """Closed-form eigendecomposition of batched Hermitian 2x2 ``h``: ``(e,
    U)`` with ascending eigenvalues and unitary ``U`` (columns are
    eigenvectors), from h's diagonal and h_01 (the reference's reads).

    Branch-stable: the upper-band eigenvector uses ``[d + r, conj(b)]`` for
    ``d >= 0`` and ``[b, r - d]`` otherwise, with an identity fallback at
    exact degeneracy r = 0. The correctly rounded operations of the card's
    form (``csrc/small_eigen.cuh`` ``eigh_rn<2>``, K21's, K30's and the
    fused entries'), so the two agree bit for bit."""
    b = h[..., 0, 1]
    return _eigh2_rn(h[..., 0, 0].real, h[..., 1, 1].real, b.real, b.imag)


def _eigh2_rn(d0, d1, br, bi):
    """eigh2 of the Hermitian 2x2 with diagonal (d0, d1) and h_01 = br + i bi
    in the card's order of correctly rounded operations."""
    one, zero = torch.ones_like(d0), torch.zeros_like(d0)
    dd = (d0 - d1) * 0.5
    r = _sqrt_rn(dd * dd + (br * br + bi * bi))
    mean = (d0 + d1) * 0.5
    e = torch.stack([mean - r, mean + r], dim=-1)
    pos = dd >= 0.0
    v0r, v0i = torch.where(pos, dd + r, br), torch.where(pos, zero, bi)
    v1r, v1i = torch.where(pos, br, r - dd), torch.where(pos, -bi, zero)
    nrm = _sqrt_rn((v0r * v0r + v0i * v0i) + (v1r * v1r + v1i * v1i))
    ok = nrm > 0.0
    n = torch.where(ok, nrm, one)
    u0r, u0i = torch.where(ok, v0r / n, zero), torch.where(ok, v0i / n, zero)
    u1r, u1i = torch.where(ok, v1r / n, one), torch.where(ok, v1i / n, zero)
    # lower band (-conj(up1), conj(up0)), upper band (up0, up1)
    U = torch.stack([torch.stack([torch.complex(-u1r, u1i), torch.complex(u0r, u0i)], dim=-1),
                     torch.stack([torch.complex(u0r, -u0i), torch.complex(u1r, u1i)], dim=-1)], dim=-2)
    return e, U


def _cardano(a11, a22, a33, b12, b13, b23, re_triple):
    """The shared trigonometric solution: diagonals, squared moduli of the
    off-diagonals and Re(a12 a23 conj(a13)) give (e1, e2, e3), e1 the
    largest and e3 the smallest, with the scale-relative guard."""
    p1 = b12 + b13 + b23
    q = (a11 + a22 + a33) / 3
    d1, d2, d3 = a11 - q, a22 - q, a33 - q
    p2 = d1**2 + d2**2 + d3**2 + 2 * p1
    thr = 1e-24 * (q * q + p2 + 1e-30)
    p = torch.sqrt(torch.maximum(p2, thr) / 6)
    inv_p = 1.0 / p
    detB = (d1 * d2 * d3 + 2 * re_triple - d1 * b23 - d2 * b13 - d3 * b12) * inv_p**3
    phi = torch.arccos(torch.clamp(detB / 2, -1.0, 1.0)) / 3
    e1 = q + 2 * p * torch.cos(phi)
    e3 = q + 2 * p * torch.cos(phi + 4 * math.pi / 3)
    e2 = 3 * q - e1 - e3
    # (near-)scalar matrices: p ~ 0 -> all eigenvalues = diagonal
    diag = p2 <= thr
    return torch.where(diag, a33, e1), torch.where(diag, a22, e2), torch.where(diag, a11, e3)


def eigvalsh3(h):
    """Eigenvalues of batched Hermitian 3x3 ``h`` (..., 3, 3), ascending.

    Trigonometric (Cardano) solution of the characteristic cubic via matrix
    invariants [Smith, Comm. ACM 4 (1961) 168]."""
    a12, a13, a23 = h[..., 0, 1], h[..., 0, 2], h[..., 1, 2]
    e1, e2, e3 = _cardano(h[..., 0, 0].real, h[..., 1, 1].real, h[..., 2, 2].real,
                          a12.abs() ** 2, a13.abs() ** 2, a23.abs() ** 2,
                          (a12 * a23 * a13.conj()).real)
    return torch.sort(torch.stack([e3, e2, e1], dim=-1), dim=-1).values


def eigvalsh3_rows(a11, a22, a33, r12, i12, r13, i13, r23, i23):
    """Struct-of-arrays Cardano: the nine Hermitian entry planes as separate
    real tensors (any common shape), returning ``(lo, mid, hi)``."""

    def abs2(re, im):
        return re * re + im * im

    re_triple = (r12 * r23 - i12 * i23) * r13 + (r12 * i23 + i12 * r23) * i13
    e1, e2, e3 = _cardano(a11, a22, a33, abs2(r12, i12), abs2(r13, i13), abs2(r23, i23), re_triple)
    # 3-element ascending exchange network
    lo = torch.minimum(torch.minimum(e1, e2), e3)
    hi = torch.maximum(torch.maximum(e1, e2), e3)
    mid = (e1 + e2 + e3) - lo - hi
    return lo, mid, hi


def eigvalsh_chunked(h, chunk=None):
    """``torch.linalg.eigvalsh`` of (K, m, m) matrices, ``chunk`` at a time
    (by default as many as the card's batched solver takes)."""
    chunk = eigvalsh_chunk(h.shape[-1]) if chunk is None else int(chunk)
    if h.shape[0] <= chunk:
        return torch.linalg.eigvalsh(h)
    return torch.cat([torch.linalg.eigvalsh(h[s:s + chunk]) for s in range(0, h.shape[0], chunk)])


def eigvalsh_small_plain(h):
    """Plain PyTorch version of K9 (and the reference's dispatch): closed
    forms for m in (1, 2, 3), ``torch.linalg.eigvalsh`` otherwise."""
    m = h.shape[-1]
    if m == 1:
        return h[..., 0, 0].real[..., None]
    if m == 2:
        return eigvalsh2(h)
    if m == 3:
        return eigvalsh3(h)
    return torch.linalg.eigvalsh(h)


def eigvalsh_small(h):
    """Ascending eigenvalues (..., m) float64 of Hermitian ``h`` (..., m, m)
    complex128.

    CPU tensors take the plain version. On CUDA tensors m <= 3 launches K9
    and m > 3 calls ``torch.linalg.eigvalsh`` in batches the card's solver
    accepts; anything else raises."""
    if not isinstance(h, torch.Tensor) or h.ndim < 2 or h.shape[-1] != h.shape[-2]:
        raise ValueError("eigvalsh_small takes a tensor of square matrices (..., m, m)")
    if h.device.type == "cpu":
        return eigvalsh_small_plain(h)
    if h.device.type != "cuda":
        raise ValueError(f"eigvalsh_small runs on cpu or cuda tensors, got {h.device}")
    check_tensor(h, "h", dtype=COMPLEX)
    m = h.shape[-1]
    batch = tuple(h.shape[:-2])
    flat = h.reshape(-1, m, m)
    if m > 3:
        return eigvalsh_chunked(flat).reshape(batch + (m,))
    K = flat.shape[0]
    out = torch.empty((K, m), dtype=REAL, device=h.device)
    if K:
        lib = load_kernels()
        stream = stream_handle(h.device)
        check_launch(lib.eigvalsh_small_launch(flat.data_ptr(), out.data_ptr(), K, m, stream),
                     "eigvalsh_small")
        eigvalsh_small.launches += 1
    return out.reshape(batch + (m,))


eigvalsh_small.launches = 0


def eigh_chunked(h):
    """``torch.linalg.eigh`` of Hermitian ``h`` (..., m, m), at most
    :data:`EIGH_CHUNK` matrices a call. Returns ``(e (..., m), U (..., m,
    m))``."""
    m = h.shape[-1]
    batch = tuple(h.shape[:-2])
    flat = h.reshape(-1, m, m)
    if flat.shape[0] <= EIGH_CHUNK:
        e, U = torch.linalg.eigh(flat)
    else:
        parts = [torch.linalg.eigh(flat[s:s + EIGH_CHUNK]) for s in range(0, flat.shape[0], EIGH_CHUNK)]
        e, U = torch.cat([p[0] for p in parts]), torch.cat([p[1] for p in parts])
    return e.reshape(batch + (m,)), U.reshape(batch + (m, m))


# the register eigensolver's constants (csrc/small_eigen.cuh): its fixed
# sweep count, and eps^2 (eps = 2^-52) of its skip test |h_pq|^2 <= eps^2
# ||H||_F^2
JACOBI_SWEEPS = 5
_EPS2 = 2.0**-104


def _hermitian_parts(h):
    """The Hermitian part of (..., m, m) ``h`` as the register solver reads
    it: the real diagonal (d_0, ..) and the upper off-diagonals ``(h_il +
    conj(h_li)) / 2`` at (0, 1), (0, 2), (1, 2) as (real, imag) pairs."""
    m = h.shape[-1]
    d = [h[..., i, i].real for i in range(m)]
    o = [((h[..., i, l].real + h[..., l, i].real) * 0.5, (h[..., i, l].imag - h[..., l, i].imag) * 0.5)
         for i in range(m) for l in range(i + 1, m)]
    return d, o


def _sqrt_rn(x):
    """The correctly rounded square root, as the card's: ``torch.sqrt`` on
    CUDA tensors; on CPU tensors numpy's, since torch's vectorized CPU sqrt
    misses the correctly rounded value by an ulp on ~1 % of float64 inputs."""
    if x.device.type == "cpu":
        return torch.from_numpy(np.asarray(np.sqrt(x.numpy())))
    return torch.sqrt(x)


def _rotate_pair(c, sr, si, x, y):
    (xr, xi), (yr, yi) = x, y
    return ((c * xr - (sr * yr + si * yi), c * xi - (sr * yi - si * yr)),
            ((sr * xr - si * xi) + c * yr, (sr * xi + si * xr) + c * yi))


def _jacobi_rotate(d, o, U, p, q, k, x, y, tol2):
    """The mirror of ``jacobi_rotate<P, Q>``: the pair (p, q) whose h_pq is
    o[k], with (x, y) = (A_rp, A_rq); updates d, o[k] and U in place where
    |h_pq|^2 > tol2 and returns the new (x, y)."""
    gr, gi = o[k]
    g2 = gr * gr + gi * gi
    act = g2 > tol2
    a = torch.where(act, _sqrt_rn(g2), torch.ones_like(g2))
    ia = 1.0 / a
    er, ei = gr * ia, gi * ia
    th = (d[q] - d[p]) / (a + a)
    t = 1.0 / (th.abs() + _sqrt_rn(th * th + 1.0))
    t = torch.where(th < 0.0, -t, t)
    c = 1.0 / _sqrt_rn(t * t + 1.0)
    s = t * c
    ta = t * a
    d[p] = torch.where(act, d[p] - ta, d[p])
    d[q] = torch.where(act, d[q] + ta, d[q])
    zero = torch.zeros_like(gr)
    o[k] = (torch.where(act, zero, gr), torch.where(act, zero, gi))
    sr, si = s * er, s * ei

    def keep(new, old):
        return tuple(torch.where(act, n, v) for n, v in zip(new, old))

    nx, ny = _rotate_pair(c, sr, si, x, y)
    for i in range(3):
        up, uq = _rotate_pair(c, sr, si, U[i][p], U[i][q])
        U[i][p], U[i][q] = keep(up, U[i][p]), keep(uq, U[i][q])
    return keep(nx, x), keep(ny, y)


def _conj(z):
    return z[0], -z[1]


def eigh3_jacobi(h):
    """Eigendecomposition ``(e (..., m), U (..., m, m))`` of the Hermitian
    part of complex128 ``h`` (..., m, m) for m <= 3, ascending, eigenvectors
    in columns: the PyTorch mirror of the register eigensolver of K12's and
    K31's fused entries (``csrc/small_eigen.cuh`` ``eigh_rn``), batched over
    the leading dimensions, the same operations in the same order. m = 1 is
    trivial; m = 2 the reference's branch-stable :func:`eigh2` on the
    Hermitian part; m = 3 a cyclic complex Jacobi: rotations (0, 1), (0, 2),
    (1, 2) with the stable tangent, each skipped where |h_pq| <= eps
    ||H||_F, :data:`JACOBI_SWEEPS` sweeps, then an ascending sort with the
    vectors (equal eigenvalues keep their order)."""
    m = h.shape[-1]
    if h.ndim < 2 or h.shape[-2] != m or not 1 <= m <= 3:
        raise ValueError(f"eigh3_jacobi takes (..., m, m) matrices with m <= 3, got {tuple(h.shape)}")
    d, o = _hermitian_parts(h)
    one, zero = torch.ones_like(d[0]), torch.zeros_like(d[0])
    if m == 1:
        return d[0][..., None], torch.complex(one, zero)[..., None, None]
    if m == 2:
        (br, bi), = o
        return _eigh2_rn(d[0], d[1], br, bi)
    f2 = (d[0] * d[0] + d[1] * d[1]) + d[2] * d[2]
    o2 = ((o[0][0] * o[0][0] + o[0][1] * o[0][1]) + (o[1][0] * o[1][0] + o[1][1] * o[1][1])) \
        + (o[2][0] * o[2][0] + o[2][1] * o[2][1])
    f2 = f2 + (o2 + o2)
    tol2 = _EPS2 * f2
    U = [[(one if i == j else zero, zero) for j in range(3)] for i in range(3)]
    for _ in range(JACOBI_SWEEPS):
        # (0, 1), r = 2: x = A_20 = conj(o_02), y = A_21 = conj(o_12)
        x, y = _jacobi_rotate(d, o, U, 0, 1, 0, _conj(o[1]), _conj(o[2]), tol2)
        o[1], o[2] = _conj(x), _conj(y)
        # (0, 2), r = 1: x = A_10 = conj(o_01), y = A_12 = o_12
        x, o[2] = _jacobi_rotate(d, o, U, 0, 2, 1, _conj(o[0]), o[2], tol2)
        o[0] = _conj(x)
        # (1, 2), r = 0: x = A_01 = o_01, y = A_02 = o_02
        o[0], o[1] = _jacobi_rotate(d, o, U, 1, 2, 2, o[0], o[1], tol2)
    e = list(d)
    for a, b in ((0, 1), (1, 2), (0, 1)):
        swap = e[a] > e[b]
        e[a], e[b] = torch.where(swap, e[b], e[a]), torch.where(swap, e[a], e[b])
        for i in range(3):
            ua, ub = U[i][a], U[i][b]
            U[i][a] = tuple(torch.where(swap, v, w) for v, w in zip(ub, ua))
            U[i][b] = tuple(torch.where(swap, v, w) for v, w in zip(ua, ub))
    Ut = torch.stack([torch.stack([torch.complex(*U[i][j]) for j in range(3)], dim=-1) for i in range(3)], dim=-2)
    return torch.stack(e, dim=-1), Ut


def eigh_small(h):
    """Eigendecomposition dispatch ``(e, U)``, ascending, eigenvectors in
    columns: the closed form ``eigh2`` for m = 2; otherwise
    ``torch.linalg.eigh``, in chunks of :func:`eigh_chunked` on the card."""
    if h.shape[-1] == 2:
        return eigh2(h)
    if h.device.type == "cuda":
        return eigh_chunked(h)
    return torch.linalg.eigh(h)
