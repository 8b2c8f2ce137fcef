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
"""
from __future__ import annotations

import math

import torch

from .._device import COMPLEX, REAL, check_tensor
from .cuda_lib import check_launch, load_kernels

# matrices per torch.linalg.eigvalsh call on the card: cuSOLVER's batched
# solver (cusolverDnXsyevBatched) took 16,384 complex 3x3 matrices and
# refused 32,768 and more with CUSOLVER_STATUS_INVALID_VALUE on an H100;
# larger matrices take proportionally fewer, in case the limit is on entries
EIGVALSH_CHUNK = 16384


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
    eigenvectors).

    Branch-stable: the upper-band eigenvector uses ``[d + r, conj(b)]`` for
    ``d >= 0`` and ``[b, r - d]`` otherwise, with an identity fallback at
    exact degeneracy r = 0."""
    a = h[..., 0, 0].real
    c = h[..., 1, 1].real
    b = h[..., 0, 1]
    d = (a - c) / 2
    r = torch.sqrt(d**2 + b.abs() ** 2)
    mean = (a + c) / 2
    e = torch.stack([mean - r, mean + r], dim=-1)

    pos = d >= 0
    v0 = torch.where(pos, (d + r).to(h.dtype), b)
    v1 = torch.where(pos, b.conj(), (r - d).to(h.dtype))
    n = torch.sqrt(v0.abs() ** 2 + v1.abs() ** 2)
    ok = n > 0
    nsafe = torch.where(ok, n, torch.ones_like(n))
    # degenerate (r = 0): any orthonormal pair works; use the identity
    up0 = torch.where(ok, v0 / nsafe, torch.zeros_like(v0))
    up1 = torch.where(ok, v1 / nsafe, torch.ones_like(v1))
    lo0 = -up1.conj()
    lo1 = up0.conj()
    U = torch.stack([torch.stack([lo0, up0], dim=-1), torch.stack([lo1, up1], dim=-1)], dim=-2)
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
        stream = torch.cuda.current_stream(h.device).cuda_stream
        check_launch(lib.eigvalsh_small_launch(flat.data_ptr(), out.data_ptr(), K, m, stream),
                     "eigvalsh_small")
        eigvalsh_small.launches += 1
    return out.reshape(batch + (m,))


eigvalsh_small.launches = 0


def eigh_small(h):
    """Eigendecomposition dispatch: closed form for m = 2 (``eigh2``),
    ``torch.linalg.eigh`` otherwise."""
    if h.shape[-1] == 2:
        return eigh2(h)
    return torch.linalg.eigh(h)
