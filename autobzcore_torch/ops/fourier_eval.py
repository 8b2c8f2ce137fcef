"""Fourier-series evaluation at points (reference
``autobzcore_tpu/ops/fourier_eval.py``, kernel family B1).

Conventions as in the reference: coefficients ``c[(n_1..n_d), V...]``,
integer offsets ``o`` and periods ``t``; the series is
``s(x) = sum_n c[n] exp(2 pi i (n + o) . x / t)``.

``fourier_points`` is the wrapper of kernel K1 (``csrc/fourier_points.cu``):
on CUDA tensors it launches the kernel, on CPU tensors it runs
``fourier_points_plain``, the dimension-by-dimension contraction of the
reference. The grid, ``contract`` and Jacobian forms come with later slices
(ROADMAP A3).
"""
from __future__ import annotations

import math

import torch

from .._device import COMPLEX, REAL, check_tensor
from .cuda_lib import check_launch, load_kernels

_PLAIN_CHUNK = 1 << 15  # points per contraction in the plain version


def phase_matrix(x, n, offset, period):
    """(K, n) matrix ``exp(2 pi i f x / t)``, f = offset + 0..n-1."""
    f = offset + torch.arange(n, dtype=REAL, device=x.device)
    ang = (2 * math.pi) * torch.outer(x / period, f)
    return torch.polar(torch.ones_like(ang), ang)


def fourier_points_plain(c, X, offsets, periods):
    """Plain PyTorch version of K1: contract the last spatial dimension with
    a (K, n_d) phase matrix, then the others point by point, in chunks of
    points so that intermediates stay small. Returns (K, *valshape)."""
    K, d = X.shape
    spatial, vshape = tuple(c.shape[:d]), tuple(c.shape[d:])
    v = c.reshape(spatial + (-1,))
    out = []
    for s in range(0, K, _PLAIN_CHUNK):
        Xc = X[s:s + _PLAIN_CHUNK]
        ph = phase_matrix(Xc[:, d - 1], spatial[d - 1], offsets[d - 1], periods[d - 1])
        w = torch.tensordot(ph, v, dims=([1], [d - 1]))  # (Kc, n_1..n_{d-1}, V)
        for j in range(d - 2, -1, -1):
            ph = phase_matrix(Xc[:, j], spatial[j], offsets[j], periods[j])
            w = torch.einsum("kn,kanv->kav", ph, w.reshape(w.shape[0], -1, spatial[j], w.shape[-1]))
            w = w.reshape((w.shape[0],) + spatial[:j] + (w.shape[-1],))
        out.append(w.reshape((-1,) + vshape))
    if not out:
        return torch.empty((0,) + vshape, dtype=c.dtype, device=c.device)
    return torch.cat(out)


def fourier_points(c, X, offsets, periods):
    """Evaluate the series with coefficients ``c`` (n_1..n_d, *valshape) at
    the points ``X`` (K, d), d <= 3: returns (K, *valshape) complex128.

    CPU tensors take the plain version; CUDA tensors launch K1, and anything
    the kernel does not take raises."""
    check_tensor(X, "X", dtype=REAL, ndim=2)
    K, d = X.shape
    if not 1 <= d <= 3 or c.ndim < d:
        raise ValueError(f"fourier_points takes 1 <= d <= 3 spatial dims, got X {tuple(X.shape)}")
    check_tensor(c, "c", device=X.device, dtype=COMPLEX)
    offsets = tuple(int(o) for o in offsets)
    periods = tuple(float(t) for t in periods)
    if len(offsets) != d or len(periods) != d:
        raise ValueError("offsets and periods need one entry per spatial dimension")
    if X.device.type == "cpu":
        return fourier_points_plain(c, X, offsets, periods)
    if X.device.type != "cuda":
        raise ValueError(f"fourier_points runs on cpu or cuda tensors, got {X.device}")
    spatial, vshape = tuple(c.shape[:d]), tuple(c.shape[d:])
    V = math.prod(vshape)
    lib = load_kernels()
    out = torch.empty((K,) + vshape, dtype=COMPLEX, device=X.device)
    pad = 3 - d
    n = (1,) * pad + spatial
    o = (0,) * pad + offsets
    t = (1.0,) * pad + periods
    stream = torch.cuda.current_stream(X.device).cuda_stream
    err = lib.fourier_points_launch(c.data_ptr(), X.data_ptr(), out.data_ptr(), K, d,
                                    *n, *o, *t, V, stream)
    check_launch(err, "fourier_points")
    fourier_points.launches += 1
    return out


fourier_points.launches = 0


def evaluate_points(c, spatial_ndim, X, offsets, periods, derivs=None, dtype=COMPLEX):
    """Evaluate at a batch ``X`` of shape (K, d) -> (K, *valshape), the
    reference's signature. Derivatives (the Jacobian form) come later
    (ROADMAP A3, kernel B1)."""
    if derivs is not None and any(derivs):
        raise NotImplementedError("derivative evaluation is not ported yet (ROADMAP A3, B1 Jacobian)")
    if dtype != COMPLEX or X.shape[1] != spatial_ndim:
        raise ValueError("evaluate_points takes complex128 series and (K, spatial_ndim) points")
    return fourier_points(c, X, offsets, periods)
