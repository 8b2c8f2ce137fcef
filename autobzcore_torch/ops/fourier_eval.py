"""Fourier-series evaluation at points (reference
``autobzcore_tpu/ops/fourier_eval.py``, kernel family B1).

Conventions as in the reference: coefficients ``c[(n_1..n_d), V...]``,
integer offsets ``o`` and periods ``t``; the series is
``s(x) = sum_n c[n] exp(2 pi i (n + o) . x / t)``.

``fourier_points`` is the wrapper of kernel K1 (``csrc/fourier_points.cu``):
on CUDA tensors it launches the kernel, on CPU tensors it runs
``fourier_points_plain``, the dimension-by-dimension contraction of the
reference.

``fourier_contract`` is the wrapper of kernel K3 (``csrc/fourier_contract.cu``),
the lane-batched form of the reference's ``contract``: per-lane coefficient
tensors have their last spatial variable fixed at per-lane points, which is
how the nested solver contracts the series once per outer node.
``fourier_contract_plain`` is its plain version.

``evaluate_grid`` is the grid form: one complex128 product per dimension,
plain large matrix products as the reference leaves them to XLA. The
Jacobian form comes with a later slice (ROADMAP A3).
"""
from __future__ import annotations

import math

import torch

from .._device import COMPLEX, REAL, check_tensor
from .cuda_lib import check_launch, load_kernels

_PLAIN_CHUNK = 1 << 15  # points per contraction in the plain version


def phase_matrix(x, n, offset, period):
    """(*x.shape, n) phases ``exp(2 pi i f x / t)``, f = offset + 0..n-1."""
    f = offset + torch.arange(n, dtype=REAL, device=x.device)
    ang = (2 * math.pi) * ((x / period)[..., None] * f)
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


def fourier_contract_plain(c, cmap, x, offset, period):
    """Plain PyTorch version of K3: ``out[l, j, r, v] = sum_n c[cmap[l], r, n,
    v] exp(2 pi i (offset + n) x[l, j] / period)`` for c (Lc, n_1..n_k, V),
    cmap (L,) and x (L, J); returns (L, J, n_1..n_{k-1}, V)."""
    L, J = x.shape
    n, V = c.shape[-2], c.shape[-1]
    rest = tuple(c.shape[1:-2])
    ph = phase_matrix(x, n, offset, period)  # (L, J, n)
    cl = c.reshape(c.shape[0], -1, n, V)[cmap]  # (L, R, n, V)
    out = torch.einsum("ljn,lrnv->ljrv", ph, cl)
    return out.reshape((L, J) + rest + (V,))


def fourier_contract(c, cmap, x, offset, period):
    """Fix the last spatial variable of per-lane coefficient tensors at
    per-lane points: c (Lc, n_1..n_k, V) complex128, the lane map cmap (L,)
    int64 into c's first axis, and x (L, J) float64 give (L, J, n_1..n_{k-1},
    V). With k = 1 this evaluates 1-D series at the points.

    CPU tensors take the plain version; CUDA tensors launch K3, and anything
    the kernel does not take raises."""
    check_tensor(x, "x", dtype=REAL, ndim=2)
    L, J = x.shape
    check_tensor(c, "c", device=x.device, dtype=COMPLEX)
    check_tensor(cmap, "cmap", device=x.device, dtype=torch.int64, ndim=1, shape=(L,))
    if c.ndim < 3:
        raise ValueError(f"c must be (Lc, n_1..n_k, V), got {tuple(c.shape)}")
    offset, period = int(offset), float(period)
    if x.device.type == "cpu":
        return fourier_contract_plain(c, cmap, x, offset, period)
    if x.device.type != "cuda":
        raise ValueError(f"fourier_contract runs on cpu or cuda tensors, got {x.device}")
    n, V = c.shape[-2], c.shape[-1]
    if n > _CONTRACT_MAX_N:
        raise ValueError(f"fourier_contract takes at most {_CONTRACT_MAX_N} frequencies, got {n}")
    R = math.prod(c.shape[1:-2])
    out = torch.empty((L, J) + tuple(c.shape[1:-2]) + (V,), dtype=COMPLEX, device=x.device)
    if out.numel() == 0:
        return out
    lib = load_kernels()
    stream = torch.cuda.current_stream(x.device).cuda_stream
    err = lib.fourier_contract_launch(c.data_ptr(), cmap.data_ptr(), x.data_ptr(), out.data_ptr(),
                                      L, J, R, n, V, c.shape[0], offset, period, stream)
    check_launch(err, "fourier_contract")
    fourier_contract.launches += 1
    return out


fourier_contract.launches = 0
_CONTRACT_MAX_N = 1024  # frequencies of the contracted axis that K3 keeps in shared memory


def contract(c, spatial_ndim, x, offsets, periods, derivs=None, dtype=COMPLEX):
    """Fix the last spatial variable at scalar ``x``: the coefficient tensor
    (n_1..n_{d-1}, *val) of the remaining (d-1)-dim series (the reference's
    signature; one lane of :func:`fourier_contract`)."""
    if derivs is not None and any(derivs):
        raise NotImplementedError("derivative contraction is not ported yet (ROADMAP A3, B1 Jacobian)")
    if dtype != COMPLEX:
        raise ValueError("contract takes complex128 series")
    d = spatial_ndim
    vshape = tuple(c.shape[d:])
    c1 = c.reshape((1,) + tuple(c.shape[:d]) + (-1,))
    xl = torch.as_tensor(x, dtype=REAL, device=c.device).reshape(1, 1)
    cmap = torch.zeros(1, dtype=torch.int64, device=c.device)
    out = fourier_contract(c1.contiguous(), cmap, xl, offsets[d - 1], periods[d - 1])
    return out.reshape(tuple(c.shape[:d - 1]) + vshape)


def evaluate_grid(c, spatial_ndim, nodes, offsets, periods, derivs=None, dtype=COMPLEX):
    """Evaluate on the tensor grid ``nodes[0] x ... x nodes[d-1]``: returns
    (len(nodes[0]), ..., len(nodes[d-1]), *valshape), one dimension at a
    time, each a complex128 product against a (len(nodes[j]), n_j) phase
    matrix (the reference's signature; derivatives come with ROADMAP A3)."""
    if derivs is not None and any(derivs):
        raise NotImplementedError("derivative evaluation is not ported yet (ROADMAP A3, B1 Jacobian)")
    if dtype != COMPLEX:
        raise ValueError("evaluate_grid takes complex128 series")
    d = spatial_ndim
    vshape = tuple(c.shape[d:])
    v = c.reshape(tuple(c.shape[:d]) + (-1,))
    for j in range(d - 1, -1, -1):
        # after each contraction one grid axis prepends and one spatial axis
        # drops, so the axis holding n_j is always position d-1
        x = torch.as_tensor(nodes[j], dtype=REAL, device=c.device)
        ph = phase_matrix(x, v.shape[d - 1], offsets[j], periods[j])
        v = torch.tensordot(ph, v, dims=([1], [d - 1]))
    return v.reshape(tuple(v.shape[:d]) + vshape)


def evaluate_points(c, spatial_ndim, X, offsets, periods, derivs=None, dtype=COMPLEX):
    """Evaluate at a batch ``X`` of shape (K, d) -> (K, *valshape), the
    reference's signature. Derivatives (the Jacobian form) come later
    (ROADMAP A3, kernel B1)."""
    if derivs is not None and any(derivs):
        raise NotImplementedError("derivative evaluation is not ported yet (ROADMAP A3, B1 Jacobian)")
    if dtype != COMPLEX or X.shape[1] != spatial_ndim:
        raise ValueError("evaluate_points takes complex128 series and (K, spatial_ndim) points")
    return fourier_points(c, X, offsets, periods)
