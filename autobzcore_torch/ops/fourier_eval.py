"""Fourier-series evaluation at points (reference
``autobzcore_tpu/ops/fourier_eval.py``, kernel family B1).

Conventions as in the reference: coefficients ``c[(n_1..n_d), V...]``,
integer offsets ``o`` and periods ``t``; the series is
``s(x) = sum_n c[n] exp(2 pi i (n + o) . x / t)``. A derivative of order k_j
along dimension j multiplies each term by ``(2 pi i f_j)^k_j``, f_j = o_j +
n_j: derivatives are with respect to the standardized coordinate z = x/t.

``fourier_points`` is the wrapper of kernel K1 (``csrc/fourier_points.cu``):
on CUDA tensors it launches the kernel, on CPU tensors it runs
``fourier_points_plain``, the dimension-by-dimension contraction of the
reference. ``fourier_points_derivs`` is the wrapper of kernel K11 (the same
source): up to four derivative orders at once, the Jacobian ``(H, dH/dz_j)``
of :func:`evaluate_points_jacobian` among them; its plain version
``fourier_points_derivs_plain`` runs K1's plain version on the
derivative-scaled coefficients of :func:`derivative_coefficients`.

``fourier_contract`` is the wrapper of kernel K3 (``csrc/fourier_contract.cu``),
the lane-batched form of the reference's ``contract``: per-lane coefficient
tensors have their last spatial variable fixed at per-lane points, which is
how the nested solver contracts the series once per outer node.
``fourier_contract_plain`` is its plain version.

``evaluate_grid`` is the grid form: one complex128 product per dimension
against (derivative-scaled) phase tables, plain large matrix products as the
reference leaves them to XLA.
"""
from __future__ import annotations

import ctypes
import math

import torch

from .._device import COMPLEX, REAL, check_tensor
from .cuda_lib import check_launch, load_kernels, stream_handle

_PLAIN_CHUNK = 1 << 15  # points per contraction in the plain version, at most
_PLAIN_ENTRIES = 1 << 27  # entries of its largest intermediate (2 GiB of complex128)


def phase_matrix(x, n, offset, period, deriv=0):
    """(*x.shape, n) phases ``(2 pi i f)^deriv exp(2 pi i f x / t)``,
    f = offset + 0..n-1."""
    f = offset + torch.arange(n, dtype=REAL, device=x.device)
    ang = (2 * math.pi) * ((x / period)[..., None] * f)
    ph = torch.polar(torch.ones_like(ang), ang)
    if deriv:
        ph = ph * _deriv_factor(f, deriv)
    return ph


def _deriv_factor(f, k):
    """``(2 pi i f)^k`` for the frequencies f (float64), by repeated products
    as the reference's integer power."""
    base = (2j * math.pi) * f.to(COMPLEX)
    out = base
    for _ in range(int(k) - 1):
        out = out * base
    return out


def derivative_coefficients(c, d, offsets, orders):
    """The coefficients of the derivative series: c (n_1..n_d, *valshape)
    and R orders (each d non-negative ints) give (n_1..n_d, R, *valshape)
    with channel r holding ``c[n] prod_j (2 pi i f_j)^orders[r][j]``."""
    spatial = tuple(c.shape[:d])
    chans = []
    for order in orders:
        scale = torch.ones(spatial, dtype=COMPLEX, device=c.device)
        for j, k in enumerate(order):
            if k:
                f = offsets[j] + torch.arange(spatial[j], dtype=REAL, device=c.device)
                shape = [1] * d
                shape[j] = -1
                scale = scale * _deriv_factor(f, k).reshape(shape)
        chans.append(c * scale.reshape(spatial + (1,) * (c.ndim - d)))
    return torch.stack(chans, dim=d)


def jacobian_orders(d):
    """The Jacobian's orders: zero, then one along each dimension."""
    return ((0,) * d,) + tuple(tuple(int(i == j) for i in range(d)) for j in range(d))


def fourier_points_plain(c, X, offsets, periods):
    """Plain PyTorch version of K1: contract the last spatial dimension with
    a (K, n_d) phase matrix, then the others point by point, in chunks of
    points so that the intermediates stay under 2 GiB. Returns (K, *valshape)."""
    K, d = X.shape
    spatial, vshape = tuple(c.shape[:d]), tuple(c.shape[d:])
    v = c.reshape(spatial + (-1,))
    chunk = max(1, min(_PLAIN_CHUNK, _PLAIN_ENTRIES // (math.prod(spatial[:-1]) * v.shape[-1] or 1)))
    out = []
    for s in range(0, K, chunk):
        Xc = X[s:s + chunk]
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
    stream = stream_handle(X.device)
    err = lib.fourier_points_launch(c.data_ptr(), X.data_ptr(), out.data_ptr(), K, d,
                                    *n, *o, *t, V, stream)
    check_launch(err, "fourier_points")
    fourier_points.launches += 1
    return out


fourier_points.launches = 0

_MAX_ORDERS = 4  # derivative orders per K11 launch


def _check_orders(orders, d):
    orders = tuple(tuple(int(k) for k in o) for o in orders)
    if not 1 <= len(orders) <= _MAX_ORDERS:
        raise ValueError(f"K11 takes 1 to {_MAX_ORDERS} derivative orders, got {len(orders)}")
    if any(len(o) != d or min(o) < 0 for o in orders):
        raise ValueError(f"each derivative order needs {d} non-negative entries, got {orders}")
    return orders


def fourier_points_derivs_plain(c, X, offsets, periods, orders):
    """Plain PyTorch version of K11: K1's plain version on the
    derivative-scaled coefficients. Returns (K, R, *valshape)."""
    d = X.shape[1]
    vshape = tuple(c.shape[d:])
    ca = derivative_coefficients(c, d, offsets, orders)
    out = fourier_points_plain(ca.reshape(tuple(c.shape[:d]) + (-1,)), X, offsets, periods)
    return out.reshape((X.shape[0], len(orders)) + vshape)


def fourier_points_derivs(c, X, offsets, periods, orders):
    """Evaluate R <= 4 derivatives of the series with coefficients ``c``
    (n_1..n_d, *valshape) at the points ``X`` (K, d), d <= 3: ``orders``
    holds R tuples of d non-negative orders (with respect to z = x/t), and
    the result is (K, R, *valshape) complex128, output r the derivative of
    ``orders[r]`` (all zeros is the series itself).

    CPU tensors take the plain version; CUDA tensors launch K11, and anything
    the kernel does not take raises."""
    check_tensor(X, "X", dtype=REAL, ndim=2)
    K, d = X.shape
    if not 1 <= d <= 3 or c.ndim < d:
        raise ValueError(f"fourier_points_derivs takes 1 <= d <= 3 spatial dims, got X {tuple(X.shape)}")
    check_tensor(c, "c", device=X.device, dtype=COMPLEX)
    offsets = tuple(int(o) for o in offsets)
    periods = tuple(float(t) for t in periods)
    if len(offsets) != d or len(periods) != d:
        raise ValueError("offsets and periods need one entry per spatial dimension")
    orders = _check_orders(orders, d)
    if X.device.type == "cpu":
        return fourier_points_derivs_plain(c, X, offsets, periods, orders)
    if X.device.type != "cuda":
        raise ValueError(f"fourier_points_derivs runs on cpu or cuda tensors, got {X.device}")
    spatial, vshape = tuple(c.shape[:d]), tuple(c.shape[d:])
    V, R = math.prod(vshape), len(orders)
    lib = load_kernels()
    out = torch.empty((K, R) + vshape, dtype=COMPLEX, device=X.device)
    pad = 3 - d
    n = (1,) * pad + spatial
    o = (0,) * pad + offsets
    t = (1.0,) * pad + periods
    flat = (ctypes.c_int * (R * d))(*[k for order in orders for k in order])
    stream = stream_handle(X.device)
    err = lib.fourier_points_derivs_launch(c.data_ptr(), X.data_ptr(), out.data_ptr(), K, d,
                                           *n, *o, *t, V, R, flat, stream)
    check_launch(err, "fourier_points_derivs")
    fourier_points_derivs.launches += 1
    return out


fourier_points_derivs.launches = 0


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
    stream = stream_handle(x.device)
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
    signature; one lane of :func:`fourier_contract`). As the reference, only
    the last entry of ``derivs`` is read: it scales the contracted axis's
    coefficients by ``(2 pi i f)^k`` before K3 contracts them."""
    if dtype != COMPLEX:
        raise ValueError("contract takes complex128 series")
    d = spatial_ndim
    k = 0 if derivs is None else int(derivs[d - 1])
    if k:
        order = (0,) * (d - 1) + (k,)
        c = derivative_coefficients(c, d, offsets, (order,)).squeeze(d)
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
    matrix, scaled by ``(2 pi i f)^derivs[j]`` (the reference's signature)."""
    if dtype != COMPLEX:
        raise ValueError("evaluate_grid takes complex128 series")
    d = spatial_ndim
    derivs = (0,) * d if derivs is None else tuple(derivs)
    vshape = tuple(c.shape[d:])
    v = c.reshape(tuple(c.shape[:d]) + (-1,))
    for j in range(d - 1, -1, -1):
        # after each contraction one grid axis prepends and one spatial axis
        # drops, so the axis holding n_j is always position d-1
        x = torch.as_tensor(nodes[j], dtype=REAL, device=c.device)
        ph = phase_matrix(x, v.shape[d - 1], offsets[j], periods[j], derivs[j])
        v = torch.tensordot(ph, v, dims=([1], [d - 1]))
    return v.reshape(tuple(v.shape[:d]) + vshape)


def evaluate_points(c, spatial_ndim, X, offsets, periods, derivs=None, dtype=COMPLEX):
    """Evaluate at a batch ``X`` of shape (K, d) -> (K, *valshape), the
    reference's signature: K1 at order zero, K11 for a derivative."""
    if dtype != COMPLEX or X.shape[1] != spatial_ndim:
        raise ValueError("evaluate_points takes complex128 series and (K, spatial_ndim) points")
    if derivs is None or not any(derivs):
        return fourier_points(c, X, offsets, periods)
    return fourier_points_derivs(c, X, offsets, periods, (tuple(derivs),))[:, 0]


def evaluate_points_jacobian(c, spatial_ndim, X, offsets, periods, dtype=COMPLEX):
    """Evaluate ``(h (K, *val), v (K, d, *val))`` at the points X (K, d),
    the gradient with respect to z = x/t, in one K11 launch (the reference's
    signature). Both are views of one (K, d + 1, *val) tensor."""
    if dtype != COMPLEX or X.shape[1] != spatial_ndim:
        raise ValueError("evaluate_points_jacobian takes complex128 series and (K, spatial_ndim) points")
    out = fourier_points_derivs(c, X, offsets, periods, jacobian_orders(spatial_ndim))
    return out[:, 0], out[:, 1:]
