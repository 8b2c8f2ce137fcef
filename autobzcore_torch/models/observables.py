"""Spectral observables as integrand kernels (reference
``autobzcore_tpu/models/observables.py``, kernel family B3).

``dos_trace`` and ``greens_function_trace`` are plain PyTorch and broadcast
over frequency blocks exactly as the reference does: ``om`` may carry
leading axes, which become new leading axes of the result.

``dos_trace_weighted_sum`` is the wrapper of kernel K2
(``csrc/dos_trace.cu``): the PTR rule's weighted k-sum of ``dos_trace``,
fused so that the (W, K) matrix of traces never exists. Above three bands
it sums the eigenvalue form instead: batched ``eigvalsh``, then kernel K8's
weighted Lorentzian sum.

``gk_leaf_dos`` is the wrapper of kernel K4 (``csrc/gk_leaf_dos.cu``): the
innermost level of a nested Gauss-Kronrod solve of ``dos_trace``, fused from
the 1-D series values at the Kronrod nodes, the trace and the rule's
reduction, so that node values never reach device memory. It also takes an
omega block of W frequencies per lane (``SweepSolver(block=W)``).

``gm_leaf_dos`` is the wrapper of kernel K15 (``csrc/gm_rule.cu``): the
Genz-Malik box rule of a cubature solve of ``dos_trace`` (``HCubatureJL``,
``TAI``), fused from the series values at the rule's nodes (K1) through the
trace to ``val7``, ``err`` and ``splitdim``, so that the trace values never
reach device memory; one frequency or an omega block per box.

``dos_eig`` sums over every axis, the omega block's too, so it cannot run
blocked (the reference's example of a reducing integrand).

The transport family (reference ``observables.py:23-66, 175-393``): the
spectral velocity pack (``spectral_velocity_pack``: K11 at the grid's
representatives through ``gathered_grid``'s point form, ``eigh``, then
kernel K18, ``velocity_pairs``, ``csrc/velocity_pairs.cu``, in chunks of
``ops.eigh3.EIGH_CHUNK`` points), ``TransportSolver`` and ``transport_sweep``
(one launch of kernel K19, ``transport_gamma``,
``csrc/transport_gamma.cu``, at equal frequencies over all omegas), the
certified ladder (host code) and the per-point PTR integrand
``transport_distribution`` (plain torch operations).
"""
from __future__ import annotations

import inspect
import math
from typing import NamedTuple

import numpy as np
import torch

from .._device import COMPLEX, REAL, check_tensor
from ..algorithms.ptr import register_kernel_sum
from ..brillouin import LatticeRep, TrivialRep
from ..fourier import FourierIntegrand, FourierSeries, FourierValue, JacobianSeries
from ..ops.adaptive import (ReducedChildren, _check_pool, gk_nodes, gk_rule_reduce_plain, pool_kernels,
                            refine_lanes)
from ..ops.cuda_lib import check_launch, load_kernels, stream_handle
from ..ops.fourier_eval import (fourier_contract_plain, fourier_points, fourier_points_derivs,
                                jacobian_orders)


def _trace_inv_small(M):
    """Tr M^{-1} by the adjugate identity for m <= 3."""
    m = M.shape[-1]
    if m == 1:
        return 1.0 / M[..., 0, 0]
    tr = torch.diagonal(M, dim1=-2, dim2=-1).sum(-1)
    det = torch.linalg.det(M)
    if m == 2:
        return tr / det
    tr2 = torch.sum(M * M.transpose(-1, -2), dim=(-1, -2))  # tr(M^2) = sum_ij M_ij M_ji
    return (tr * tr - tr2) / (2.0 * det)


def _inv_small(M):
    """M^{-1} of a general (..., m, m) complex matrix: 1/M for m = 1, the
    adjugate over det for m = 2 and 3 (for m = 3 its rows are the cross
    products of column pairs), ``torch.linalg.solve`` against the identity
    above (reference ``observables.py:89``)."""
    m = M.shape[-1]
    if m == 1:
        return 1.0 / M
    if m > 3:
        return torch.linalg.solve(M, torch.eye(m, dtype=M.dtype, device=M.device).expand(M.shape))
    det = torch.linalg.det(M)[..., None, None]
    if m == 2:
        a, b, c, d = M[..., 0, 0], M[..., 0, 1], M[..., 1, 0], M[..., 1, 1]
        adj = torch.stack([torch.stack([d, -b], -1), torch.stack([-c, a], -1)], -2)
        return adj / det
    c0, c1, c2 = M[..., :, 0], M[..., :, 1], M[..., :, 2]
    adj = torch.stack([torch.linalg.cross(c1, c2), torch.linalg.cross(c2, c0), torch.linalg.cross(c0, c1)], -2)
    return adj / det


def greens_function_trace(hv, om, eta=None):
    """Tr (om + i eta - H(k))^{-1}: the adjugate trace for m <= 3, the
    eigenvalue sum ``sum_i 1/(z - e_i)`` for larger Hermitian H."""
    h = hv.s
    m = h.shape[-1]
    z = torch.as_tensor(om, dtype=REAL, device=h.device) \
        + 1j * torch.as_tensor(eta, dtype=REAL, device=h.device)
    if m <= 3:
        # om may carry leading axes (a frequency block sharing one H(k)):
        # they broadcast as new leading dims of the result
        zI = z[..., None, None] * torch.eye(m, dtype=h.dtype, device=h.device)
        return _trace_inv_small(zI - h)
    e = torch.linalg.eigvalsh(h)
    return torch.sum(1.0 / (z[..., None] - e), dim=-1)


def dos_trace(hv, om, eta=None):
    """Lorentzian-broadened DOS integrand ``-Im Tr G / pi``."""
    return -torch.imag(greens_function_trace(hv, om, eta=eta)) / math.pi


def dos_eig(hv, om, eta=None):
    """DOS via eigenvalues, summed over every axis:
    ``sum eta / ((om - e)^2 + eta^2) / pi``."""
    e = torch.linalg.eigvalsh(hv.s)
    return torch.sum(eta / ((om - e) ** 2 + eta**2)) / math.pi


def _under_vmap(*ts):
    """True when a tensor is a functorch-batched view (inside ``vmap``),
    which no kernel can read."""
    return any(torch._C._functorch.is_batchedtensor(t) for t in ts)


def flat_pairs(H, Z, scalar=False):
    """H and Z broadcast over their batch axes: (H (N, m, m), Z (N, m, m) or
    one (m, m) for all, batch shape); with ``scalar``, Z holds the z of z I:
    (N,) or one () for all."""
    m = H.shape[-1]
    zbatch = tuple(Z.shape) if scalar else tuple(Z.shape[:-2])
    batch = torch.broadcast_shapes(tuple(H.shape[:-2]), zbatch)
    Hf = H.expand(batch + (m, m)).reshape(-1, m, m).contiguous()
    if scalar:
        Zf = Z.contiguous() if Z.ndim == 0 else Z.expand(batch).reshape(-1).contiguous()
    else:
        Zf = Z.contiguous() if Z.ndim == 2 else Z.expand(batch + (m, m)).reshape(-1, m, m).contiguous()
    return Hf, Zf, batch


def spectral_of(G):
    """The matrix spectral function ``-(G - G^H) / (2 pi i)`` of Green's
    functions G (..., m, m)."""
    return (G - G.conj().transpose(-1, -2)) / (-2j * math.pi)


def spectral_function(hv, om, eta=None):
    """Full matrix spectral function ``A(k, om) = -(G - G^H) / (2 pi i)``,
    ``G = ((om + i eta) I - H)^{-1}`` by :func:`_inv_small` (reference
    ``observables.py:160``). ``om`` and ``eta`` may carry leading axes
    (lanes, or one per point of a batch), which broadcast against H's. On a
    batch of points it runs :func:`spectral_points` at the points' z = om +
    i eta (K27's matrix pointwise entry on the card).
    Inside ``vmap`` no kernel can launch: CPU tensors take the plain
    arithmetic there, and card tensors raise, so that an adaptive solve on
    the card builds ``FourierIntegrand(spectral_function, h, eta=...,
    batched=True)``. A PTR rule sums it through K27's matrix mode without
    calling it."""
    h = hv.s
    m = h.shape[-1]
    z = torch.as_tensor(om, dtype=REAL, device=h.device) + 1j * torch.as_tensor(eta, dtype=REAL, device=h.device)
    if _under_vmap(h, z):
        if h.device.type != "cpu":
            raise ValueError("spectral_function cannot launch K27 under vmap: on the card, solve "
                             "FourierIntegrand(spectral_function, h, eta=..., batched=True)")
        return spectral_points_plain(h, z[..., None, None] * torch.eye(m, dtype=COMPLEX, device=h.device))
    Hf, zf, batch = flat_pairs(h, z, scalar=True)
    return spectral_points(Hf, zf).reshape(tuple(batch) + (m, m))


def _check_pairs(H, Z, scalar_ok=False):
    """(N, m) of H (N, m, m) and Z, (m, m) or (N, m, m), or with
    ``scalar_ok`` also the z of z I, () or (N,); raises on anything else."""
    check_tensor(H, "H", dtype=COMPLEX, ndim=3)
    N, m = H.shape[0], H.shape[-1]
    check_tensor(H, "H", shape=(N, m, m))
    shapes = ((m, m), (N, m, m)) + (((), (N,)) if scalar_ok else ())
    if not isinstance(Z, torch.Tensor) or Z.dtype != COMPLEX or Z.device != H.device or not Z.is_contiguous() \
            or tuple(Z.shape) not in shapes:
        raise ValueError(f"Z must be a contiguous complex128 (m, m) or (N, m, m) tensor"
                         f"{', or z () or (N,),' if scalar_ok else ''} on H's device, m = {m}, N = {N}")
    return N, m


def _as_matrix(Z, m):
    """Z as matrices: a z (W,) or () becomes z I."""
    return Z[..., None, None] * torch.eye(m, dtype=COMPLEX, device=Z.device) if Z.ndim <= 1 else Z


def _check_bands(m):
    """K27 takes m <= sigma_max_bands(): asked of the library only above three bands."""
    if m > 3 and m > load_kernels().sigma_max_bands():
        raise ValueError(f"K27 takes m <= {load_kernels().sigma_max_bands()}, got {m}")


def spectral_points_plain(H, Z):
    """Plain PyTorch version of K27's matrix pointwise entry: ``A(Z_n -
    H_n)`` (N, m, m), the reference's operations (``_inv_small``, then
    ``-(G - G^H) / (2 pi i)``); a z (N,) or () stands for z I."""
    return spectral_of(_inv_small(_as_matrix(Z, H.shape[-1]) - H))


def spectral_points(H, Z):
    """``A[n] = -(G - G^H) / (2 pi i)``, ``G = (Z_n - H_n)^{-1}``, for H (N,
    m, m) complex128 and Z (N, m, m), or one (m, m) for all, or the z of Z =
    z I, (N,) or one () for all (``spectral_function``'s form), complex128.
    H must be Hermitian, as every caller's is; the kernel takes it as given,
    as the plain version does. Returns (N, m, m) complex128.

    CPU tensors take the plain version; CUDA tensors launch K27's matrix
    pointwise entry (``csrc/sigma_trace.cu``), which takes m <= 8, and
    anything the kernel does not take raises."""
    N, m = _check_pairs(H, Z, scalar_ok=True)
    if H.device.type == "cpu":
        return spectral_points_plain(H, Z)
    if H.device.type != "cuda":
        raise ValueError(f"spectral_points runs on cpu or cuda tensors, got {H.device}")
    _check_bands(m)
    scalar = Z.ndim <= 1
    if scalar and m > 3:  # the z form runs at m <= 3
        Z, scalar = _as_matrix(Z, m).contiguous(), False
    out = torch.empty((N, m, m), dtype=COMPLEX, device=H.device)
    if N == 0:
        return out
    stride = (0 if Z.ndim == 0 else 1) if scalar else (0 if Z.ndim == 2 else m * m)
    check_launch(load_kernels().sigma_spectral_points_launch(H.data_ptr(), Z.data_ptr(), stride, int(scalar),
                                                             out.data_ptr(), N, m, _INV_2PI, stream_handle(H.device)),
                 "spectral_points")
    spectral_points.launches += 1
    return out


_INV_2PI = 1.0 / (2 * math.pi)


spectral_points.launches = 0


def spectral_weighted_sum_plain(H, w, Z, scale, chunk=8):
    """Plain PyTorch version of K27's matrix mode, the reference's
    operations: per frequency ``A(Z_w - H_k)`` by :func:`_inv_small` and the
    weighted k-sum, ``chunk`` frequencies at a time and k in chunks (at most
    EIGH_CHUNK matrices a ``solve`` above three bands); a z (W,) stands for
    z I. Returns (W, m, m) complex128."""
    from ..ops.eigh3 import EIGH_CHUNK

    K, m = H.shape[0], H.shape[-1]
    Z = _as_matrix(Z, m)
    C = max(1, int(chunk))
    kc = max(1, (1 << 22) // max(1, C * m * m))
    if m > 3:
        kc = min(kc, max(1, EIGH_CHUNK // C))
    rows = []
    for s in range(0, Z.shape[0], C):
        acc = 0.0
        for k0 in range(0, K, kc):
            A = spectral_of(_inv_small(Z[s:s + C, None] - H[None, k0:k0 + kc]))
            acc = acc + torch.einsum("k,ckab->cab", w[k0:k0 + kc].to(COMPLEX), A)
        rows.append(scale * acc)
    if not rows:
        return torch.empty((0, m, m), dtype=COMPLEX, device=H.device)
    return torch.cat(rows)


def spectral_weighted_sum(H, w, Z, scale):
    """``S[j] = scale * sum_k w_k A(Z_j - H_k)``, the weighted k-sum of the
    matrix spectral function, for H (K, m, m) complex128, weights w (K,)
    float64 and Z (W, m, m) complex128, or the lanes' z (W,) complex128 of
    Z_j = z_j I (``spectral_function`` under the PTR rule, z_j = om_j + i
    eta_j). H must be Hermitian: with z and m <= 3 the kernel reads its
    Hermitian part ``(H + H^H) / 2``, the plain version H as given. Returns
    (W, m, m) complex128, Hermitian.

    CPU tensors take the plain version; CUDA tensors launch K27's matrix
    mode (``csrc/sigma_trace.cu``), which takes m <= 8, and anything the
    kernel does not take raises."""
    check_tensor(H, "H", dtype=COMPLEX, ndim=3)
    K, m = H.shape[0], H.shape[-1]
    check_tensor(H, "H", shape=(K, m, m))
    check_tensor(w, "w", device=H.device, dtype=REAL, ndim=1, shape=(K,))
    check_tensor(Z, "Z", device=H.device, dtype=COMPLEX)
    W = Z.shape[0] if Z.ndim else -1
    if tuple(Z.shape) not in ((W,), (W, m, m)):
        raise ValueError(f"Z must be (W, m, m) or z (W,), m = {m}, got {tuple(Z.shape)}")
    if H.device.type == "cpu":
        return spectral_weighted_sum_plain(H, w, Z, float(scale))
    if H.device.type != "cuda":
        raise ValueError(f"spectral_weighted_sum runs on cpu or cuda tensors, got {H.device}")
    _check_bands(m)
    scalar = Z.ndim == 1
    if scalar and m > 3:  # the z form runs at m <= 3
        Z, scalar = _as_matrix(Z, m).contiguous(), False
    lib = load_kernels()
    out = torch.empty((W, m, m), dtype=COMPLEX, device=H.device)
    if W:
        partials = torch.empty((max(lib.sigma_spectral_num_rows(K), 1), W, m, m), dtype=COMPLEX, device=H.device)
        check_launch(lib.sigma_spectral_sum_launch(H.data_ptr(), w.data_ptr(), Z.data_ptr(), int(scalar),
                                                   partials.data_ptr(), out.data_ptr(), K, W, m,
                                                   float(scale) * _INV_2PI, stream_handle(H.device)),
                     "spectral_weighted_sum")
        spectral_weighted_sum.launches += 1
    return out


spectral_weighted_sum.launches = 0


def dos_integrand(h: FourierSeries, eta, rep=True):
    """FourierIntegrand for the broadened DOS, declaring TrivialRep. A PTR
    rule sums it with kernel K2."""
    fi = FourierIntegrand(dos_trace, h, eta=eta)
    if rep:
        fi.rep = TrivialRep()
    return fi


def dos_trace_weighted_sum_plain(H, w, omega, eta, scale):
    """Plain PyTorch version of K2: ``scale * sum_k w_k dos_trace(H_k,
    omega, eta)`` for frequency lanes ``omega``/``eta`` (W,), chunked over k
    so that the (W, chunk, m, m) intermediates stay near 64 MB."""
    K, m = H.shape[0], H.shape[-1]
    W = omega.shape[0]
    chunk = max(1, (1 << 22) // max(1, W * m * m))
    acc = torch.zeros(W, dtype=REAL, device=H.device)
    om, et = omega[:, None], eta[:, None]
    for s in range(0, K, chunk):
        acc = acc + dos_trace(FourierValue(None, H[s:s + chunk]), om, eta=et) @ w[s:s + chunk]
    return scale * acc


def dos_trace_weighted_sum(H, w, omega, eta, scale):
    """``D[j] = scale * sum_k w[k] * (-Im Tr (omega[j] + i eta[j] - H[k])^{-1})
    / pi`` for H (K, m, m) complex128, w (K,), omega and eta (W,) float64.

    CPU tensors take the plain version. On CUDA tensors m <= 3 launches K2;
    m > 3 takes the eigenvalue form, ``Tr (z - H)^{-1} = sum_b 1 / (z -
    e_b)``: ``eigvalsh_chunked`` (cuSOLVER in the batches it takes), then
    K8's weighted Lorentzian sum, once per distinct eta of the lanes.
    Anything else raises."""
    check_tensor(H, "H", dtype=COMPLEX, ndim=3)
    K, m = H.shape[0], H.shape[-1]
    check_tensor(H, "H", shape=(K, m, m))
    check_tensor(w, "w", device=H.device, dtype=REAL, shape=(K,), ndim=1)
    check_tensor(omega, "omega", device=H.device, dtype=REAL, ndim=1)
    W = omega.shape[0]
    check_tensor(eta, "eta", device=H.device, dtype=REAL, shape=(W,), ndim=1)
    if H.device.type == "cpu":
        return dos_trace_weighted_sum_plain(H, w, omega, eta, float(scale))
    if H.device.type != "cuda":
        raise ValueError(f"dos_trace_weighted_sum runs on cpu or cuda tensors, got {H.device}")
    if m > 3:
        return dos_eig_weighted_sum(H, w, omega, eta, float(scale))
    return _dos_trace_launch(H, w, omega, eta, float(scale), DOS_GRID_CAP)


DOS_GRID_CAP = 65535  # K2's grid rows: the hardware's limit on gridDim.y


def _dos_trace_launch(H, w, omega, eta, scale, grid_cap):
    """Launch K2 with at most ``grid_cap`` block rows (each row loops over
    k-chunks; the card test lowers the cap to hold the loop against the
    uncapped launch bit for bit)."""
    K, m = H.shape[0], H.shape[-1]
    W = omega.shape[0]
    lib = load_kernels()
    partials = torch.empty((W, max(lib.dos_trace_num_chunks(K), 1)), dtype=REAL, device=H.device)
    out = torch.empty(W, dtype=REAL, device=H.device)
    stream = stream_handle(H.device)
    err = lib.dos_trace_weighted_sum_launch(
        H.data_ptr(), w.data_ptr(), omega.data_ptr(), eta.data_ptr(), partials.data_ptr(),
        out.data_ptr(), K, W, m, -float(scale) / math.pi, int(grid_cap), stream)
    check_launch(err, "dos_trace_weighted_sum")
    dos_trace_weighted_sum.launches += 1
    return out


dos_trace_weighted_sum.launches = 0


def dos_eig_weighted_sum(H, w, omega, eta, scale):
    """The eigenvalue form of :func:`dos_trace_weighted_sum`, its route for
    m > 3 on the card: ``-Im sum_b 1 / (omega + i eta - e_b) / pi = eta /
    ((omega - e_b)^2 + eta^2) / pi``, so the eigenvalues of H (batched
    ``eigvalsh``, in the chunks cuSOLVER takes) and K8 with scale ``scale /
    pi`` give the sum, one launch per distinct eta over the lanes that carry
    it. CPU tensors take K8's plain version."""
    from ..ops.eigh3 import eigvalsh_chunked
    from ..ops.grid_sweep import lorentzian_sum

    e = eigvalsh_chunked(H)
    out = torch.empty(omega.shape[0], dtype=REAL, device=H.device)
    for et in torch.unique(eta).tolist():  # one host read: K8 takes a scalar eta
        sel = (eta == et).nonzero().squeeze(1)
        out[sel] = lorentzian_sum(e, w, omega[sel].contiguous(), et, scale / math.pi)
    return out


def gk_leaf_dos_plain(c, cmap, offset, period, ca, cb, om, eta, active, xk, wk, wg):
    """Plain PyTorch version of K4: per lane l of L, the
    1-D series with coefficients c[cmap[l]] (n, m*m) complex128 evaluated at
    the Kronrod nodes of the intervals (ca[l], cb[l]) (I of them),
    ``dos_trace`` at frequency om[l] and broadening eta[l], reduced by the
    rule. Returns val, err, l1 (L, I) and count (L,): I * npts for active
    lanes; inactive lanes give zeros. With om, eta (L, W), an omega block,
    ``dos_trace`` broadcasts over the W channels as the reference's
    (``observables.py:138-144``): val is (L, I, W) and err, l1 the 2-norms
    over the channels."""
    L, I = ca.shape
    P = xk.shape[0]
    m = math.isqrt(c.shape[-1])
    nodes, half = gk_nodes(ca, cb, xk)
    H = fourier_contract_plain(c, cmap, nodes.reshape(L, I * P), offset, period)
    if om.ndim == 1:
        D = dos_trace(FourierValue(None, H.reshape(L, I, P, m, m)), om[:, None, None],
                      eta=eta[:, None, None])
    else:
        D = dos_trace(FourierValue(None, H.reshape(L, I, P, 1, m, m)), om[:, None, None, :],
                      eta=eta[:, None, None, :])
    val, err, l1, count = gk_rule_reduce_plain(D, None, half, wk, wg)
    zero = torch.zeros((), dtype=REAL, device=ca.device)
    live = active[:, None]
    return (torch.where(live.reshape((L, 1) + (1,) * (val.ndim - 2)), val, zero),
            torch.where(live, err, zero), torch.where(live, l1, zero),
            torch.where(active, count, zero))


def gk_leaf_dos(c, cmap, offset, period, ca, cb, om, eta, active, xk, wk, wg):
    """The innermost rule evaluation of a nested DOS solve (see
    :func:`gk_leaf_dos_plain`): c (Lc, n, m*m) complex128 with m <= 3, cmap
    (L,) int64, ca/cb (L, I), om/eta (L,) float64 (one frequency per lane)
    or (L, W) (an omega block of W channels), active (L,) bool, and the
    rule's xk/wk/wg (npts,) float64.

    CPU tensors take the plain version; CUDA tensors launch K4 (one
    frequency per lane is its one-channel case), which takes m <= 3 and
    raises on anything else it does not take."""
    check_tensor(ca, "ca", dtype=REAL, ndim=2)
    L, I = ca.shape
    dev = ca.device
    check_tensor(cb, "cb", device=dev, dtype=REAL, shape=(L, I), ndim=2)
    check_tensor(c, "c", device=dev, dtype=COMPLEX, ndim=3)
    check_tensor(cmap, "cmap", device=dev, dtype=torch.int64, shape=(L,), ndim=1)
    block = om.ndim == 2
    W = om.shape[1] if block else 1
    for name, t in (("om", om), ("eta", eta)):
        check_tensor(t, name, device=dev, dtype=REAL, shape=(L, W) if block else (L,),
                     ndim=2 if block else 1)
    check_tensor(active, "active", device=dev, dtype=torch.bool, shape=(L,), ndim=1)
    P = xk.shape[0]
    for name, t in (("xk", xk), ("wk", wk), ("wg", wg)):
        check_tensor(t, name, device=dev, dtype=REAL, shape=(P,), ndim=1)
    m = math.isqrt(c.shape[-1])
    if m * m != c.shape[-1]:
        raise ValueError(f"c must hold square values, got V = {c.shape[-1]}")
    offset, period = int(offset), float(period)
    if dev.type == "cpu":
        return gk_leaf_dos_plain(c, cmap, offset, period, ca, cb, om, eta, active, xk, wk, wg)
    if dev.type != "cuda":
        raise ValueError(f"gk_leaf_dos runs on cpu or cuda tensors, got {dev}")
    if m > 3:
        raise NotImplementedError(
            f"the CUDA leaf DOS kernel takes m <= 3 bands, got m = {m}: above three bands the IAI nest "
            "evaluates the leaf by its generic route (algorithms/nested.py fuses the DOS leaf only at m <= 3)")
    if P > 64:
        raise ValueError(f"gk_leaf_dos takes at most 64 Kronrod nodes, got {P}")
    if W < 1:
        raise ValueError("gk_leaf_dos needs at least one frequency per lane")
    val = torch.empty((L, I, W) if block else (L, I), dtype=REAL, device=dev)
    err = torch.empty((L, I), dtype=REAL, device=dev)
    l1 = torch.empty_like(err)
    count = torch.empty((L,), dtype=REAL, device=dev)
    if L == 0 or I == 0:
        return val.zero_(), err.zero_(), l1.zero_(), count.zero_()
    lib = load_kernels()
    stream = stream_handle(dev)
    rc = lib.gk_leaf_dos_launch(
        c.data_ptr(), cmap.data_ptr(), ca.data_ptr(), cb.data_ptr(), om.data_ptr(), eta.data_ptr(),
        active.data_ptr(), xk.data_ptr(), wk.data_ptr(), wg.data_ptr(), val.data_ptr(),
        err.data_ptr(), l1.data_ptr(), count.data_ptr(), L, c.shape[0], I, P, c.shape[1], m, W,
        offset, period, stream)
    check_launch(rc, "gk_leaf_dos")
    gk_leaf_dos.launches += 1
    return val, err, l1, count


gk_leaf_dos.launches = 0


def leaf_dos_rule(c, cmap, offset, period, om, eta, xk, wk, wg, leaf):
    """The innermost rule of a nested ``dos_trace`` solve for
    :func:`~autobzcore_torch.ops.adaptive.gk_adaptive_lanes`: ``leaf`` (K4's
    wrapper or its plain version) on every lane, inactive lanes skipped
    inside it, or on the live lanes where the loop has them at hand; the
    children come reduced (:class:`~autobzcore_torch.ops.adaptive.ReducedChildren`)."""
    def rule(ca, cb, active, live):
        if live is None or live.numel() == ca.shape[0]:
            return ReducedChildren(*leaf(c, cmap, offset, period, ca, cb, om, eta, active, xk, wk, wg))
        ones = torch.ones(live.numel(), dtype=torch.bool, device=ca.device)
        out = leaf(c, cmap[live], offset, period, ca[live], cb[live], om[live], eta[live], ones, xk, wk, wg)
        return ReducedChildren(*out, live=live)

    return rule


def gk_leaf_dos_solve_plain(pool, c, cmap, offset, period, om, eta, xk, wk, wg, nbisect, kernels=False):
    """Plain PyTorch version of the fused leaf solve
    (:func:`gk_leaf_dos_solve`): the trip route, the loop of
    ``gk_adaptive_lanes`` on the started ``pool`` in place (its first picks,
    then each trip the plain K4 and pool step, the host's test every trip).
    With ``kernels``, the trips run K4 and K5's step instead, after K5's
    start makes the first picks (what the fused solve is held to on the
    card). Returns each lane's trips (L,) int64."""
    rule = leaf_dos_rule(c, cmap, offset, period, om, eta, xk, wk, wg,
                         gk_leaf_dos if kernels else gk_leaf_dos_plain)
    return refine_lanes(pool, rule, pool_kernels(not kernels), nbisect, count_trips=True)


SOLVE_MAX_SMEM = 227 * 1024 - 8 * 1024  # a block's shared memory on an H100, less the solve's static scratch


def leaf_solve_takes(device, cap, W, nbisect, P, nterms, m):
    """Whether :func:`gk_leaf_dos_solve` takes a leaf of this shape on
    ``device``: any on the CPU; on the card m <= 3, nbisect and P at most
    64, and one lane's pool, rule and coefficients in a block's shared
    memory."""
    if device.type != "cuda":
        return True
    if m > 3 or nbisect > 64 or P > 64:
        return False
    return load_kernels().gk_leaf_dos_solve_smem(cap, W, nbisect, P, nterms, m) <= SOLVE_MAX_SMEM


def gk_leaf_dos_solve(pool, c, cmap, offset, period, om, eta, xk, wk, wg, nbisect):
    """Run every lane of a started leaf-level DOS pool to its end, in
    place: what the trip route (:func:`gk_leaf_dos_solve_plain` with
    ``kernels``) does trip by trip (K4 at the 2 nbisect children, K5's
    step, the host's test), with the same pools, totals,
    counts and ``active``. The pool's values are float64, (L, cap) for one
    frequency per lane (om, eta (L,)) or (L, cap, W) for an omega block (om,
    eta (L, W)); c (Lc, n, m*m) complex128, cmap (L,) int64, xk/wk/wg
    (npts,) the rule. Returns each lane's trips (L,) int64.

    CPU pools take the plain version; CUDA pools launch the fused solve
    (``csrc/gk_leaf_dos.cu``: one block a lane, its pool in shared memory
    for all its trips), which takes m <= 3 and raises on anything else it
    does not take (see :func:`leaf_solve_takes`)."""
    if not pool.checked:  # else K5's start checked it, or made it, for this solve
        _check_pool(pool)
    L, cap = pool.a.shape
    dev = pool.a.device
    if pool.tot_val is None:
        raise ValueError("gk_leaf_dos_solve takes a started pool (its totals computed)")
    block = om.ndim == 2
    W = om.shape[1] if block else 1
    if pool.val.dtype != REAL or pool.val.shape != ((L, cap, W) if block else (L, cap)):
        raise ValueError(f"the pool's values must be float64 {(L, cap, W) if block else (L, cap)}, got "
                         f"{pool.val.dtype} {tuple(pool.val.shape)}")
    check_tensor(c, "c", device=dev, dtype=COMPLEX, ndim=3)
    check_tensor(cmap, "cmap", device=dev, dtype=torch.int64, shape=(L,), ndim=1)
    for name, t in (("om", om), ("eta", eta)):
        check_tensor(t, name, device=dev, dtype=REAL, shape=(L, W) if block else (L,), ndim=om.ndim)
    P = xk.shape[0]
    for name, t in (("xk", xk), ("wk", wk), ("wg", wg)):
        check_tensor(t, name, device=dev, dtype=REAL, shape=(P,), ndim=1)
    m = math.isqrt(c.shape[-1])
    if m * m != c.shape[-1]:
        raise ValueError(f"c must hold square values, got V = {c.shape[-1]}")
    offset, period = int(offset), float(period)
    if dev.type == "cpu":
        return gk_leaf_dos_solve_plain(pool, c, cmap, offset, period, om, eta, xk, wk, wg, nbisect)
    if dev.type != "cuda":
        raise ValueError(f"gk_leaf_dos_solve runs on cpu or cuda tensors, got {dev}")
    if not leaf_solve_takes(dev, cap, W, nbisect, P, c.shape[1], m):
        raise ValueError(f"the fused leaf solve takes m <= 3, nbisect and npts <= 64 and a lane in a block's "
                         f"shared memory: got m = {m}, nbisect {nbisect}, {P} nodes, cap {cap}, W = {W}")
    trips = torch.empty(L, dtype=torch.int64, device=dev)
    if L == 0:
        return trips
    lib = load_kernels()
    rc = lib.gk_leaf_dos_solve_launch(
        pool.a.data_ptr(), pool.b.data_ptr(), pool.err.data_ptr(), pool.l1.data_ptr(), pool.val.data_ptr(),
        pool.n.data_ptr(), pool.evals.data_ptr(), pool.tot_val.data_ptr(), pool.tot_err.data_ptr(),
        pool.tol.data_ptr(), pool.atol.data_ptr(), pool.active.data_ptr(), trips.data_ptr(), c.data_ptr(),
        cmap.data_ptr(), om.data_ptr(), eta.data_ptr(), xk.data_ptr(), wk.data_ptr(), wg.data_ptr(), L,
        c.shape[0], cap, W, nbisect, P, c.shape[1], m, offset, period, float(pool.rtol), float(pool.max_evals),
        stream_handle(dev))
    check_launch(rc, "gk_leaf_dos_solve")
    gk_leaf_dos_solve.launches += 1
    return trips


gk_leaf_dos_solve.launches = 0


NEG_INV_PI = -1.0 / math.pi


def _cmul(a, b):
    return a[0] * b[0] - a[1] * b[1], a[0] * b[1] + a[1] * b[0]


def _cadd(a, b):
    return a[0] + b[0], a[1] + b[1]


def _csub(a, b):
    return a[0] - b[0], a[1] - b[1]


def _cdiv_imag(a, b):
    return (a[1] * b[0] - a[0] * b[1]) / (b[0] * b[0] + b[1] * b[1])


def gm_dos_values_plain(H, om, eta):
    """``dos_trace`` at the rule's nodes: D (B, P) for H (B, P, m, m)
    complex128, m <= 3, and om, eta (B,), or D (B, P, W) for om, eta (B, W).
    The reference's closed forms (``_trace_inv_small``) in the order of the
    kernels' ``csrc/small_trace.cuh``, one rounded real operation at a time
    on (re, im) pairs, so that K15 gives these bits."""
    m = H.shape[-1]
    if om.ndim == 2:
        H = H[:, :, None]
        z = (om[:, None, :], eta[:, None, :])
    else:
        z = (om[:, None], eta[:, None])
    h = [(H[..., i // m, i % m].real, H[..., i // m, i % m].imag) for i in range(m * m)]
    if m == 1:
        tr = _cdiv_imag((1.0, 0.0), _csub(z, h[0]))
    elif m == 2:
        m00, m11 = _csub(z, h[0]), _csub(z, h[3])
        tr = _cdiv_imag(_cadd(m00, m11), _csub(_cmul(m00, m11), _cmul(h[1], h[2])))
    elif m == 3:
        M = [(-a, -b) for a, b in h]
        M[0], M[4], M[8] = _csub(z, h[0]), _csub(z, h[4]), _csub(z, h[8])
        t = _cadd(_cadd(M[0], M[4]), M[8])
        t2 = _cadd(_cadd(_cmul(M[0], M[0]), _cmul(M[4], M[4])), _cmul(M[8], M[8]))
        off = _cadd(_cadd(_cmul(M[1], M[3]), _cmul(M[2], M[6])), _cmul(M[5], M[7]))
        t2 = _cadd(t2, _cadd(off, off))
        c0 = _csub(_cmul(M[4], M[8]), _cmul(M[5], M[7]))
        c1 = _csub(_cmul(M[3], M[8]), _cmul(M[5], M[6]))
        c2 = _csub(_cmul(M[3], M[7]), _cmul(M[4], M[6]))
        det = _cadd(_csub(_cmul(M[0], c0), _cmul(M[1], c1)), _cmul(M[2], c2))
        tr = 0.5 * _cdiv_imag(_csub(_cmul(t, t), t2), det)
    else:
        raise ValueError(f"the closed-form trace takes m <= 3 bands, got m = {m}")
    return NEG_INV_PI * tr


def gm_leaf_dos_plain(H, om, eta, vol, wk, we, diff_idx):
    """Plain PyTorch version of K15: ``dos_trace`` of the series values H (B,
    P, m, m), m <= 3, at the rule's P nodes of each of B boxes, at the box's
    frequency and broadening om, eta (B,), or (B, W) an omega block
    (:func:`gm_dos_values_plain`), then the Genz-Malik rule
    (:func:`~autobzcore_torch.ops.genz_malik.gm_rule_reduce_plain`). Returns
    val7 (B,) or (B, W), err (B,), splitdim (B,) int32."""
    from ..ops.genz_malik import gm_rule_reduce_plain

    return gm_rule_reduce_plain(gm_dos_values_plain(H, om, eta), vol, wk, we, diff_idx)


def gm_leaf_dos(H, om, eta, vol, wk, we, diff_idx):
    """The Genz-Malik rule of ``dos_trace`` on B boxes (see
    :func:`gm_leaf_dos_plain`): H (B, P, m, m) complex128 with m <= 3, om and
    eta (B,) or (B, W) float64, vol (B,), the rule's wk, we (P,) float64 and
    diff_idx (d, 5) int32.

    CPU tensors take the plain version; CUDA tensors launch K15, which takes
    m <= 3 and raises on anything else it does not take."""
    from ..ops.genz_malik import RATIO, _check_rule

    check_tensor(H, "H", dtype=COMPLEX, ndim=4)
    B, P, m = H.shape[0], H.shape[1], H.shape[-1]
    dev = H.device
    check_tensor(H, "H", shape=(B, P, m, m))
    block = om.ndim == 2
    W = om.shape[1] if block else 1
    for name, t in (("om", om), ("eta", eta)):
        check_tensor(t, name, device=dev, dtype=REAL, shape=(B, W) if block else (B,),
                     ndim=2 if block else 1)
    _check_rule(B, P, vol, wk, we, diff_idx, dev)
    if m > 3:
        raise NotImplementedError(f"the box DOS rule takes m <= 3 bands, got m = {m}: larger m "
                                  "goes through K1, dos_trace and K14")
    if dev.type == "cpu":
        return gm_leaf_dos_plain(H, om, eta, vol, wk, we, diff_idx)
    if dev.type != "cuda":
        raise ValueError(f"gm_leaf_dos runs on cpu or cuda tensors, got {dev}")
    if P > 128 or W < 1 or P * W * 8 > 48 * 1024:
        raise ValueError(f"gm_leaf_dos takes at most 128 nodes and P W <= 6144, got P {P}, W {W}")
    val = torch.empty((B, W) if block else (B,), dtype=REAL, device=dev)
    err = torch.empty((B,), dtype=REAL, device=dev)
    sd = torch.empty((B,), dtype=torch.int32, device=dev)
    if B == 0:
        return val, err, sd
    lib = load_kernels()
    stream = stream_handle(dev)
    rc = lib.gm_leaf_dos_launch(
        H.data_ptr(), om.data_ptr(), eta.data_ptr(), vol.data_ptr(), wk.data_ptr(), we.data_ptr(),
        diff_idx.data_ptr(), val.data_ptr(), err.data_ptr(), sd.data_ptr(), B, P, m, W,
        diff_idx.shape[0], RATIO, NEG_INV_PI, stream)
    check_launch(rc, "gm_leaf_dos")
    gm_leaf_dos.launches += 1
    return val, err, sd


gm_leaf_dos.launches = 0


def dos_lanes(params, L, device):
    """(om, eta) of a ``dos_trace`` integrand whose lanes' parameters are
    ``params`` (a :class:`~autobzcore_torch.parameters.LaneParams`): (L,)
    when each lane has one frequency and broadening, (L, W) when each lane
    carries an omega block of W, or None otherwise: the fused leaf does not
    take those, and the nest runs its generic leaf."""
    import inspect

    q = params.merged()
    try:
        bound = inspect.signature(dos_trace).bind(None, *q.args, **q.kwargs)
    except (TypeError, AttributeError):
        return None
    om, eta = bound.arguments["om"], bound.arguments.get("eta")
    if eta is None:
        return None
    om = torch.as_tensor(om, dtype=REAL, device=device)
    eta = torch.as_tensor(eta, dtype=REAL, device=device)
    lane = int(params.x is not None)
    if om.ndim > lane + 1 or eta.ndim > lane + 1:
        return None
    try:
        om, eta = torch.broadcast_tensors(om, eta)
    except RuntimeError:
        return None
    if om.ndim == lane:
        return om.expand(L).contiguous(), eta.expand(L).contiguous()
    W = om.shape[-1]
    return om.expand(L, W).contiguous(), eta.expand(L, W).contiguous()


# --- the transport family (reference observables.py:23-66, 175-393) -------------------------


def reduced_grid(bz, npt, period):
    """Shared symmetry-reduced PTR-grid data of the cached-pack engines
    (reference ``observables.py:23``): ``(lin, weights, u, scale, Savg)``,
    the C-order indices of the representatives in the full grid (None on
    the full zone), their orbit multiplicities (sum npt^d, numpy), the
    per-dimension nodes ``arange(npt) / npt * period`` (numpy), the
    ``|det B| / npt^d`` normalization and the rank-2 group average
    ``(S^-T stack, S^-1 stack, |G|)`` (None on the full zone)."""
    from ..ops.symptr import symptr_rule

    d = bz.ndim
    if bz.syms is None:
        lin = None
        weights = np.ones(npt**d)
        Savg = None
    else:
        reps, weights = symptr_rule(npt, d, bz.syms)
        lin = np.ravel_multi_index(tuple(reps.T.astype(np.int64)), (npt,) * d)
        Sinv = np.linalg.inv(np.asarray(bz.syms, dtype=np.float64))
        Savg = (Sinv.swapaxes(1, 2), Sinv, len(Sinv))
    u = [np.arange(npt) / npt * period[j] for j in range(d)]
    scale = abs(np.linalg.det(bz.B)) / (npt**d)
    return lin, weights, u, scale, Savg


def grid_points(d, u, lin, device):
    """The points (K, d) float64 of the grid ``u[0] x ... x u[d-1]`` in C
    order, or its points at the C-order indices ``lin`` (the representatives):
    the nodes the reference's grid evaluation gathers, taken directly."""
    npts = tuple(len(uj) for uj in u)
    idx = np.unravel_index(np.arange(int(np.prod(npts))) if lin is None else np.asarray(lin), npts)
    X = np.stack([np.asarray(u[j], dtype=np.float64)[idx[j]] for j in range(d)], axis=-1)
    return torch.as_tensor(X.reshape(-1, d), device=device).contiguous()


def gathered_grid(h, d, u, lin, jacobian=False):
    """H (and with ``jacobian`` dH/dz_j) at the grid's points, or at its
    representatives ``lin`` (reference ``observables.py:49``): K1
    (``fourier_points``) or K11 (``fourier_points_derivs``) at the points
    themselves, not a whole-grid evaluation and a gather. Returns ``hk (K,
    *valshape)`` or ``(hk, vk (K, d, *valshape))`` on the series' device."""
    X = grid_points(d, u, lin, h.device)
    if not jacobian:
        return fourier_points(h.c, X, h.offset, h.period)
    J = fourier_points_derivs(h.c, X, h.offset, h.period, jacobian_orders(d))
    return J[:, 0], J[:, 1:]


def transport_distribution(hv, om, eta=None):
    """Kubo-Greenwood transport distribution ``Gamma_ab(om) = Re sum_nm
    (v_a)_nm conj((v_b)_nm) A_n A_m`` at one k-point of a JacobianSeries
    value ``(H, dH)``, in the band basis of ``eigh(H)``; returns (d, d)
    (reference ``observables.py:175``, the per-point PTR integrand)."""
    h, v = hv.s
    e, U = torch.linalg.eigh(h)
    vband = torch.einsum("im,dij,jn->dmn", U.conj(), v, U)
    a = eta / ((om - e) ** 2 + eta**2) / math.pi
    return torch.einsum("anm,bnm,n,m->ab", vband, vband.conj(), a.to(vband.dtype),
                        a.to(vband.dtype)).real


def transport_points_plain(e, U, dH, om, eta, chunk=4096):
    """Plain PyTorch version of K31, the reference's operations after
    ``eigh`` (``observables.py:184-188``) over a batch of points, ``chunk``
    at a time: ``vband = U^H dH_a U`` by one einsum, the spectral weights
    ``A = eta / ((om - e)^2 + eta^2) / pi`` and ``Re sum_nm (v_a)_nm
    conj((v_b)_nm) A_n A_m`` by another. Returns (N, d, d) float64."""
    out = []
    for s in range(0, e.shape[0], chunk):
        sl = slice(s, s + chunk)
        vband = torch.einsum("kim,kdij,kjn->kdmn", U[sl].conj(), dH[sl], U[sl])
        g = eta[sl, None]
        a = (g / ((om[sl, None] - e[sl]) ** 2 + g**2) / math.pi).to(vband.dtype)
        out.append(torch.einsum("kanm,kbnm,kn,km->kab", vband, vband.conj(), a, a).real)
    if not out:
        return torch.empty((0, dH.shape[1], dH.shape[1]), dtype=REAL, device=e.device)
    return torch.cat(out)


def transport_points(e, U, dH, om, eta):
    """``G[p, a, b] = Re sum_nm (v_a)_nm conj((v_b)_nm) A_n A_m`` at N points
    (the reference's ``transport_distribution`` at each), with ``v_a = U^H
    dH_a U`` and ``A_n = eta / ((om - e_n)^2 + eta^2) / pi``, for eigenpairs
    e (N, m) float64 and U (N, m, m) complex128 (columns) of H, gradients dH
    (N, d, m, m) complex128 whose (m, m) blocks are contiguous, and om, eta
    (N,) float64. Returns (N, d, d) float64.

    CPU tensors take the plain version; CUDA tensors launch K31
    (``csrc/transport_points.cu``), which takes m <= 8 and d <= 3, and
    anything the kernel does not take raises."""
    check_tensor(e, "e", dtype=REAL, ndim=2)
    N, m = e.shape
    dev = e.device
    check_tensor(U, "U", device=dev, dtype=COMPLEX, ndim=3, shape=(N, m, m))
    if not isinstance(dH, torch.Tensor) or dH.ndim != 4 or dH.shape[0] != N or tuple(dH.shape[2:]) != (m, m) \
            or dH.dtype != COMPLEX or dH.device != dev:
        raise ValueError(f"dH must be a complex128 (N, d, m, m) = ({N}, d, {m}, {m}) tensor on e's device, got "
                         f"{tuple(getattr(dH, 'shape', ()))}")
    d = dH.shape[1]
    for name, t in (("om", om), ("eta", eta)):
        check_tensor(t, name, device=dev, dtype=REAL, ndim=1, shape=(N,))
    if dev.type == "cpu":
        return transport_points_plain(e, U, dH, om, eta)
    if dev.type != "cuda":
        raise ValueError(f"transport_points runs on cpu or cuda tensors, got {dev}")
    if dH.stride(3) != 1 or dH.stride(2) != m:
        raise ValueError("transport_points needs dH's (m, m) blocks contiguous")
    lib = load_kernels()
    if m > lib.transport_points_max_bands() or d > 3:
        raise ValueError(f"K31 takes m <= {lib.transport_points_max_bands()} and d <= 3, got m = {m}, d = {d}")
    out = torch.empty((N, d, d), dtype=REAL, device=dev)
    if N == 0:
        return out
    stream = stream_handle(dev)
    check_launch(lib.transport_points_launch(e.data_ptr(), U.data_ptr(), dH.data_ptr(), om.data_ptr(),
                                             eta.data_ptr(), out.data_ptr(), N, m, d, dH.stride(0), dH.stride(1),
                                             1.0 / math.pi, stream), "transport_points")
    transport_points.launches += 1
    return out


transport_points.launches = 0


_INV_PI = 1.0 / math.pi


def _point_values(x, name, n, dev):
    """``(tensor or None, stride, value)`` of ``om`` or ``eta`` for K31's
    fused entry: one value on the host as the value; one on the card, or n
    (on the card, copied there if they are not), as a pointer with stride 0
    or the values' own stride; nothing broadcast."""
    if isinstance(x, (int, float)):
        return None, 0, float(x)
    x = torch.as_tensor(x, dtype=REAL)
    if x.numel() == 1 and not x.is_cuda:
        return None, 0, float(x)
    x = x.to(dev)
    if x.numel() == 1:
        return x, 0, 0.0
    if x.numel() != n:
        raise ValueError(f"{name} must hold one value or one a point ({n}), got shape {tuple(x.shape)}")
    x = x.reshape(n)
    return x, x.stride(0), 0.0


def _lane_values(x, n, dev):
    """``om`` or ``eta`` as (n,) float64 on ``dev`` for the plain version."""
    return torch.broadcast_to(torch.as_tensor(x, dtype=REAL, device=dev).reshape(-1), (n,))


def transport_points_eigh_plain(H, dH, om, eta):
    """Plain version of K31's fused entry: ``eigh`` of H (N, m, m) (in the
    chunks the card's solver takes), then :func:`transport_points_plain`;
    ``om`` and ``eta`` one value or one a point. Returns (N, d, d)."""
    from ..ops.eigh3 import eigh_chunked

    e, U = eigh_chunked(H)
    n = e.shape[0]
    return transport_points_plain(e, U, dH, _lane_values(om, n, H.device), _lane_values(eta, n, H.device))


def transport_points_eigh(H, dH, om, eta):
    """The transport distribution at N points from H (N, m, m) and dH (N, d,
    m, m), complex128, m <= 3, d <= 3, each (m, m) block's entries
    contiguous (views of K11's output, taken with their strides), and ``om``,
    ``eta`` each a number or a float64 tensor of one value or one a point:
    ``G[p, a, b] = Re sum_nq (v_a)_nq conj((v_b)_nq) A_n A_q`` with the
    eigenpairs (e, U) of H's Hermitian part, ``v_a = U^H S_a U`` for the
    Hermitian part S_a of dH_a and ``A_n = eta / ((om - e_n)^2 + eta^2) /
    pi``. Returns (N, d, d) float64.

    CPU tensors take the plain version (``eigh`` then the reference's
    einsums); CUDA tensors launch K31's fused entry (``csrc/transport_points.cu``),
    whose eigensolve runs in registers (``ops.eigh3.eigh3_jacobi`` is its
    mirror), allocating only the output; anything it does not take raises,
    m > 3 with the route that takes it. An adaptive trip calls it once, so
    the checks read each shape and stride tuple once."""
    try:
        N, m, m2 = H.shape
        N2, d, m3, m4 = dH.shape
        dev = H.device
        ok = H.dtype == COMPLEX and dH.dtype == COMPLEX and dH.device == dev
    except (AttributeError, ValueError):
        ok = False
    if not ok or not (m2 == m3 == m4 == m and N2 == N and 1 <= d <= 3):
        raise ValueError(f"transport_points_eigh takes complex128 H (N, m, m) and dH (N, d <= 3, m, m) on one device, "
                         f"got {tuple(getattr(H, 'shape', ()))} and {tuple(getattr(dH, 'shape', ()))}")
    if not 1 <= m <= 3:
        raise ValueError(f"transport_points_eigh takes m <= 3 bands, got {m}; above three bands "
                         "transport_distribution_points takes eigh_chunked, then transport_points")
    if not H.is_cuda:
        if dev.type == "cpu":
            return transport_points_eigh_plain(H, dH, om, eta)
        raise ValueError(f"transport_points_eigh runs on cpu or cuda tensors, got {dev}")
    sh, s1, s2 = H.stride()
    sk, sj, s3, s4 = dH.stride()
    if s2 != 1 or s1 != m or s4 != 1 or s3 != m:
        raise ValueError("transport_points_eigh needs the (m, m) blocks of H and dH contiguous")
    wt, ws, w0 = _point_values(om, "om", N, dev)
    gt, gs, g0 = _point_values(eta, "eta", N, dev)
    out = torch.empty((N, d, d), dtype=REAL, device=dev)
    if N:
        check_launch(load_kernels().transport_points_eigh_launch(
            H.data_ptr(), sh, dH.data_ptr(), sk, sj, None if wt is None else wt.data_ptr(), ws, w0,
            None if gt is None else gt.data_ptr(), gs, g0, out.data_ptr(), N, m, d, _INV_PI, stream_handle(dev)),
            "transport_points_eigh")
        transport_points_eigh.launches += 1
    return out


transport_points_eigh.launches = 0


def transport_distribution_points(hv, om, eta=None):
    """:func:`transport_distribution` over a batch of points: ``hv.s`` is
    the pair (H (..., m, m), dH (..., d, m, m)) and ``om``, ``eta`` are one
    value or one per point. On the card at m <= 3 one launch of K31's fused
    entry (:func:`transport_points_eigh`: the eigensolve in registers);
    otherwise ``eigh`` (in the chunks the card's solver takes, the
    reference's own ``jnp.linalg.eigh``), then :func:`transport_points` (K31
    on the card). Returns (..., d, d) float64."""
    H, V = hv.s
    m, d = H.shape[-1], V.shape[-3]
    if m <= 3 and H.is_cuda:
        batch = tuple(H.shape[:-2])
        n = math.prod(batch)
        if H.ndim != 3:  # an adaptive trip hands over (n, m, m)
            H, V = H.reshape(n, m, m), V.reshape(n, d, m, m)

        def per_point(x):
            # to the batch's shape, as the CPU route takes it (the same inputs raise on both); a
            # view: one value goes on as it is, n values with their strides
            if isinstance(x, (int, float)):
                return x
            x = torch.as_tensor(x, dtype=REAL)
            xb = torch.broadcast_to(x, batch).reshape(n)
            return x if x.numel() == 1 else xb

        G = transport_points_eigh(H, V, per_point(om), per_point(eta))
        return G.reshape(batch + (d, d))
    from ..ops.eigh3 import eigh_chunked

    batch = tuple(H.shape[:-2])
    e, U = eigh_chunked(H.reshape(-1, m, m))
    n = e.shape[0]

    def lane(x):
        return torch.broadcast_to(torch.as_tensor(x, dtype=REAL, device=H.device), batch).reshape(n).contiguous()

    G = transport_points(e, U.contiguous(), V.reshape(n, d, m, m), lane(om), lane(eta))
    return G.reshape(batch + (d, d))


def transport_integrand(h: FourierSeries, eta):
    """FourierIntegrand of the Kubo-Greenwood transport distribution over
    ``JacobianSeries(h)``, declaring :class:`LatticeRep` so that IBZ solves
    symmetrize the rank-2 tensor (reference ``observables.py:199``). It
    takes whole batches of points (``batched=True``): a PTR rule sums it by
    its velocity pack and one K19 launch a solve (its lanes' frequencies at
    once); an IAI leaf trip or a TAI trip is one K31 call with one frequency
    or one per point: on the card at m <= 3 one launch of its fused entry
    :func:`transport_points_eigh`, otherwise ``eigh`` then
    :func:`transport_points`."""
    fi = FourierIntegrand(transport_distribution_points, JacobianSeries(h), eta=eta, batched=True)
    fi.rep = LatticeRep()
    return fi


def transport_sweep(h: FourierSeries, bz, npt, omegas, eta):
    """``Gamma_ab(omega)`` over a frequency grid: one-shot
    :class:`TransportSolver`; returns (W, d, d) numpy."""
    return TransportSolver(h, bz, npt, eta)(omegas)


class CertifiedSweep(NamedTuple):
    """A Richardson-certified grid sweep: values, the final sup-norm rung
    delta, the convergence flag and the npt ladder that ran."""

    u: object
    resid: float
    retcode: bool
    npts: tuple


def certified_ladder(eval_at_npt, abstol=1e-3, reltol=0.0, nmin=20, nmax=400, factor=2**0.5,
                     npt_multiple=1):
    """Call ``eval_at_npt(npt)`` on the rate-fitted npt ladder of
    ``dos.fullgrid.next_rung_npt`` until the sup-norm change of the whole
    result between consecutive rungs meets the weaker of ``abstol`` and
    ``reltol`` (reference ``observables.py:233``, host code). Every rung is
    rounded up to a multiple of ``npt_multiple``."""
    from ..dos.fullgrid import next_rung_npt

    mult = max(1, int(npt_multiple))

    def up(x):
        return -(-int(x) // mult) * mult

    npts = [up(nmin)]
    deltas = []
    G_prev = None
    while True:
        G = np.asarray(eval_at_npt(npts[-1]))
        if G_prev is not None:
            delta = float(np.max(np.abs(G - G_prev)))
            tol = max(float(abstol), float(reltol) * float(np.max(np.abs(G))))
            deltas.append(delta)
            if delta <= tol:
                return CertifiedSweep(G, delta, True, tuple(npts))
            if npts[-1] >= nmax:
                return CertifiedSweep(G, delta, False, tuple(npts))
        G_prev = G
        nxt = up(next_rung_npt(npts, deltas, max(float(abstol), 1e-300), float(factor), int(nmax)))
        if nxt <= npts[-1]:
            # the smallest legal step; may pass nmax by less than mult, and
            # the next delta check then reports the retcode honestly
            nxt = npts[-1] + mult if mult > 1 else min(int(nmax), npts[-1] + 1)
        npts.append(int(nxt))


def certified_transport_sweep(h: FourierSeries, bz, omegas, eta, abstol=1e-3, reltol=0.0, nmin=20,
                              nmax=400, factor=2**0.5):
    """Kubo-Greenwood sweep certified over the whole ``Gamma_ab(omega)``
    curve by :func:`certified_ladder`, a fresh :class:`TransportSolver` per
    rung (reference ``observables.py:272``)."""
    return certified_ladder(lambda npt: TransportSolver(h, bz, npt, eta)(omegas), abstol, reltol,
                            nmin, nmax, factor)


class SpectralPack(NamedTuple):
    """The weight-packed (H, dH) spectral grid shared by
    :class:`TransportSolver` and the kinetic-coefficient solvers
    (``models/transport.py``), built once per (h, bz, npt):

    ``Gamma_ab(w1, w2) = scale * sum_knm A1[k, n] A2[k, m] Wmat[(k, n, m),
    (a, b)]`` with the band-basis spectral functions A; ``Savg`` averages an
    IBZ rank-2 tensor over the group; ``weights`` are the orbit
    multiplicities (numpy, sum npt^ndim). ``e`` and ``Wmat`` are float64 on
    the series' device."""

    e: object        # (K, m) band energies on the reduced grid
    Wmat: object     # (K m^2, d^2) weight-absorbed velocity pairs
    scale: object    # |det B| / npt^ndim
    Savg: object     # (S^-T stack, S^-1 stack, |G|) or None (full zone)
    weights: object  # (K,) orbit multiplicities
    ndim: int
    npt: int


def velocity_pairs_plain(U, dH, w, out=None):
    """Plain PyTorch version of K18, the reference's operations
    (``observables.py:326-339``): the band-basis velocities ``U^H dH_a U``,
    the real pair products ``P[k, a, b, n, m] = Re[(v_a)_nm (v_b)_mn]``
    and ``Wmat = (w P)`` transposed to ((k, n, m), (a, b)); written into
    ``out`` where given."""
    K, d, m = dH.shape[0], dH.shape[1], U.shape[-1]
    vband = torch.einsum("kmi,kdij,kjn->kdmn", U.conj().transpose(1, 2), dH, U)
    P = torch.einsum("kanm,kbmn->kabnm", vband, vband).real
    res = (w[:, None, None, None, None] * P).permute(0, 3, 4, 1, 2).reshape(K * m * m, d * d)
    if out is None:
        return res
    return out.copy_(res)


def velocity_pairs(U, dH, w, out=None):
    """The transport GEMM operand ``Wmat[(k, n, q), (a, b)] = w_k Re[(U^H
    dH_a U)_nq (U^H dH_b U)_qn]`` for eigenvectors U (K, m, m) complex128
    (columns), gradients dH (K, d, m, m) complex128 whose (m, m) blocks are
    contiguous and weights w (K,) float64. Returns (K m^2, d^2) float64,
    written into ``out`` (contiguous) where given.

    CPU tensors take the plain version; CUDA tensors launch K18
    (``csrc/velocity_pairs.cu``), and anything the kernel does not take
    raises."""
    check_tensor(U, "U", dtype=COMPLEX, ndim=3)
    K, m, m2 = U.shape
    if m2 != m or not isinstance(dH, torch.Tensor) or dH.ndim != 4 or dH.shape[0] != K \
            or tuple(dH.shape[2:]) != (m, m):
        raise ValueError(f"velocity_pairs takes U (K, m, m) and dH (K, d, m, m), got {tuple(U.shape)} and "
                         f"{tuple(getattr(dH, 'shape', ()))}")
    if dH.dtype != COMPLEX or dH.device != U.device:
        raise ValueError("dH must be a complex128 tensor on U's device")
    check_tensor(w, "w", device=U.device, dtype=REAL, ndim=1, shape=(K,))
    d = dH.shape[1]
    if out is not None:
        check_tensor(out, "out", device=U.device, dtype=REAL, ndim=2, shape=(K * m * m, d * d))
    if U.device.type == "cpu":
        return velocity_pairs_plain(U, dH, w, out=out)
    if U.device.type != "cuda":
        raise ValueError(f"velocity_pairs runs on cpu or cuda tensors, got {U.device}")
    if dH.stride(3) != 1 or dH.stride(2) != m:
        raise ValueError("velocity_pairs needs dH's (m, m) blocks contiguous")
    lib = load_kernels()
    if m > lib.velocity_pairs_max_bands(d):
        raise ValueError(f"K18 takes at most {lib.velocity_pairs_max_bands(d)} bands at d = {d}, got {m}")
    if out is None:
        out = torch.empty((K * m * m, d * d), dtype=REAL, device=U.device)
    if K == 0:
        return out
    stream = stream_handle(U.device)
    err = lib.velocity_pairs_launch(U.data_ptr(), dH.data_ptr(), w.data_ptr(), out.data_ptr(), K, d, m,
                                    dH.stride(0), dH.stride(1), stream)
    check_launch(err, "velocity_pairs")
    velocity_pairs.launches += 1
    return out


velocity_pairs.launches = 0


def series_bands(h):
    """The band count m of a series of (m, m) values (1 for a scalar one)."""
    vs = h.valshape
    if len(vs) == 0:
        return 1
    if len(vs) != 2 or vs[0] != vs[1]:
        raise ValueError(f"the transport family takes scalar or square-matrix series, got {vs}")
    return vs[0]


def velocity_pack(h: FourierSeries, X, w, points=fourier_points_derivs, pairs=velocity_pairs):
    """``(e (K, m), Wmat (K m^2, d^2))`` float64 of the series at the points
    X (K, d) with weights w (K,): in chunks of ``ops.eigh3.EIGH_CHUNK``
    points, K11 (``points``), ``torch.linalg.eigh``, then K18 (``pairs``)
    into the chunk's rows of Wmat. The plain versions of K11 and K18 may be
    passed in their place."""
    from ..dos.ggr import eigen_chunks

    d, dev = X.shape[1], h.device
    m = series_bands(h)
    K = X.shape[0]
    e = torch.empty((K, m), dtype=REAL, device=dev)
    Wmat = torch.empty((K * m * m, d * d), dtype=REAL, device=dev)
    for s, es, U, dH in eigen_chunks(h, X, points):
        n = es.shape[0]
        e[s:s + n] = es
        pairs(U, dH, w[s:s + n], out=Wmat[s * m * m:(s + n) * m * m])
    return e, Wmat


def spectral_velocity_pack(h: FourierSeries, bz, npt, points=fourier_points_derivs,
                           pairs=velocity_pairs) -> SpectralPack:
    """Evaluate (H, dH) on the (symmetry-reduced) npt^d grid, eigendecompose
    and pack the weighted band-pair velocity products (reference
    ``observables.py:309``): :func:`velocity_pack` at the points ``reps/npt
    * period`` with the orbit weights."""
    d, dev = bz.ndim, h.device
    lin, weights, u, scale, Savg = reduced_grid(bz, npt, h.period)
    X = grid_points(d, u, lin, dev)
    w = torch.as_tensor(np.asarray(weights), dtype=REAL, device=dev)
    e, Wmat = velocity_pack(h, X, w, points, pairs)
    return SpectralPack(e, Wmat, scale, Savg, weights, d, npt)


def spectral_weights(y, g, e):
    """The band spectral functions ``A[b, k, n] = g_b / ((y_b - e[k, n])^2 +
    g_b^2) / pi`` (B, K, m) of nodes with shifted frequency y and width g
    (B,): the reference's ``eta / ((w - e)^2 + eta^2) / pi`` (y = w, g =
    eta) and its self-energy form (y = w - Re Sigma, g = -Im Sigma)."""
    yb, gb = y[:, None, None], g[:, None, None]
    return gb / ((yb - e) ** 2 + gb**2) / math.pi


def transport_gamma_plain(e, Wmat, y1, g1, y2, g2, scale, chunk=64):
    """Plain PyTorch version of K19, the reference's operations in chunks of
    ``chunk`` node pairs (its TransportSolver chunks frequencies by 64):
    ``scale * (Pairs @ Wmat)`` with ``Pairs = (A1[..., :, None] A2[...,
    None, :])`` flattened to (C, K m^2); A2 is A1 when ``y2 is y1`` and
    ``g2 is g1``. Returns (B, d^2)."""
    K, m = e.shape
    same = y2 is y1 and g2 is g1
    out = []
    for s in range(0, y1.shape[0], chunk):
        A1 = spectral_weights(y1[s:s + chunk], g1[s:s + chunk], e)
        A2 = A1 if same else spectral_weights(y2[s:s + chunk], g2[s:s + chunk], e)
        pairs = (A1[..., :, None] * A2[..., None, :]).reshape(A1.shape[0], K * m * m)
        out.append(scale * (pairs @ Wmat))
    if not out:
        return torch.empty((0, Wmat.shape[1]), dtype=REAL, device=e.device)
    return torch.cat(out)


def transport_gamma(e, Wmat, y1, g1, y2, g2, scale):
    """``G[b] = scale * sum_k sum_nq A(y1_b - e[k, n]; g1_b) A(y2_b - e[k,
    q]; g2_b) Wmat[(k, n, q)]`` for B node pairs, A(x; g) = g / (x^2 + g^2)
    / pi: the transport distribution Gamma(w1, w2) of a pack (e (K, m),
    Wmat (K m^2, d^2)), with y = w - Re Sigma(w) and g = -Im Sigma(w) (0 and
    eta without a self-energy), all float64. Returns (B, d^2) float64.

    Equal frequencies are asked for by identity: when ``y2 is y1`` and ``g2
    is g1`` (the same tensor objects, as TransportSolver passes them) each
    Lorentzian is computed once, not twice. Equal values in other tensors
    give the same result, bit for bit, at twice the Lorentzians' cost.

    CPU tensors take the plain version; CUDA tensors launch K19
    (``csrc/transport_gamma.cu``), and anything the kernel does not take
    raises."""
    check_tensor(e, "e", dtype=REAL, ndim=2)
    K, m = e.shape
    check_tensor(Wmat, "Wmat", device=e.device, dtype=REAL, ndim=2)
    if Wmat.shape[0] != K * m * m or Wmat.shape[1] not in (1, 4, 9):
        raise ValueError(f"Wmat must be (K m^2, d^2) = ({K * m * m}, d^2) for d <= 3, got {tuple(Wmat.shape)}")
    check_tensor(y1, "y1", device=e.device, dtype=REAL, ndim=1)
    B = y1.shape[0]
    for name, t in (("g1", g1), ("y2", y2), ("g2", g2)):
        check_tensor(t, name, device=e.device, dtype=REAL, ndim=1, shape=(B,))
    if e.device.type == "cpu":
        return transport_gamma_plain(e, Wmat, y1, g1, y2, g2, float(scale))
    if e.device.type != "cuda":
        raise ValueError(f"transport_gamma runs on cpu or cuda tensors, got {e.device}")
    lib = load_kernels()
    if m > lib.transport_gamma_max_bands():
        raise ValueError(f"K19 takes at most {lib.transport_gamma_max_bands()} bands, got {m}")
    dd = Wmat.shape[1]
    out = torch.empty((B, dd), dtype=REAL, device=e.device)
    if B == 0:
        return out
    partials = torch.empty((max(lib.transport_gamma_num_chunks(K), 1), B, dd), dtype=REAL, device=e.device)
    stream = stream_handle(e.device)
    same = y2 is y1 and g2 is g1
    err = lib.transport_gamma_launch(e.data_ptr(), Wmat.data_ptr(), K, m, {1: 1, 4: 2, 9: 3}[dd],
                                     y1.data_ptr(), g1.data_ptr(), y2.data_ptr(), g2.data_ptr(), B,
                                     int(same), float(scale), partials.data_ptr(), out.data_ptr(), stream)
    check_launch(err, "transport_gamma")
    transport_gamma.launches += 1
    return out


transport_gamma.launches = 0


def group_average(G, Savg):
    """``sum_S S^-T G S^-1 / |G|`` of (..., d, d) tensors (the identity on
    the full zone, ``Savg`` None)."""
    if Savg is None:
        return G
    SinvT, Sinv, n = Savg
    return torch.einsum("sab,...bc,scd->...ad", torch.as_tensor(SinvT, dtype=G.dtype, device=G.device), G,
                        torch.as_tensor(Sinv, dtype=G.dtype, device=G.device)) / n


class TransportSolver:
    """Reusable Kubo-Greenwood transport sweep (reference
    ``observables.py:345``): the pack builds once at construction (or is
    shared through ``pack=``), and each call is one K19 launch at equal
    frequencies over all omegas. Returns (W, d, d) float64 numpy.

    ``Gamma_ab(w) = sum_k w_k sum_nm Re[(v_a)_nm (v_b)_mn] A_n(w) A_m(w)``,
    A_n = eta / ((w - e_n)^2 + eta^2) / pi, v the band-basis velocities."""

    def __init__(self, h: FourierSeries, bz, npt, eta, pack=None):
        if pack is None:
            pack = spectral_velocity_pack(h, bz, npt)
        self.pack = pack
        self._data = _transport_build(pack, eta)

    def __call__(self, omegas):
        return self._data(omegas)


def _transport_build(pack: SpectralPack, eta):
    e, Wmat, scale, Savg, d = pack.e, pack.Wmat, pack.scale, pack.Savg, pack.ndim

    def sweep(omegas):
        om = torch.as_tensor(np.atleast_1d(np.asarray(omegas, dtype=np.float64)), device=e.device)
        g = torch.full_like(om, float(eta))
        G = transport_gamma(e, Wmat, om, g, om, g, scale).reshape(-1, d, d)
        return group_average(G, Savg).cpu().numpy()

    return sweep


# --- the PTR rule's kernel sums (algorithms.ptr.register_kernel_sum) -------------------------


def _lanes(fn, p, device):
    """(omega, eta, shape): the frequencies and broadenings of a call of
    ``fn(hv, om, eta)`` with parameters ``p``, broadcast together and
    flattened into lanes, with the broadcast shape to restore."""
    bound = inspect.signature(fn).bind(None, *p.args, **p.kwargs)
    om, eta = bound.arguments["om"], bound.arguments.get("eta")
    if eta is None:
        raise TypeError(f"{fn.__name__} needs eta")
    om = torch.as_tensor(om, dtype=REAL, device=device)
    eta = torch.as_tensor(eta, dtype=REAL, device=device)
    om, eta = torch.broadcast_tensors(om, eta)
    return om.reshape(-1).contiguous(), eta.reshape(-1).contiguous(), om.shape


def _grid_values(f, frac, weights, npt):
    H = f.series_values_on_grid(npt, frac)
    m = H.shape[-1]
    return (weights, H.reshape(-1, m, m))


def _dos_sum(f, frac, weights, npt, scale):
    """``dos_trace`` under a PTR rule: the series at the rule points (K1),
    then K2 over the lanes' frequencies a solve."""
    def run_c(consts, p):
        w, H = consts
        om, eta, shape = _lanes(dos_trace, p, H.device)
        return dos_trace_weighted_sum(H, w, om, eta, scale).reshape(shape)

    return _grid_values(f, frac, weights, npt), run_c


def _spectral_sum(f, frac, weights, npt, scale):
    """``spectral_function`` under a PTR rule: the series at the rule points
    (K1), then K27's matrix mode at the lanes' ``z = om + i eta`` a
    solve."""
    def run_c(consts, p):
        w, H = consts
        m = H.shape[-1]
        om, eta, shape = _lanes(spectral_function, p, H.device)
        return spectral_weighted_sum(H, w, torch.complex(om, eta), scale).reshape(tuple(shape) + (m, m))

    return _grid_values(f, frac, weights, npt), run_c


def _transport_sum(f, frac, weights, npt, scale):
    """The batched transport integrand under a PTR rule: the rule's velocity
    pack once (K11, ``eigh``, K18 with the rule's weights), then one K19
    launch at equal frequencies over the lanes a solve."""
    base = f.s.s
    d = frac.shape[1]
    period = torch.as_tensor(base.period, dtype=REAL, device=frac.device)

    def run_c(consts, p):
        e, Wmat = consts
        om, eta, shape = _lanes(transport_distribution_points, p, e.device)
        return transport_gamma(e, Wmat, om, eta, om, eta, scale).reshape(tuple(shape) + (d, d))

    return velocity_pack(base, (frac * period).contiguous(), weights), run_c


register_kernel_sum(dos_trace, FourierSeries, _dos_sum)
register_kernel_sum(spectral_function, FourierSeries, _spectral_sum)
register_kernel_sum(transport_distribution_points, JacobianSeries, _transport_sum)
