"""Spectral observables as integrand kernels (reference
``autobzcore_tpu/models/observables.py``, kernel family B3).

``dos_trace`` and ``greens_function_trace`` are plain PyTorch and broadcast
over frequency blocks exactly as the reference does: ``om`` may carry
leading axes, which become new leading axes of the result.

``dos_trace_weighted_sum`` is the wrapper of kernel K2
(``csrc/dos_trace.cu``): the PTR rule's weighted k-sum of ``dos_trace``,
fused so that the (W, K) matrix of traces never exists.
"""
from __future__ import annotations

import math

import torch

from .._device import COMPLEX, REAL, check_tensor
from ..brillouin import TrivialRep
from ..fourier import FourierIntegrand, FourierSeries, FourierValue
from ..ops.cuda_lib import check_launch, load_kernels


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

    CPU tensors take the plain version; CUDA tensors launch K2, which takes
    m <= 3 (larger m needs the eigenvalue form, ROADMAP B2) and raises on
    anything else it does not take."""
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
        raise NotImplementedError(
            f"the CUDA DOS-trace kernel takes m <= 3 bands, got m = {m} "
            "(the eigenvalue form for larger m comes with ROADMAP B2)")
    lib = load_kernels()
    nchunks = lib.dos_trace_num_chunks(K)
    if nchunks > 65535:
        raise ValueError(f"dos_trace_weighted_sum takes at most {65535 * 4096} k-points, got {K}")
    partials = torch.empty((max(nchunks, 1), W), dtype=REAL, device=H.device)
    out = torch.empty(W, dtype=REAL, device=H.device)
    stream = torch.cuda.current_stream(H.device).cuda_stream
    err = lib.dos_trace_weighted_sum_launch(
        H.data_ptr(), w.data_ptr(), omega.data_ptr(), eta.data_ptr(), partials.data_ptr(),
        out.data_ptr(), K, W, m, -float(scale) / math.pi, stream)
    check_launch(err, "dos_trace_weighted_sum")
    dos_trace_weighted_sum.launches += 1
    return out


dos_trace_weighted_sum.launches = 0
