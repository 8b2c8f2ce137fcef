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

``dos_eig`` sums over every axis, the omega block's too, so it cannot run
blocked (the reference's example of a reducing integrand).
"""
from __future__ import annotations

import math

import torch

from .._device import COMPLEX, REAL, check_tensor
from ..brillouin import TrivialRep
from ..fourier import FourierIntegrand, FourierSeries, FourierValue
from ..ops.adaptive import gk_nodes, gk_rule_reduce_plain
from ..ops.cuda_lib import check_launch, load_kernels
from ..ops.fourier_eval import fourier_contract_plain


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


def dos_eig(hv, om, eta=None):
    """DOS via eigenvalues, summed over every axis:
    ``sum eta / ((om - e)^2 + eta^2) / pi``."""
    e = torch.linalg.eigvalsh(hv.s)
    return torch.sum(eta / ((om - e) ** 2 + eta**2)) / math.pi


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
    partials = torch.empty((max(lib.dos_trace_num_chunks(K), 1), W), dtype=REAL, device=H.device)
    out = torch.empty(W, dtype=REAL, device=H.device)
    stream = torch.cuda.current_stream(H.device).cuda_stream
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
            f"the CUDA leaf DOS kernel takes m <= 3 bands, got m = {m} "
            "(the eigenvalue form for larger m comes with ROADMAP B2)")
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
    stream = torch.cuda.current_stream(dev).cuda_stream
    rc = lib.gk_leaf_dos_launch(
        c.data_ptr(), cmap.data_ptr(), ca.data_ptr(), cb.data_ptr(), om.data_ptr(), eta.data_ptr(),
        active.data_ptr(), xk.data_ptr(), wk.data_ptr(), wg.data_ptr(), val.data_ptr(),
        err.data_ptr(), l1.data_ptr(), count.data_ptr(), L, c.shape[0], I, P, c.shape[1], m, W,
        offset, period, stream)
    check_launch(rc, "gk_leaf_dos")
    gk_leaf_dos.launches += 1
    return val, err, l1, count


gk_leaf_dos.launches = 0


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
