"""Matrix-valued local self-energies: DMFT-grade Green's functions
(reference ``autobzcore_tpu/models/selfenergy.py``, kernel family B14).

    G(k, omega) = [ (omega + mu) I - Sigma(omega) - H(k) ]^{-1}

with ``Sigma(omega)`` an orbital-resolved matrix (or scalar) self-energy,
given as a callable (:class:`SigmaCallable`, taking and returning torch
tensors) or as data on a frequency grid (:class:`SigmaInterpolant`, held
as tensors on a device). Sigma is evaluated in plain torch, once per
frequency or node, into the matrices ``Z = (omega + mu) I - Sigma(omega)``;
the kernels never call user code. A matrix Sigma is not Hermitian and not
a multiple of I, so the engines invert ``Z - H_k`` per (k, omega) with
``csrc/small_inverse.cuh`` (the reference's closed forms for m <= 3,
Gauss-Jordan with partial pivoting for 4 <= m <= 8) in two kernels,

- K27 (``csrc/sigma_trace.cu``): :func:`sigma_trace_sum`, the weighted
  k-sum of ``-Im Tr G / pi`` or of ``-Im G_ii / pi`` (SigmaDOSSolver), and
  :func:`sigma_trace_points`, ``Tr G`` at points (the integrands);
- K28 (``csrc/sigma_pairs.cu``): :func:`sigma_pairs_sum`, the weighted
  k-sum of ``Re Tr[v_a A1 v_b A2]`` at frequency pairs
  (SigmaTransportSolver, SigmaKineticCoefficientSolver), and
  :func:`sigma_pairs_points`, the same at points at one frequency
  (:func:`transport_distribution_sigma`); it reads only the Hermitian
  parts of H and dH, and for m <= 3 forms the Hermitian spectral functions
  from the adjugate itself.

CPU tensors take the kernels' plain versions, which are the reference's
operations (batched ``torch.linalg.solve`` above three bands); on the card
every engine launches the kernels, which take m <= 8 and raise above. The
grid engines evaluate
H (and dH) once on the (symmetry-reduced) grid with K1 or K11 at the
representatives and return numpy; :func:`dos_integrand_sigma` is a batched
``FourierIntegrand`` for PTR, IAI and TAI.
"""
from __future__ import annotations

import math

import numpy as np
import torch

from .._device import COMPLEX, REAL, as_device, check_tensor
from ..brillouin import TrivialRep
from ..fourier import FourierIntegrand
from ..ops.cuda_lib import check_launch, load_kernels, stream_handle
from .lindhard import _omega_tensor
from .observables import (_check_bands, _check_pairs, _inv_small, _trace_inv_small, certified_ladder, flat_pairs, gathered_grid,
                          group_average, reduced_grid, series_bands, spectral_of)
from .transport import KineticCoefficientSolver, _real, fermi_window


class SigmaInterpolant:
    """Piecewise-linear matrix-valued ``Sigma(omega)`` on a frequency grid,
    the carrier for numerically tabulated self-energies. ``values``: (W,)
    scalar or (W, m, m) matrices, held as float64 (re, im) tensors on
    ``device`` beside the grid; evaluation clamps to the end intervals
    outside the grid."""

    def __init__(self, omegas, values, device="cuda"):
        dev = as_device(device)
        om = np.asarray(omegas, dtype=np.float64)
        if om.ndim != 1 or om.shape[0] < 2:
            raise ValueError("SigmaInterpolant needs >= 2 grid frequencies")
        if not np.all(np.diff(om) > 0):
            raise ValueError(
                "SigmaInterpolant omegas must be strictly ascending "
                "(searchsorted on an unsorted grid silently mis-interpolates)")
        v = np.asarray(values)
        if v.shape[0] != om.shape[0]:
            raise ValueError(f"SigmaInterpolant has {om.shape[0]} frequencies but {v.shape[0]} values")
        self.omegas = torch.as_tensor(om, device=dev)
        self.values_re = torch.as_tensor(np.real(v).astype(np.float64), device=dev)
        self.values_im = torch.as_tensor(np.imag(v).astype(np.float64), device=dev)

    def __call__(self, om):
        og = self.omegas
        om = _real(om).to(og.device)
        i = torch.clamp(torch.searchsorted(og, om.reshape(-1), right=True) - 1, 0, og.shape[0] - 2).reshape(om.shape)
        t = torch.clamp((om - og[i]) / (og[i + 1] - og[i]), 0.0, 1.0)
        tb = t.reshape(t.shape + (1,) * (self.values_re.ndim - 1))

        def lerp(v):
            return (1 - tb) * v[i] + tb * v[i + 1]

        return torch.complex(lerp(self.values_re), lerp(self.values_im))


class SigmaCallable:
    """A plain-Python ``Sigma(omega)`` callable (closed-form self-energies:
    Fermi liquid ``-i(eta + a omega^2)``, atomic-limit poles, ...). It is
    called on a float64 tensor of frequencies (0-dim, or one per lane or
    node) and returns a number, a scalar per frequency, or (m, m) matrices
    (one, or one per frequency), as tensors or numpy."""

    def __init__(self, fn):
        self.fn = fn

    def __call__(self, om):
        return self.fn(om)


def _as_sigma(Sigma):
    if isinstance(Sigma, (SigmaInterpolant, SigmaCallable)):
        return Sigma
    return SigmaCallable(Sigma)


def _zmat(om, Sigma, m, mu=0.0, device=None):
    """``(om + mu) I - Sigma(om)`` as complex128 (..., m, m): om one
    frequency or a (L,) vector of them (lanes or nodes), Sigma a scalar or a
    matrix, one or one per frequency."""
    om = _real(om)
    if device is not None:
        om = om.to(device)
    z = (om + mu).to(COMPLEX)
    S = Sigma(om)
    if isinstance(S, torch.Tensor):
        S = S.to(device=om.device, dtype=COMPLEX)
    else:
        S = torch.as_tensor(np.asarray(S, dtype=np.complex128), device=om.device)
    eye = torch.eye(m, dtype=COMPLEX, device=om.device)
    if S.ndim <= om.ndim:  # a scalar self-energy, one or one per frequency
        S = S[..., None, None] * eye
    return z[..., None, None] * eye - S


def _trace_inv(M):
    """Tr M^{-1}: the reference's closed forms for m <= 3
    (``observables.py:73``), ``solve`` against the identity above."""
    if M.shape[-1] <= 3:
        return _trace_inv_small(M)
    return torch.diagonal(_inv_small(M), dim1=-2, dim2=-1).sum(-1)


def sigma_trace_points_plain(H, Z):
    """Plain PyTorch version of K27's pointwise entry, ``Tr (Z - H)^{-1}``
    (N,) by :func:`_trace_inv`."""
    return _trace_inv(Z - H)


def sigma_trace_points(H, Z):
    """``Tr (Z_n - H_n)^{-1}`` for H (N, m, m) and Z (N, m, m), or one (m,
    m) for all points, complex128. H must be Hermitian, as every caller's
    is; the kernel takes it as given, as the plain version does. Returns (N,)
    complex128.

    CPU tensors take the plain version; CUDA tensors launch K27's pointwise
    entry (``csrc/sigma_trace.cu``), and anything the kernel does not take
    raises."""
    N, m = _check_pairs(H, Z)
    if H.device.type == "cpu":
        return sigma_trace_points_plain(H, Z)
    if H.device.type != "cuda":
        raise ValueError(f"sigma_trace_points runs on cpu or cuda tensors, got {H.device}")
    _check_bands(m)
    out = torch.empty(N, dtype=COMPLEX, device=H.device)
    if N == 0:
        return out
    check_launch(load_kernels().sigma_trace_points_launch(H.data_ptr(), Z.data_ptr(), 0 if Z.ndim == 2 else m * m,
                                                          out.data_ptr(), N, m, stream_handle(H.device)),
                 "sigma_trace_points")
    sigma_trace_points.launches += 1
    return out


sigma_trace_points.launches = 0


def greens_trace_sigma(hv, om, Sigma=None, mu=0.0):
    """``Tr G(k, om)`` with a matrix self-energy at the points of a
    FourierValue (H (..., m, m); om one frequency or one per point), by
    K27's pointwise entry."""
    H = hv.s
    m = H.shape[-1]
    Hf, Zf, batch = flat_pairs(H, _zmat(om, Sigma, m, mu, H.device))
    return sigma_trace_points(Hf, Zf).reshape(batch)


def dos_trace_sigma(hv, om, Sigma=None, mu=0.0):
    """Spectral weight ``-Im Tr G / pi`` with a matrix self-energy."""
    return -torch.imag(greens_trace_sigma(hv, om, Sigma=Sigma, mu=mu)) / math.pi


def sigma_pairs_points_plain(H, V, Z):
    """Plain PyTorch version of K28's pointwise entry, the reference's
    operations (``selfenergy.py:138-153``): ``Re Tr[v_a A v_b A]``, A from
    ``_inv_small(Z - H)``. Returns (N, d, d) float64."""
    A = spectral_of(_inv_small(Z - H))
    vA = torch.einsum("...aij,...jk->...aik", V, A)
    return torch.einsum("...aij,...bji->...ab", vA, vA).real


def sigma_pairs_points(H, V, Z):
    """``T[n, a, b] = Re Tr[v_a A v_b A]`` with ``A = (G - G^H) / (-2 pi
    i)``, ``G = (Z_n - H_n)^{-1}``, for H (N, m, m), V (N, d, m, m) and Z (N,
    m, m) or one (m, m) for all, complex128, d <= 3. H and V must be
    Hermitian: the kernel reads only their Hermitian parts ``(X + X^H) /
    2``, the plain version the matrices as given. Returns (N, d, d) float64.

    CPU tensors take the plain version; CUDA tensors launch K28's pointwise
    entry (``csrc/sigma_pairs.cu``), and anything the kernel does not take
    raises."""
    N, m = _check_pairs(H, Z)
    check_tensor(V, "V", device=H.device, dtype=COMPLEX, ndim=4)
    d = V.shape[1]
    check_tensor(V, "V", shape=(N, d, m, m))
    if H.device.type == "cpu":
        return sigma_pairs_points_plain(H, V, Z)
    if H.device.type != "cuda":
        raise ValueError(f"sigma_pairs_points runs on cpu or cuda tensors, got {H.device}")
    lib = load_kernels()
    if m > lib.sigma_max_bands() or d > 3:
        raise ValueError(f"K28 takes m <= {lib.sigma_max_bands()} and d <= 3, got m = {m}, d = {d}")
    out = torch.empty((N, d, d), dtype=REAL, device=H.device)
    if N == 0:
        return out
    stream = stream_handle(H.device)
    check_launch(lib.sigma_pairs_points_launch(H.data_ptr(), V.data_ptr(), Z.data_ptr(), 0 if Z.ndim == 2 else m * m,
                                               out.data_ptr(), N, m, d, stream), "sigma_pairs_points")
    sigma_pairs_points.launches += 1
    return out


sigma_pairs_points.launches = 0


def transport_distribution_sigma(hv, om, Sigma=None, mu=0.0):
    """Kubo-Greenwood transport distribution with a matrix self-energy,
    ``Gamma_ab(om) = Re Tr[v_a A(om) v_b A(om)]`` with the full matrix
    spectral function ``A = (G - G^H) / (-2 pi i)``, ``G = [(om + mu) I -
    Sigma(om) - H]^{-1}``, over a JacobianSeries value ``(H, dH)`` at one
    point or a batch, by K28's pointwise entry."""
    H, V = hv.s
    m, d = H.shape[-1], V.shape[-3]
    Hf, Zf, batch = flat_pairs(H, _zmat(om, Sigma, m, mu, H.device))
    Vf = V.expand(batch + (d, m, m)).reshape(-1, d, m, m).contiguous()
    return sigma_pairs_points(Hf, Vf, Zf).reshape(batch + (d, d))


def dos_integrand_sigma(h, Sigma, mu=0.0):
    """``FourierIntegrand`` for the self-energy DOS (TrivialRep: the trace is
    group-invariant, so IBZ solves symmetrize by pure weight). It takes
    whole batches of points (``batched=True``: one K27 launch per PTR rule,
    IAI leaf trip or TAI trip), with one frequency or one per point."""
    fi = FourierIntegrand(dos_trace_sigma, h, Sigma=_as_sigma(Sigma), mu=mu, batched=True)
    fi.rep = TrivialRep()
    return fi


def _k_chunk(C, width):
    """k-points per chunk of the plain versions: (C, chunk, width) complex
    intermediates near 64 MB."""
    return max(1, (1 << 22) // max(1, C * width))


def sigma_trace_sum_plain(H, w, Z, scale, diagonal=False, chunk=8):
    """Plain PyTorch version of K27's sum, the reference's operations
    (``selfenergy.py:214-225``): per frequency, ``M = Z - H``, then
    ``-sum_k w_k Im Tr(...)`` by the closed forms (m <= 3) or ``solve``
    (m > 3), or ``Im diag(_inv_small(M))`` with ``diagonal``, ``/ pi *
    scale``; ``chunk`` frequencies at a time and k in chunks (at most
    EIGH_CHUNK matrices a ``solve`` above three bands). Returns (W,) or (W,
    m) float64."""
    from ..ops.eigh3 import EIGH_CHUNK

    K, m = H.shape[0], H.shape[-1]
    C = max(1, int(chunk))
    kc = _k_chunk(C, m * m)
    if m > 3:
        kc = min(kc, max(1, EIGH_CHUNK // C))
    rows = []
    for s in range(0, Z.shape[0], C):
        acc = 0.0
        for k0 in range(0, K, kc):
            M = Z[s:s + C, None] - H[None, k0:k0 + kc]
            wk = w[k0:k0 + kc]
            if diagonal:
                Gd = torch.diagonal(_inv_small(M), dim1=-2, dim2=-1)
                acc = acc + torch.einsum("k,ckm->cm", wk, Gd.imag)
            else:
                acc = acc + _trace_inv(M).imag @ wk
        rows.append(-acc / math.pi * scale)
    if not rows:
        return torch.empty((0, m) if diagonal else (0,), dtype=REAL, device=H.device)
    return torch.cat(rows)


def sigma_trace_sum(H, w, Z, scale, diagonal=False, chunk=8):
    """``D[j] = -scale / pi * sum_k w_k Im Tr (Z_j - H_k)^{-1}``, or with
    ``diagonal`` ``D[j, i] = -scale / pi * sum_k w_k Im [(Z_j -
    H_k)^{-1}]_ii``, for H (K, m, m) and Z (W, m, m) complex128 and weights
    w (K,) float64. H must be Hermitian: for m <= 3 the kernel reads its
    Hermitian part ``(H + H^H) / 2``, the plain version H as given. Returns
    (W,) or (W, m) float64.

    CPU tensors take the plain version (``chunk`` frequencies at a time);
    CUDA tensors launch K27 (``csrc/sigma_trace.cu``), which takes m <= 8,
    and anything the kernel does not take raises."""
    check_tensor(H, "H", dtype=COMPLEX, ndim=3)
    K, m = H.shape[0], H.shape[-1]
    check_tensor(H, "H", shape=(K, m, m))
    check_tensor(w, "w", device=H.device, dtype=REAL, ndim=1, shape=(K,))
    check_tensor(Z, "Z", device=H.device, dtype=COMPLEX, ndim=3)
    W = Z.shape[0]
    check_tensor(Z, "Z", shape=(W, m, m))
    if H.device.type == "cpu":
        return sigma_trace_sum_plain(H, w, Z, float(scale), diagonal, chunk)
    if H.device.type != "cuda":
        raise ValueError(f"sigma_trace_sum runs on cpu or cuda tensors, got {H.device}")
    _check_bands(m)
    lib = load_kernels()
    J = m if diagonal else 1
    out = torch.empty((W, J), dtype=REAL, device=H.device)
    if W:
        partials = torch.empty((max(lib.sigma_trace_num_chunks(K), 1), W, J), dtype=REAL, device=H.device)
        stream = stream_handle(H.device)
        check_launch(lib.sigma_trace_sum_launch(H.data_ptr(), w.data_ptr(), Z.data_ptr(), partials.data_ptr(),
                                                out.data_ptr(), K, W, m, int(bool(diagonal)),
                                                -float(scale) / math.pi, stream), "sigma_trace_sum")
        sigma_trace_sum.launches += 1
    return out if diagonal else out[:, 0]


sigma_trace_sum.launches = 0


def sigma_pairs_sum_plain(H, V, w, Z1, Z2, scale, chunk=4):
    """Plain PyTorch version of K28's sum, the reference's operations
    (``selfenergy.py:279-286, 380-393``): per pair ``A1``, ``A2`` from
    ``_inv_small``, ``Re Tr[v_a A1 v_b A2]`` by two einsums, then ``sum_k w_k
    (...) * scale``; ``chunk`` pairs at a time and k in chunks (A2 is A1
    when ``Z2 is Z1``). Returns (B, d, d) float64."""
    from ..ops.eigh3 import EIGH_CHUNK

    K, d, m = V.shape[0], V.shape[1], H.shape[-1]
    same = Z2 is Z1
    C = max(1, int(chunk))
    kc = _k_chunk(C, d * m * m)
    if m > 3:
        kc = min(kc, max(1, EIGH_CHUNK // C))
    rows = []
    for s in range(0, Z1.shape[0], C):
        acc = 0.0
        for k0 in range(0, K, kc):
            Hk, Vk = H[None, k0:k0 + kc], V[k0:k0 + kc]
            A1 = spectral_of(_inv_small(Z1[s:s + C, None] - Hk))
            A2 = A1 if same else spectral_of(_inv_small(Z2[s:s + C, None] - Hk))
            vA1 = torch.einsum("kaij,ckjn->ckain", Vk, A1)
            vA2 = vA1 if same else torch.einsum("kbij,ckjn->ckbin", Vk, A2)
            Gam = torch.einsum("ckaij,ckbji->ckab", vA1, vA2).real
            acc = acc + torch.einsum("k,ckab->cab", w[k0:k0 + kc], Gam)
        rows.append(acc * scale)
    if not rows:
        return torch.empty((0, d, d), dtype=REAL, device=H.device)
    return torch.cat(rows)


def sigma_pairs_sum(H, V, w, Z1, Z2, scale, chunk=4):
    """``G[b, a, c] = scale * sum_k w_k Re Tr[v_a A1 v_c A2]`` with ``A_i =
    (G_i - G_i^H) / (-2 pi i)``, ``G_i = (Z_i[b] - H_k)^{-1}``, for H (K, m,
    m), V (K, d, m, m), Z1 and Z2 (B, m, m) complex128 and weights w (K,)
    float64. H and V must be Hermitian: the kernel reads only their
    Hermitian parts ``(X + X^H) / 2``, the plain version the matrices as
    given. Equal frequencies are asked for by identity: when ``Z2 is Z1``
    the inverse is taken once. Returns (B, d, d) float64.

    CPU tensors take the plain version (``chunk`` pairs at a time); CUDA
    tensors launch K28 (``csrc/sigma_pairs.cu``), which takes m <= 8 and d <=
    3, and anything the kernel does not take raises."""
    check_tensor(H, "H", dtype=COMPLEX, ndim=3)
    K, m = H.shape[0], H.shape[-1]
    check_tensor(H, "H", shape=(K, m, m))
    check_tensor(V, "V", device=H.device, dtype=COMPLEX, ndim=4)
    d = V.shape[1]
    check_tensor(V, "V", shape=(K, d, m, m))
    check_tensor(w, "w", device=H.device, dtype=REAL, ndim=1, shape=(K,))
    check_tensor(Z1, "Z1", device=H.device, dtype=COMPLEX, ndim=3)
    B = Z1.shape[0]
    check_tensor(Z1, "Z1", shape=(B, m, m))
    check_tensor(Z2, "Z2", device=H.device, dtype=COMPLEX, ndim=3, shape=(B, m, m))
    if H.device.type == "cpu":
        return sigma_pairs_sum_plain(H, V, w, Z1, Z2, float(scale), chunk)
    if H.device.type != "cuda":
        raise ValueError(f"sigma_pairs_sum runs on cpu or cuda tensors, got {H.device}")
    lib = load_kernels()
    if m > lib.sigma_max_bands() or d > 3:
        raise ValueError(f"K28 takes m <= {lib.sigma_max_bands()} and d <= 3, got m = {m}, d = {d}")
    out = torch.empty((B, d, d), dtype=REAL, device=H.device)
    if B:
        partials = torch.empty((max(lib.sigma_pairs_num_chunks(K), 1), B, d, d), dtype=REAL, device=H.device)
        stream = stream_handle(H.device)
        check_launch(lib.sigma_pairs_sum_launch(H.data_ptr(), V.data_ptr(), w.data_ptr(), Z1.data_ptr(),
                                                Z2.data_ptr(), int(Z2 is Z1), partials.data_ptr(), out.data_ptr(),
                                                K, B, m, d, float(scale), stream), "sigma_pairs_sum")
        sigma_pairs_sum.launches += 1
    return out


sigma_pairs_sum.launches = 0


def _grid(h, bz, npt, jacobian):
    """(H (K, m, m)[, V (K, d, m, m)], weights (K,), scale, Savg) on the
    (symmetry-reduced) npt^d grid, on the series' device."""
    d = bz.ndim
    lin, weights, u, scale, Savg = reduced_grid(bz, npt, h.period)
    m = series_bands(h)
    if jacobian:
        hk, vk = gathered_grid(h, d, u, lin, jacobian=True)
        mats = (hk.reshape(-1, m, m).contiguous(), vk.reshape(-1, d, m, m).contiguous())
    else:
        mats = (gathered_grid(h, d, u, lin).reshape(-1, m, m).contiguous(),)
    w = torch.as_tensor(np.asarray(weights), dtype=REAL, device=mats[0].device)
    return mats, w, scale, Savg


class SigmaDOSSolver:
    """Grid engine for self-energy spectral sweeps: H on the
    (symmetry-reduced) ``npt^d`` grid is evaluated once; each call builds
    ``Z(omega) = (omega + mu) I - Sigma(omega)`` for all its frequencies and
    runs one K27 launch. Returns
    (W,) float64 numpy, or with ``project=True`` the orbital-projected DOS
    ``-Im G_ii / pi`` (W, m), whose rows sum to the total (orbital weights
    are meaningful over an IBZ whose group leaves the orbitals fixed).
    ``omega_chunk`` sets the plain version's memory chunk only."""

    def __init__(self, h, bz, npt, Sigma, mu=0.0, omega_chunk=8, project=False):
        (self._H,), self._w, self._scale, _ = _grid(h, bz, npt, jacobian=False)
        self._project = bool(project)
        self._mu = float(mu)
        self._Sigma = _as_sigma(Sigma)
        self._chunk = int(omega_chunk)
        self._m = int(self._H.shape[-1])

    def __call__(self, omegas):
        om = _omega_tensor(omegas, self._H.device)
        Z = _zmat(om, self._Sigma, self._m, self._mu).contiguous()
        return sigma_trace_sum(self._H, self._w, Z, self._scale, self._project, self._chunk).cpu().numpy()


class SigmaTransportSolver:
    """Kubo-Greenwood transport with a matrix self-energy on a cached grid:
    (H, dH) evaluated once on the (symmetry-reduced) ``npt^d`` grid (K11 at
    the representatives); each call is one K28 launch at equal frequencies,
    ``Gamma_ab(w) = sum_k w_k Re Tr[v_a A v_b A]`` with the full matrix
    spectral function, group-averaged back to the full zone on an IBZ.
    Returns (W, d, d) float64 numpy. The constant-``eta`` case has the
    cheaper band-diagonal engine :class:`~.observables.TransportSolver`.
    ``omega_chunk`` sets the plain version's memory chunk only."""

    def __init__(self, h, bz, npt, Sigma, mu=0.0, omega_chunk=4):
        (self._H, self._V), self._w, self._scale, self._Savg = _grid(h, bz, npt, jacobian=True)
        self._mu = float(mu)
        self._Sigma = _as_sigma(Sigma)
        self._chunk = int(omega_chunk)
        self._m = int(self._H.shape[-1])

    def __call__(self, omegas):
        om = _omega_tensor(omegas, self._H.device)
        Z = _zmat(om, self._Sigma, self._m, self._mu).contiguous()
        G = sigma_pairs_sum(self._H, self._V, self._w, Z, Z, self._scale, self._chunk)
        return group_average(G, self._Savg).cpu().numpy()


def certified_sigma_dos(h, bz, omegas, Sigma, mu=0.0, abstol=1e-3, reltol=0.0, nmin=20, nmax=400,
                        factor=2**0.5, project=False):
    """Self-energy DOS sweep certified over the whole curve:
    :class:`SigmaDOSSolver` rungs on :func:`~.observables.certified_ladder`."""

    def eval_at(npt):
        return SigmaDOSSolver(h, bz, npt, Sigma, mu=mu, project=project)(omegas)

    return certified_ladder(eval_at, abstol, reltol, nmin, nmax, factor)


class SigmaKineticCoefficientSolver(KineticCoefficientSolver):
    """Kinetic coefficients with a matrix self-energy: the two-frequency
    distribution ``Gamma_ab(w, w + Omega) = sum_k w_k Re Tr[v_a A(w) v_b A(w
    + Omega)]`` with full matrix spectral functions, through the adaptive
    frequency integral of :class:`~.transport.KineticCoefficientSolver`,
    whose ``__call__`` and ``sweep`` it inherits (``Sigma = -i eta``
    reproduces it). ``alpha=0`` optical conductivity, ``alpha=1, 2``
    thermoelectric numerators.

    (H, dH) is evaluated once on the (symmetry-reduced) grid; each GK trip
    is one K28 launch over all its nodes and grid points (one inverse per
    pair at Omega = 0). The parent's ``__init__`` is not called: its
    band-diagonal pack does not apply to matrix self-energies."""

    def __init__(self, h, bz, npt, Sigma, beta, alpha=0, mu=0.0, order=7, cap=256, wtol=1e-10):
        if not isinstance(alpha, (int, np.integer)) or alpha < 0:
            raise ValueError("alpha must be a small non-negative integer")
        # the state the inherited __call__ and sweep read
        self.beta = float(beta)
        self.alpha = int(alpha)
        self.mu = float(mu)
        self.order = order
        self.cap = cap
        self.wtol = float(wtol)
        self.d = bz.ndim
        self.numevals = 0
        self.retcode = None
        self.stats = None
        (self._H, self._V), self._wk, self._scale, self._Savg = _grid(h, bz, npt, jacobian=True)
        self.device = self._H.device
        self._Sigma = _as_sigma(Sigma)
        self._m = int(self._H.shape[-1])

    def _integrand(self, w, Omega):
        """The integrand at nodes w (N,) (or one node) with photon
        frequencies Omega (one, or one per node; absolute frequencies, mu = 0
        in Z): (N, d, d) (or (d, d))."""
        w = _real(w).to(self.device)
        scalar = w.ndim == 0
        w = w.reshape(-1)
        Om = _real(Omega, like=w).to(self.device).expand(w.shape)
        Z1 = _zmat(w, self._Sigma, self._m, 0.0).contiguous()
        if isinstance(Omega, torch.Tensor) or np.any(Omega):
            Z2 = _zmat(w + Om, self._Sigma, self._m, 0.0).contiguous()
        else:  # Omega = 0: Gamma(w, w), one inverse per pair
            Z2 = Z1
        G = group_average(sigma_pairs_sum(self._H, self._V, self._wk, Z1, Z2, self._scale), self._Savg)
        win = fermi_window(w, Om, self.beta, self.mu)
        mom = (self.beta * (w - self.mu)) ** self.alpha if self.alpha else 1.0
        out = (mom * win)[:, None, None] * G
        return out[0] if scalar else out
