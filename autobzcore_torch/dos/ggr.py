"""Generalized Gilat-Raubenheimer DOS (reference ``autobzcore_tpu/dos/ggr.py``,
kernel family B8, GGR half).

On a symmetry-reduced ``npt^d`` k-grid: evaluate H and its gradient with
respect to z = x/t at the points, eigendecompose H, take the band velocities
``Re diag(U^H dH_j U)``, and sum the closed-form box-broadened delta of
every (k, band) at each energy. Second-order convergent and robust at band
crossings (the reference's ``src/dos_ggr.jl``).

Kernel K11 (:func:`~autobzcore_torch.ops.fourier_eval.fourier_points_derivs`)
gives (H, dH) at the representatives ``reps/npt * period`` (points, as the
port's PTR rule, not a gather from a grid evaluation). On the card at m <= 3
K12's fused entry (:func:`band_velocity_eigh`, ``csrc/band_velocity.cu``)
takes K11's output and writes the energies and velocities, its eigensolve in
registers, in chunks of up to :data:`FUSED_CHUNK` points: one K11 and one K12
launch a chunk, no cuSOLVER call. Otherwise (more bands, or the CPU) the
init runs in chunks of at most ``ops.eigh3.EIGH_CHUNK`` points: K11,
``torch.linalg.eigh`` for the eigenpairs (the reference calls the library
here too) and K12 (:func:`band_velocity`) for the velocities. The cache
keeps the energies (K, m), velocities (K, d, m) and weights in float64.
Each ``dos_solve``/``dos_sweep`` is one launch of kernel K13
(:func:`ggr_box_sum`, ``csrc/ggr_dos.cu``) and returns numpy, as the port's
LTM does. :func:`gaussian_sum` is K13's Gaussian mode, the sum of
``dos.AdaptiveGaussianBroadening``.

Every ``precision`` runs native complex128: the reference's split-f64 tiers
(``spectral_split``) are TPU emulation with no counterpart here (ROADMAP
"Not to port").
"""
from __future__ import annotations

import numpy as np
import torch

from .._device import COMPLEX, REAL, check_tensor
from ..algorithms.ptr import rule_points
from ..brillouin import SymmetricBZ
from ..fourier import FourierSeries, JacobianSeries
from ..ops.cuda_lib import check_launch, load_kernels, stream_handle
from ..ops.eigh3 import EIGH_CHUNK, eigh_chunked
from ..ops.fourier_eval import fourier_points_derivs, jacobian_orders
from .interfaces import DOSAlgorithm, DOSSolution
from .tetrahedron import in_sorted_order

_EPS = 1e-300
_PLAIN_TERMS = 1 << 22  # (energy, k, band) terms per pass of K13's plain version
# points a chunk of K11 and K12's fused entry: K11's output holds 16 m^2 (1 +
# d) bytes a point (576 at m = 3, d = 3), so a chunk of 2^20 peaks near 0.7
# GB with the energies and velocities; the flagship's npt=100 grid is one
# chunk
FUSED_CHUNK = 1 << 20


def band_velocity_plain(U, dH):
    """Plain PyTorch version of K12: ``Re diag(U^H dH_j U)`` for U (K, m, m)
    and dH (K, d, m, m), by the reference's einsum; returns (K, d, m)."""
    return torch.einsum("kim,kdij,kjm->kdm", U.conj(), dH, U).real.contiguous()


def band_velocity(U, dH):
    """Band velocities ``v[k, j, b] = Re sum_il conj(U[k, i, b]) dH[k, j, i,
    l] U[k, l, b]`` for eigenvectors U (K, m, m) complex128 (columns) and
    gradients dH (K, d, m, m) complex128 whose (m, m) blocks are contiguous
    (a view with other point and direction strides is taken as it is).
    Returns (K, d, m) float64.

    CPU tensors take the plain version; CUDA tensors launch K12, and anything
    the kernel does not take raises."""
    check_tensor(U, "U", dtype=COMPLEX, ndim=3)
    K, m, m2 = U.shape
    if m2 != m or dH.ndim != 4 or dH.shape[0] != K or tuple(dH.shape[2:]) != (m, m):
        raise ValueError(f"band_velocity takes U (K, m, m) and dH (K, d, m, m), got "
                         f"{tuple(U.shape)} and {tuple(dH.shape)}")
    if not isinstance(dH, torch.Tensor) or dH.dtype != COMPLEX or dH.device != U.device:
        raise ValueError("dH must be a complex128 tensor on U's device")
    d = dH.shape[1]
    if U.device.type == "cpu":
        return band_velocity_plain(U, dH)
    if U.device.type != "cuda":
        raise ValueError(f"band_velocity runs on cpu or cuda tensors, got {U.device}")
    if dH.stride(3) != 1 or dH.stride(2) != m:
        raise ValueError("band_velocity needs dH's (m, m) blocks contiguous")
    v = torch.empty((K, d, m), dtype=REAL, device=U.device)
    if K == 0:
        return v
    lib = load_kernels()
    stream = stream_handle(U.device)
    err = lib.band_velocity_launch(U.data_ptr(), dH.data_ptr(), v.data_ptr(), K, d, m,
                                   dH.stride(0), dH.stride(1), stream)
    check_launch(err, "band_velocity")
    band_velocity.launches += 1
    return v


band_velocity.launches = 0


def band_velocity_eigh_plain(J):
    """Plain version of K12's fused entry: ``torch.linalg.eigh`` of H = J[:,
    0] (in the chunks the card's solver takes), then :func:`band_velocity_plain`
    on dH = J[:, 1:]; returns ``(e (K, m), v (K, d, m))``."""
    e, U = eigh_chunked(J[:, 0])
    return e, band_velocity_plain(U, J[:, 1:])


def band_velocity_eigh(J):
    """Energies and band velocities from K11's output J (K, 1 + d, m, m)
    complex128, contiguous (H, then dH_j), m <= 3, d <= 3: ``(e (K, m), v (K,
    d, m))`` float64, e ascending and ``v[k, j, b] = Re u_b^H dH_j u_b`` for
    the eigenvectors u_b of H's Hermitian part.

    CPU tensors take the plain version (``torch.linalg.eigh``, then the
    reference's einsum); CUDA tensors launch K12's fused entry, whose
    eigensolve runs in registers (``ops.eigh3.eigh3_jacobi`` is its mirror);
    anything it does not take raises, m > 3 with the route that takes it. At
    exactly degenerate eigenvalues each band's velocity is that of the
    solver's eigenbasis (ROADMAP C3, C6); their sum over the cluster does not
    depend on the basis."""
    check_tensor(J, "J", dtype=COMPLEX, ndim=4)
    K, r, m, m2 = J.shape
    if m2 != m or not 1 <= m <= 3 or not 2 <= r <= 4:
        raise ValueError(f"band_velocity_eigh takes K11's output J (K, 1 + d, m, m) with m <= 3 and d <= 3, got "
                         f"{tuple(J.shape)}; above three bands spectral_grid takes eigh_chunked, then band_velocity")
    d = r - 1
    if J.device.type == "cpu":
        return band_velocity_eigh_plain(J)
    if J.device.type != "cuda":
        raise ValueError(f"band_velocity_eigh runs on cpu or cuda tensors, got {J.device}")
    e = torch.empty((K, m), dtype=REAL, device=J.device)
    v = torch.empty((K, d, m), dtype=REAL, device=J.device)
    if K:
        lib = load_kernels()
        check_launch(lib.band_velocity_eigh_launch(J.data_ptr(), e.data_ptr(), v.data_ptr(), K, m, d,
                                                   stream_handle(J.device)), "band_velocity_eigh")
        band_velocity_eigh.launches += 1
    return e, v


band_velocity_eigh.launches = 0


def _box_1d(b, dw, av, vtol):
    v1 = av[..., 0]
    # critical points (v ~ 0) are measure-zero in the box model: dropped
    inside = (dw <= b * v1) & (v1 > vtol)
    return torch.where(inside, 1.0 / torch.clamp_min(v1, _EPS), 0.0)


def _box_2d(b, dw, av, vtol):
    v2, v1 = av[..., 0], av[..., 1]
    w1 = b * torch.abs(v1 - v2)
    w3 = b * (v1 + v2)
    r1 = 2 * b / torch.clamp_min(v1, _EPS)
    r2 = (b * (v1 + v2) - dw) / torch.clamp_min(v1 * v2, _EPS)
    return torch.where(v1 > vtol, torch.where(dw <= w1, r1, torch.where(dw <= w3, r2, 0.0)), 0.0)


def _box_3d(b, dw, av, vtol):
    v3, v2, v1 = av[..., 0], av[..., 1], av[..., 2]
    w1 = b * torch.abs(v1 - v2 - v3)
    w2 = b * (v1 - v2 + v3)
    w3 = b * (v1 + v2 - v3)
    w4 = b * (v1 + v2 + v3)
    vv = torch.sqrt(v1**2 + v2**2 + v3**2)
    d123 = torch.clamp_min(v1 * v2 * v3, _EPS)
    d12 = torch.clamp_min(v1 * v2, _EPS)
    case_a = 4 * b**2 / torch.clamp_min(v1, _EPS)
    case_b = (2 * b**2 * (v1 * v2 + v2 * v3 + v3 * v1) - (dw**2 + (vv * b) ** 2)) / d123
    case_c = (b**2 * (v1 * v2 + 3 * v2 * v3 + v3 * v1) - b * dw * (-v1 + v2 + v3)
              - (dw**2 + (vv * b) ** 2) / 2) / d123
    case_d = 2 * b * (b * (v1 + v2) - dw) / d12
    case_e = (b * (v1 + v2 + v3) - dw) ** 2 / (2 * d123)
    res = torch.where(
        dw <= w1,
        torch.where(v1 >= v2 + v3, case_a, case_b),
        torch.where(dw <= w2, case_c, torch.where(dw <= w3, case_d,
                                                  torch.where(dw <= w4, case_e, 0.0))))
    return torch.where(v1 > vtol, res, 0.0)


_BOX_FORMULAS = {1: _box_1d, 2: _box_2d, 3: _box_3d}


def _energy_chunks(E, nterms):
    """Slices of the energies E such that each pass holds ~_PLAIN_TERMS terms."""
    step = max(1, _PLAIN_TERMS // max(nterms, 1))
    return [slice(s, s + step) for s in range(0, E.shape[0], step)]


def ggr_box_sum_plain(e, v, w, E, b, vtol):
    """Plain PyTorch version of K13's box mode: the reference's
    ``sum(w[:, None] * f(b, |E - e|, v))`` at each energy of E (W,), with
    the closed forms of ``autobzcore_tpu/dos/ggr.py:30-72`` in energy chunks."""
    d = v.shape[1]
    av = torch.sort(torch.abs(torch.movedim(v, 1, 2)), dim=-1).values  # (K, m, d) ascending
    formula = _BOX_FORMULAS[d]
    out = torch.empty(E.shape[0], dtype=REAL, device=e.device)
    for sl in _energy_chunks(E, e.numel()):
        dw = torch.abs(E[sl, None, None] - e)  # (Wc, K, m)
        contrib = formula(b, dw, av, vtol)
        out[sl] = torch.sum(w[:, None] * contrib, dim=(1, 2))
    return out


def gaussian_sum_plain(e, sigma, norm, w, E, scale):
    """Plain PyTorch version of K13's Gaussian mode: ``scale * sum(w[:, None]
    * norm * exp(-0.5 ((E - e) / sigma)^2))`` at each energy of E, as the
    reference's ``autobzcore_tpu/dos/tetrahedron.py:325-327``."""
    out = torch.empty(E.shape[0], dtype=REAL, device=e.device)
    for sl in _energy_chunks(E, e.numel()):
        g = norm * torch.exp(-0.5 * ((E[sl, None, None] - e) / sigma) ** 2)
        out[sl] = scale * torch.sum(w[:, None] * g, dim=(1, 2))
    return out


# the most energies K13 takes in any order (kFewE in csrc/ggr_dos.cu)
_FEW_E = 4


def _k13(mode, e, a, nrm, w, E, b, vtol, scale):
    """One K13 launch: ``mode`` d = 1..3 (box, a the velocities) or 0
    (Gaussian, a the widths, nrm the norms). K13 takes up to ``_FEW_E``
    energies in any order (term by term) and more sorted: then a copy is
    sorted on the card and the values go back in E's order."""
    K, m = e.shape
    lib = load_kernels()

    def launch(Es):
        W = Es.shape[0]
        out = torch.empty(W, dtype=REAL, device=e.device)
        # one partial per (energy, block), energy-major
        partials = torch.empty((max(W, 1), lib.ggr_dos_num_blocks(K, m, max(W, 1))), dtype=REAL,
                               device=e.device)
        rc = lib.ggr_dos_launch(mode, e.data_ptr(), a.data_ptr(), None if nrm is None else nrm.data_ptr(),
                                w.data_ptr(), K, m, Es.data_ptr(), W, float(b), float(vtol), float(scale),
                                partials.data_ptr(), out.data_ptr(), stream_handle(e.device))
        check_launch(rc, "ggr_dos")
        return out

    return launch(E) if E.shape[0] <= _FEW_E else in_sorted_order(launch, E)


def _check_spectral(e, w, E, extra):
    check_tensor(e, "e", dtype=REAL, ndim=2)
    K, m = e.shape
    check_tensor(w, "w", device=e.device, dtype=REAL, shape=(K,), ndim=1)
    check_tensor(E, "E", device=e.device, dtype=REAL, ndim=1)
    for name, t, shape in extra:
        check_tensor(t, name, device=e.device, dtype=REAL, ndim=len(shape), shape=shape)
    if e.device.type not in ("cpu", "cuda"):
        raise ValueError(f"K13 runs on cpu or cuda tensors, got {e.device}")
    return K, m


def ggr_box_sum(e, v, w, E, b, vtol):
    """GGR's DOS at the energies E (W,): ``sum over (k, band) of w_k f_d(b,
    |E - e_kb|, |v_kb|)`` with f_d the reference's box-broadened closed form
    in d = 1, 2, 3, for energies e (K, m), velocities v (K, d, m), weights w
    (K,), all float64, the half box width b and the gate vtol; the energies
    E in any order and with repeats. Returns (W,) float64.

    CPU tensors take the plain version; CUDA tensors launch K13 in box mode
    (above 4 energies on a sorted copy of E), and anything the kernel does
    not take raises."""
    check_tensor(v, "v", dtype=REAL, ndim=3)
    K, m = _check_spectral(e, w, E, [("v", v, (e.shape[0], v.shape[1], e.shape[1]))])
    d = v.shape[1]
    if d not in _BOX_FORMULAS:
        raise ValueError(f"GGR's closed forms take d = 1, 2, 3, got {d}")
    if e.device.type == "cpu":
        return ggr_box_sum_plain(e, v, w, E, float(b), float(vtol))
    out = _k13(d, e, v, None, w, E, b, vtol, 1.0)
    ggr_box_sum.launches += 1
    return out


ggr_box_sum.launches = 0


def gaussian_sum(e, sigma, norm, w, E, scale):
    """``scale * sum over (k, band) of w_k norm_kb exp(-0.5 ((E - e_kb) /
    sigma_kb)^2)`` at the energies E (W,) (in any order, with repeats), for
    e, sigma, norm (K, m) and w (K,), all float64: the dense Gaussian sum,
    with no truncation beyond FP64 underflow. Returns (W,) float64.

    CPU tensors take the plain version; CUDA tensors launch K13 in Gaussian
    mode (above 4 energies on a sorted copy of E), and anything the kernel
    does not take raises."""
    K, m = _check_spectral(e, w, E, [("sigma", sigma, (e.shape[0], e.shape[1])),
                                     ("norm", norm, (e.shape[0], e.shape[1]))])
    if e.device.type == "cpu":
        return gaussian_sum_plain(e, sigma, norm, w, E, float(scale))
    out = _k13(0, e, sigma, norm, w, E, 0.0, 0.0, scale)
    gaussian_sum.launches += 1
    return out


gaussian_sum.launches = 0


def eigen_chunks(h, X, points=fourier_points_derivs):
    """For each chunk of at most ``EIGH_CHUNK`` of the points X (K, d):
    ``(start, e, U, dH)``, the eigenpairs of H and the gradient dH/dz (n, d,
    m, m) (a view of K11's output) at the chunk's points, by K11
    (``points``, or its plain version) and ``torch.linalg.eigh``
    (:func:`~autobzcore_torch.ops.eigh3.eigh_chunked`). A scalar
    series is a 1 x 1 Hamiltonian."""
    m = h.valshape[0] if h.valshape else 1
    orders = jacobian_orders(X.shape[1])
    for s in range(0, X.shape[0], EIGH_CHUNK):
        J = points(h.c, X[s:s + EIGH_CHUNK], h.offset, h.period, orders)
        J = J.reshape(J.shape[:2] + (m, m))
        e, U = eigh_chunked(J[:, 0])
        yield s, e, U.contiguous(), J[:, 1:]


def spectral_grid(h, bz, npt, points=fourier_points_derivs, velocities=band_velocity):
    """Energies e (K, m), velocities v (K, d, m) with respect to z = x/t and
    weights w (K,), float64 on the series' device, at the symmetry
    representatives of the ``npt^d`` grid (the full grid in C order on a
    zone without symmetries). With the kernels (the defaults) on the card at
    m <= 3, K11 and K12's fused entry (:func:`band_velocity_eigh`) run in
    chunks of :data:`FUSED_CHUNK` points; otherwise K11 (``points``), eigh and
    K12 (``velocities``) in chunks of ``EIGH_CHUNK`` points. Passing the plain
    versions of K11 and K12 takes the latter route on them: the plain
    route."""
    d, dev = bz.ndim, h.device
    frac, w = rule_points(npt, d, bz.syms, dev)
    X = (frac * torch.as_tensor(h.period, dtype=REAL, device=dev)).contiguous()
    m = h.valshape[0] if h.valshape else 1
    es, vs = [], []
    if m <= 3 and dev.type == "cuda" and velocities is band_velocity:
        orders = jacobian_orders(d)
        for s in range(0, X.shape[0], FUSED_CHUNK):
            J = points(h.c, X[s:s + FUSED_CHUNK], h.offset, h.period, orders)
            e, v = band_velocity_eigh(J.reshape(J.shape[:2] + (m, m)))
            es.append(e)
            vs.append(v)
    else:
        for _, e, U, dH in eigen_chunks(h, X, points):
            es.append(e)
            vs.append(velocities(U, dH))
    if not es:
        return (torch.empty((0, m), dtype=REAL, device=dev), torch.empty((0, d, m), dtype=REAL, device=dev), w)
    if len(es) == 1:
        return es[0], vs[0], w
    return torch.cat(es), torch.cat(vs), w


class GGR(DOSAlgorithm):
    """``GGR(npt=50, precision="auto")`` (reference ``src/dos_algorithms.jl:23``):
    the generalized Gilat-Raubenheimer DOS on an ``npt^d`` grid. Every
    ``precision`` (``'auto'``, ``'complex'``, ``'split'``, ``'rayleigh'``)
    runs native complex128. Computes on the series' device (the card unless
    the series was placed on the CPU); sweeps return numpy float64 arrays."""

    def __init__(self, npt=50, precision="auto"):
        self.npt = npt
        self.precision = precision

    def init_cacheval(self, h, domain, p):
        if isinstance(h, JacobianSeries):
            h = h.s
        if not isinstance(h, FourierSeries):
            raise TypeError("GGR currently supports Fourier series Hamiltonians")
        if not isinstance(p, SymmetricBZ):
            raise TypeError("GGR supports BZ parameters from load_bz")
        d = p.ndim
        if d not in _BOX_FORMULAS:
            raise ValueError("GGR implemented for up to 3d BZ")
        vshape = h.valshape
        if len(vshape) not in (0, 2) or (len(vshape) == 2 and vshape[0] != vshape[1]):
            raise ValueError(f"GGR requires scalar or square-matrix series values, got {vshape}")
        npt = int(self.npt)
        e, v, w = spectral_grid(h, p, npt)
        # velocities at band critical points are numerical noise, not exact
        # zeros: the 1/v formulas are gated on a scale-relative threshold
        vmax = float(v.abs().max()) if v.numel() else 0.0
        return {
            "energies": e,
            "velocities": v,
            "weights": w,
            "b": 1.0 / (2 * npt),
            "vtol": 1e-10 * max(1.0, vmax),
            "numevals": int(e.shape[0]),
        }

    def _sum(self, cacheval, Es):
        e = cacheval["energies"]
        E = torch.as_tensor(np.atleast_1d(np.asarray(Es, np.float64)), device=e.device)
        return ggr_box_sum(e, cacheval["velocities"], cacheval["weights"], E.contiguous(),
                           cacheval["b"], cacheval["vtol"]).cpu().numpy()

    def dos_solve(self, h, domain, p, cacheval, abstol=None, reltol=None, maxiters=None):
        if np.ndim(domain) != 0:
            raise TypeError("GGR supports domains of individual eigenvalues")
        if not isinstance(p, SymmetricBZ):
            raise TypeError("GGR supports BZ parameters from load_bz")
        return DOSSolution(float(self._sum(cacheval, domain)[0]), None, True, cacheval["numevals"])

    def dos_sweep(self, cacheval, Es):
        """DOS over an energy grid: one K13 launch on the card."""
        return self._sum(cacheval, Es)

