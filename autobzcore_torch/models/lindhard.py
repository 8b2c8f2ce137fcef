"""Lindhard (non-interacting) susceptibility chi0(q, omega) and the Cooper
bubble on one cached full-zone grid (reference
``autobzcore_tpu/models/lindhard.py``, kernel family B13).

    chi0(q, w) = (|det B| / npt^d) sum_k sum_{nm} |<u_n(k)|u_m(k+q)>|^2
                 (f_n(k) - f_m(k+q)) / (w + i eta + e_n(k) - e_m(k+q))

The build evaluates H on the full ``npt^d`` grid (``evaluate_grid``,
complex128 products; a scalar series is lifted to 1x1), diagonalizes it
with ``ops.eigh3.eigh_chunked`` and caches the energies, the eigenvectors
and the occupations ``f = fermi(beta (e - mu))``, which do not depend on q.
A query snaps q to the grid (exact shifts; pass multiples of 1/npt for no
snapping) and is one launch of kernel K25 (:func:`chi0`,
``csrc/lindhard_chi0.cu``), which finds k+q by index arithmetic instead of
the reference's roll. :func:`cooper_bubble` is one launch of kernel K26
(:func:`cooper_mean`, same source). CPU tensors take the kernels' plain
versions. Queries return numpy; the grid stays on the series' device.

Conventions as the reference's: retarded, ``Im chi0 <= 0`` for ``w > 0``;
``Re chi0(q -> 0, 0) -> -beta |det B| mean[f (1 - f)]``; a full-zone BZ is
required (the integrand couples k and k+q). The Cooper bubble's partner
is the reference code's ``-(k+q)``, not the ``-k+q`` its docstring names
(the two agree where e(k) = e(-k)).
"""
from __future__ import annotations

import ctypes

import numpy as np
import torch

from .._device import COMPLEX, REAL, check_tensor
from ..ops.cuda_lib import check_launch, load_kernels, stream_handle
from ..ops.eigh3 import eigh_chunked
from ..ops.fourier_eval import evaluate_grid
from .transport import _real, fermi


def _grid_shift(e, shift):
    """(d, npt, shift mod npt) of a grid-shaped (npt,)*d + (m,) tensor."""
    d, npt = e.ndim - 1, e.shape[0]
    if d < 1 or any(n != npt for n in e.shape[:d]):
        raise ValueError(f"the grid must be (npt,)*d + (m,), got {tuple(e.shape)}")
    shift = tuple(int(s) % npt for s in shift)
    if len(shift) != d:
        raise ValueError(f"the shift must have {d} components, got {len(shift)}")
    return d, npt, shift


def _check_grid(e, f, name):
    check_tensor(e, "e", dtype=REAL)
    check_tensor(f, name, device=e.device, dtype=REAL, ndim=e.ndim, shape=e.shape)


def chi0_plain(e, f, U, shift, omega, eta, scale):
    """Plain PyTorch version of K25, the reference's operations
    (``lindhard.py:78-101``): roll (e, f, U) by the grid shift, the overlap
    weights, then ``scale * sum(W2 df / (w + i eta + de))`` per frequency,
    in frequency chunks that keep the (chunk, terms) intermediate near 64
    MB. Returns (W,) complex128."""
    d = e.ndim - 1
    axes, back = tuple(range(d)), tuple(-s for s in shift)
    eq, fq, Uq = (torch.roll(t, back, axes) for t in (e, f, U))
    W2 = torch.einsum("...in,...im->...nm", U.conj(), Uq).abs() ** 2
    a = (W2 * (f[..., :, None] - fq[..., None, :])).reshape(-1)
    de = (e[..., :, None] - eq[..., None, :]).reshape(-1)
    chunk = max(1, (1 << 22) // max(1, a.numel()))
    out = [torch.sum(a / torch.complex(omega[s:s + chunk, None] + de, torch.full_like(de, eta)), dim=-1)
           for s in range(0, omega.shape[0], chunk)]
    if not out:
        return torch.empty(0, dtype=COMPLEX, device=e.device)
    return torch.cat(out) * scale


def chi0(e, f, U, shift, omega, eta, scale):
    """``chi0[w] = scale * sum_{k, n, m} |<u_n(k)|u_m(k+q)>|^2 (f_n(k) -
    f_m(k+q)) / (omega[w] + i eta + e_n(k) - e_m(k+q))`` on the C-order
    grid of energies e and occupations f ((npt,)*d + (m,) float64) and
    eigenvectors U ((npt,)*d + (m, m) complex128, columns), k+q the grid
    point shifted by ``shift`` (d ints); omega (W,) float64. Returns (W,)
    complex128.

    CPU tensors take the plain version; CUDA tensors launch K25
    (``csrc/lindhard_chi0.cu``), and anything the kernel does not take
    raises: it takes ``1e-150 <= |eta| <= 1e150`` (below, its sum of
    ``a / (x^2 + eta^2)`` overflows before the factor ``-eta``; above,
    ``x^2 + eta^2`` nears the top of the double range)."""
    _check_grid(e, f, "f")
    d, npt, shift = _grid_shift(e, shift)
    m = e.shape[-1]
    check_tensor(U, "U", device=e.device, dtype=COMPLEX, ndim=e.ndim + 1, shape=tuple(e.shape) + (m,))
    check_tensor(omega, "omega", device=e.device, dtype=REAL, ndim=1)
    if e.device.type == "cpu":
        return chi0_plain(e, f, U, shift, omega, float(eta), float(scale))
    if e.device.type != "cuda":
        raise ValueError(f"chi0 runs on cpu or cuda tensors, got {e.device}")
    lib = load_kernels()
    if d > 3 or m > lib.chi0_max_bands():
        raise ValueError(f"K25 takes d <= 3 and m <= {lib.chi0_max_bands()}, got d = {d}, m = {m}")
    if not 1e-150 <= abs(float(eta)) <= 1e150:
        raise ValueError(f"K25 takes 1e-150 <= |eta| <= 1e150, got {eta!r}")
    W = omega.shape[0]
    out = torch.empty(W, dtype=COMPLEX, device=e.device)
    if W == 0:
        return out
    partials = torch.empty((W, lib.chi0_num_blocks(npt**d, m)), dtype=COMPLEX, device=e.device)
    sh = (ctypes.c_int * 3)(*(shift + (0,) * (3 - d)))
    stream = stream_handle(e.device)
    check_launch(lib.chi0_launch(e.data_ptr(), f.data_ptr(), U.data_ptr(), d, npt, sh, m, omega.data_ptr(), W,
                                 float(eta), float(scale), partials.data_ptr(), out.data_ptr(), stream), "chi0")
    chi0.launches += 1
    return out


chi0.launches = 0


def cooper_mean_plain(e, f, shift, mu, beta):
    """Plain PyTorch version of K26, the reference's operations
    (``lindhard.py:134-150``): the partner grid by flips and rolls, then the
    mean of ``(1 - f1 - f2) / (xi1 + xi2)`` with the ``beta f1 (1 - f1)``
    limit where ``|xi1 + xi2| < 1e-10``. Returns a 0-dim float64 tensor."""
    d = e.ndim - 1
    xi = e - mu
    rev, f2 = xi, f
    for ax in range(d):  # k -> -k: index i -> (-i) mod npt
        rev = torch.roll(torch.flip(rev, (ax,)), 1, ax)
        f2 = torch.roll(torch.flip(f2, (ax,)), 1, ax)
    for ax in range(d):  # then -k -> -(k + q)
        rev = torch.roll(rev, -shift[ax], ax)
        f2 = torch.roll(f2, -shift[ax], ax)
    den = xi + rev
    tiny = den.abs() < 1e-10
    val = torch.where(tiny, beta * f * (1.0 - f), (1.0 - f - f2) / torch.where(tiny, 1.0, den))
    return torch.mean(val)


def cooper_mean(e, f, shift, mu, beta):
    """The mean over (k, n) of ``(1 - f1 - f2) / (xi1 + xi2)``, xi = e - mu,
    with f1, xi1 at k and f2, xi2 at the partner ``-(k+q)``, the grid point
    whose index on each axis is ``-(i_j + shift_j) mod npt``, and the limit
    ``beta f1 (1 - f1)`` where ``|xi1 + xi2| < 1e-10``; e and f
    (npt,)*d + (m,) float64 (f = fermi(beta xi)). Returns a 0-dim float64
    tensor.

    CPU tensors take the plain version; CUDA tensors launch K26
    (``csrc/lindhard_chi0.cu``), and anything the kernel does not take
    raises."""
    _check_grid(e, f, "f")
    d, npt, shift = _grid_shift(e, shift)
    if e.device.type == "cpu":
        return cooper_mean_plain(e, f, shift, float(mu), float(beta))
    if e.device.type != "cuda":
        raise ValueError(f"cooper_mean runs on cpu or cuda tensors, got {e.device}")
    if d > 3:
        raise ValueError(f"K26 takes d <= 3, got {d}")
    lib = load_kernels()
    m = e.shape[-1]
    partials = torch.empty(max(lib.cooper_num_chunks(npt**d, m), 1), dtype=REAL, device=e.device)
    out = torch.empty((), dtype=REAL, device=e.device)
    sh = (ctypes.c_int * 3)(*(shift + (0,) * (3 - d)))
    stream = stream_handle(e.device)
    check_launch(lib.cooper_launch(e.data_ptr(), f.data_ptr(), d, npt, sh, m, float(mu), float(beta),
                                   partials.data_ptr(), out.data_ptr(), stream), "cooper_mean")
    cooper_mean.launches += 1
    return out


cooper_mean.launches = 0


def _grid_shift_of(q, d, npt):
    """q (fractional, d components) snapped to the grid: shifts mod npt."""
    q = np.atleast_1d(np.asarray(q, dtype=np.float64))
    if q.shape != (d,):
        raise ValueError(f"q must have {d} components, got {q.shape}")
    return tuple(int(np.rint(qi * npt)) % npt for qi in q)


class LindhardSolver:
    """Reusable chi0 queries over one cached (e, U, f) grid.

    >>> slv = LindhardSolver(h, bz, npt=64, beta=50.0, mu=0.0, eta=1e-2)
    >>> slv(q=[0.25, 0.0], omegas=np.linspace(0, 4, 200))   # (W,) complex

    ``q`` is in fractional coordinates and is snapped to the nearest grid
    vector. The grid lives on the series' device; each query is one K25
    launch there (the plain version on the CPU) and returns complex128
    numpy (W,)."""

    def __init__(self, h, bz, npt, beta, mu=0.0, eta=1e-2):
        if getattr(bz, "syms", None) is not None:
            raise ValueError(
                "LindhardSolver requires a full-zone BZ (load_bz(FBZ, ...)): "
                "chi0 couples k and k+q, so pointwise IBZ weights do not apply")
        d = bz.ndim
        self.npt = int(npt)
        self.ndim = d
        self.beta = float(beta)
        self.mu = float(mu)
        self.eta = float(eta)
        self._vol = abs(np.linalg.det(np.asarray(bz.B, dtype=np.float64)))
        u = [np.arange(self.npt) / self.npt * h.period[j] for j in range(d)]
        hk = evaluate_grid(h.c, d, u, h.offset, h.period)
        if hk.ndim == d:  # scalar series
            hk = hk[..., None, None]
        e, U = eigh_chunked(hk)  # (npt,)*d + (m,) / (m, m)
        self._e, self._U = e.contiguous(), U.contiguous()
        self._f = fermi(self.beta * (self._e - self.mu)).contiguous()
        self._m = int(e.shape[-1])

    def __call__(self, q, omegas):
        shift = _grid_shift_of(q, self.ndim, self.npt)
        om = _omega_tensor(omegas, self._e.device)
        vals = chi0(self._e, self._f, self._U, shift, om, self.eta, self._vol / self.npt**self.ndim)
        return vals.cpu().numpy()


def _omega_tensor(omegas, device):
    """Frequencies as a contiguous (W,) float64 tensor on ``device``."""
    return _real(omegas).to(device).reshape(-1).contiguous()


def cooper_bubble(slv: LindhardSolver, q=None):
    """Static particle-particle (Cooper) bubble on a :class:`LindhardSolver`
    grid, band-diagonal singlet form with time-reversed partners:

        chi_pp(q) = |det B| mean_{k, n} (1 - f(xi_n(k)) - f(xi_n(p)))
                                        / (xi_n(k) + xi_n(p)),

    ``xi = e - mu``, with the partner ``p = -(k+q)`` of the reference's code
    (see the module docstring) and the degenerate-denominator limit ``beta
    f (1 - f)``. The q = 0 value carries the Cooper logarithm, ``chi_pp ~
    N(mu) ln(beta W)``. One K26 launch on the card; returns a float."""
    q = np.zeros(slv.ndim) if q is None else q
    shift = _grid_shift_of(q, slv.ndim, slv.npt)
    return float(cooper_mean(slv._e, slv._f, shift, slv.mu, slv.beta)) * float(slv._vol)


def certified_chi0(h, bz, q, omegas, beta, mu=0.0, eta=1e-2, abstol=1e-3, reltol=0.0, nmin=24, nmax=480,
                   factor=2**0.5):
    """Richardson-certified Lindhard curve against the k-grid: a fresh
    ``LindhardSolver(h, bz, npt, beta, mu, eta)(q, omegas)`` on each rung of
    :func:`~.observables.certified_ladder`, every rung rounded up to a
    multiple of q's denominators (``Fraction.limit_denominator(1000)``), so
    that the q-snap is exact at every rung. Returns a
    :class:`~.observables.CertifiedSweep` whose ``u`` is the complex (W,)
    curve; ``retcode=False`` on honest nmax truncation."""
    from fractions import Fraction
    from math import lcm

    from .observables import certified_ladder

    q = np.atleast_1d(np.asarray(q, dtype=np.float64))
    dens = [Fraction(float(qi)).limit_denominator(1000).denominator for qi in q]
    mult = lcm(*dens) if dens else 1

    def eval_at(npt):
        return LindhardSolver(h, bz, int(npt), beta, mu=mu, eta=eta)(q, omegas)

    return certified_ladder(eval_at, abstol, reltol, nmin, nmax, factor, npt_multiple=mult)
