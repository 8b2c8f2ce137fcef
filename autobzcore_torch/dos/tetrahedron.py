"""Linear tetrahedron method (LTM) for the density of states (reference
``autobzcore_tpu/dos/tetrahedron.py``, kernel family B8, tetrahedron half).

Each cell of an ``npt^d`` periodic grid is split into d! simplices, the band
energy is linearly interpolated from the corner values, and the DOS (and the
integrated DOS N(E)) of a linear band over a simplex has a closed form in the
sorted corner energies (Lehmann-Taut 1972, Bloechl 1994).

Init: eigenvalues once on the symmetry-reduced grid (``evaluate_grid``'s
complex128 products, the gather of the representatives, kernel K9 for
m <= 3 bands and ``eigvalsh_chunked`` above on the card), scattered back to
the full grid with the host's orbit map (``ops.symptr.symptr_orbit_map``)
into the band-major grid ``eg`` (m, npt^d). The cache holds ``eg``, not the
reference's sorted-corner tensor (d+1, d!, m npt^d), which kernel K10
(``csrc/tetra_dos.cu``, :func:`tetra_dos`) builds in registers: each energy
sweep is one launch in which every (cell, simplex, band) term reaches only
the energies of its support.
:func:`tetra_dos_plain` builds the corners the reference's way (rolls, a
stack, the min/max exchange network) and evaluates the closed forms in
energy chunks.

Normalization as the reference: the DOS is per unit fractional zone volume
(each band integrates to 1 over energy). The reference's TPU split-complex
branch (B9) is not ported.

:class:`AdaptiveGaussianBroadening` reuses GGR's spectral grid (kernels K11
and K12, see :mod:`autobzcore_torch.dos.ggr`) and sums its Gaussians with
kernel K13 in Gaussian mode (:func:`~autobzcore_torch.dos.ggr.gaussian_sum`).
"""
from __future__ import annotations

import numpy as np
import torch

from .._device import COMPLEX, REAL, check_tensor
from ..brillouin import SymmetricBZ
from ..fourier import FourierSeries, JacobianSeries
from ..ops.cuda_lib import check_launch, load_kernels, stream_handle
from ..ops.eigh3 import eigvalsh_small
from ..ops.fourier_eval import evaluate_grid
from ..ops.symptr import symptr_orbit_map
from .interfaces import DOSAlgorithm, DOSSolution

# simplex decompositions of the unit cell, corners as binary vertex labels
# (bit j = offset along grid axis j). All simplices share the main diagonal
# 0 -> 2^d - 1 (Bloechl's choice, which makes the tiling conforming).
_SIMPLICES = {
    1: [(0, 1)],
    2: [(0, 1, 3), (0, 2, 3)],
    3: [(0, 1, 3, 7), (0, 1, 5, 7), (0, 2, 3, 7), (0, 2, 6, 7), (0, 4, 5, 7), (0, 4, 6, 7)],
}
# the min/max exchange networks that sort d + 1 corners
_NETS = {2: [(0, 1)], 3: [(0, 1), (1, 2), (0, 1)], 4: [(0, 1), (2, 3), (0, 2), (1, 3), (1, 2)]}
_PLAIN_TERMS = 1 << 22  # (energy, simplex, band) terms per pass of the plain version


def _safe(x):
    return torch.where(x > 0.0, x, torch.ones((), dtype=x.dtype, device=x.device))


def _where(mask, x):
    return torch.where(mask, x, torch.zeros((), dtype=x.dtype, device=x.device))


def _dos_segment(E, ec, tol):
    """d=1: corners (2, ...) sorted ascending; DOS of a linear band."""
    e1, e2 = ec[0], ec[1]
    inside = (E >= e1) & (E < e2) & (e2 - e1 > tol)
    return _where(inside, 1.0 / _safe(e2 - e1))


def _dos_triangle(E, ec, tol):
    """d=2 (Lehmann-Taut): corners (3, ...) sorted ascending."""
    e1, e2, e3 = ec[0], ec[1], ec[2]
    d31 = _safe(e3 - e1)
    # flat (symmetry-degenerate) simplices are delta spikes of measure zero
    ok = e3 - e1 > tol
    lo = (E >= e1) & (E < e2) & ok
    hi = (E >= e2) & (E < e3) & ok
    r = _where(lo, 2.0 * (E - e1) / (_safe(e2 - e1) * d31))
    return r + _where(hi, 2.0 * (e3 - E) / (_safe(e3 - e2) * d31))


def _dos_tetrahedron(E, ec, tol):
    """d=3 (Bloechl Eq. A2-A4): corners (4, ...) sorted ascending."""
    e1, e2, e3, e4 = ec[0], ec[1], ec[2], ec[3]
    d21, d31, d41 = _safe(e2 - e1), _safe(e3 - e1), _safe(e4 - e1)
    d32, d42, d43 = _safe(e3 - e2), _safe(e4 - e2), _safe(e4 - e3)
    ok = e4 - e1 > tol  # drop flat (delta-spike) tetrahedra
    p1 = (E >= e1) & (E < e2) & ok
    p2 = (E >= e2) & (E < e3) & ok
    p3 = (E >= e3) & (E < e4) & ok
    r = _where(p1, 3.0 * (E - e1) ** 2 / (d21 * d31 * d41))
    mid = (3.0 * (e2 - e1) + 6.0 * (E - e2)
           - 3.0 * ((e3 - e1) + (e4 - e2)) * (E - e2) ** 2 / (d32 * d42)) / (d31 * d41)
    r = r + _where(p2, mid)
    return r + _where(p3, 3.0 * (e4 - E) ** 2 / (d41 * d42 * d43))


def _nos_segment(E, ec, tol):
    """Fraction of a linear 1-D segment below E (integrated DOS)."""
    e1, e2 = ec[0], ec[1]
    flat = e2 - e1 <= tol
    frac = torch.clamp((E - e1) / _safe(e2 - e1), 0.0, 1.0)
    return torch.where(flat, (E >= e1).to(REAL), frac)


def _nos_triangle(E, ec, tol):
    e1, e2, e3 = ec[0], ec[1], ec[2]
    e21, e31, e32 = _safe(e2 - e1), _safe(e3 - e1), _safe(e3 - e2)
    flat = e3 - e1 <= tol
    lo = (E >= e1) & (E < e2)
    hi = (E >= e2) & (E < e3)
    n = _where(lo, (E - e1) ** 2 / (e21 * e31))
    n = n + _where(hi, 1.0 - (e3 - E) ** 2 / (e32 * e31))
    n = n + (E >= e3).to(REAL)
    return torch.where(flat, (E >= e1).to(REAL), n)


def _nos_tetrahedron(E, ec, tol):
    """Bloechl Eq. A1-A5: occupied fraction of a linear tetrahedron."""
    e1, e2, e3, e4 = ec[0], ec[1], ec[2], ec[3]
    e21, e31, e41 = _safe(e2 - e1), _safe(e3 - e1), _safe(e4 - e1)
    e32, e42, e43 = _safe(e3 - e2), _safe(e4 - e2), _safe(e4 - e3)
    flat = e4 - e1 <= tol
    p1 = (E >= e1) & (E < e2)
    p2 = (E >= e2) & (E < e3)
    p3 = (E >= e3) & (E < e4)
    x = E - e2
    n = _where(p1, (E - e1) ** 3 / (e21 * e31 * e41))
    mid = (e21**2 + 3.0 * e21 * x + 3.0 * x**2
           - ((e3 - e1) + (e4 - e2)) / (e32 * e42) * x**3) / (e31 * e41)
    n = n + _where(p2, mid)
    n = n + _where(p3, 1.0 - (e4 - E) ** 3 / (e41 * e42 * e43))
    n = n + (E >= e4).to(REAL)
    return torch.where(flat, (E >= e1).to(REAL), n)


_DOS_FORMULAS = {1: _dos_segment, 2: _dos_triangle, 3: _dos_tetrahedron}
_NOS_FORMULAS = {1: _nos_segment, 2: _nos_triangle, 3: _nos_tetrahedron}


def sorted_corners(eg, d):
    """The reference's corner tensor (d+1, d!, m npt^d): the band-major grid
    ``eg`` (m, npt^d) rolled to the 2^d cell corners, stacked per simplex and
    sorted along the first axis by the min/max exchange network."""
    m, N = eg.shape
    npt = round(N ** (1.0 / d))
    g = eg.reshape((m,) + (npt,) * d)
    corners = []
    for v in range(2**d):
        shift = tuple(-((v >> j) & 1) for j in range(d))
        corners.append(torch.roll(g, shift, dims=tuple(range(1, d + 1))).reshape(m * N))
    vs = [torch.stack([corners[sx[k]] for sx in _SIMPLICES[d]]) for k in range(d + 1)]
    for i, j in _NETS[d + 1]:
        vs[i], vs[j] = torch.minimum(vs[i], vs[j]), torch.maximum(vs[i], vs[j])
    return torch.stack(vs)


def tetra_dos_plain(eg, d, E, tol, vol, nos=False):
    """Plain PyTorch version of K10: ``vol * sum`` over every (cell,
    simplex, band) of the DOS (or, with ``nos``, the N(E)) closed form at
    each energy of E (W,), from the band-major eigenvalue grid eg (m,
    npt^d). Builds :func:`sorted_corners` and evaluates chunks of energies
    and terms, so that the temporaries stay near 0.5 GB."""
    ec = sorted_corners(eg, d).reshape(d + 1, -1)  # (d+1, terms)
    formula = (_NOS_FORMULAS if nos else _DOS_FORMULAS)[d]
    terms = max(ec.shape[1], 1)
    tchunk = min(terms, _PLAIN_TERMS)
    echunk = max(1, _PLAIN_TERMS // tchunk)
    out = torch.zeros(E.shape[0], dtype=REAL, device=eg.device)
    for s in range(0, E.shape[0], echunk):
        Ec = E[s:s + echunk, None]
        acc = torch.zeros(Ec.shape[0], dtype=REAL, device=eg.device)
        for t in range(0, ec.shape[1], tchunk):
            acc += formula(Ec, ec[:, None, t:t + tchunk], tol).sum(1)
        out[s:s + echunk] = vol * acc
    return out


def in_sorted_order(fn, E):
    """``fn`` of the energies E (W,) sorted ascending, its values (W,) put
    back in E's order; one energy goes as it is."""
    if E.shape[0] <= 1:
        return fn(E)
    Es, order = torch.sort(E)
    out = fn(Es)
    return torch.empty_like(out).index_copy_(0, order, out)


def tetra_dos(eg, d, E, tol, vol, nos=False):
    """``out[j] = vol * sum over (cell, simplex, band) f(E[j], sorted
    corners)`` for the band-major eigenvalue grid eg (m, npt^d) float64 of a
    periodic npt^d grid (d in 1, 2, 3) and energies E (W,) float64, in any
    order and with repeats; f is the DOS closed form, or N(E)'s with
    ``nos``. Returns (W,) float64.

    CPU tensors take the plain version; CUDA tensors launch K10, and
    anything the kernel does not take raises. K10 takes the energies sorted:
    above one energy the wrapper sorts a copy on the card and puts the
    values back in E's order."""
    check_tensor(eg, "eg", dtype=REAL, ndim=2)
    check_tensor(E, "E", device=eg.device, dtype=REAL, ndim=1)
    if d not in _SIMPLICES:
        raise ValueError(f"the tetrahedron method takes d = 1, 2, 3, got {d}")
    m, N = eg.shape
    npt = round(N ** (1.0 / d))
    if npt**d != N:
        raise ValueError(f"eg must hold an npt^{d} grid per band, got {N} points")
    tol, vol = float(tol), float(vol)
    if eg.device.type == "cpu":
        return tetra_dos_plain(eg, d, E, tol, vol, nos)
    if eg.device.type != "cuda":
        raise ValueError(f"tetra_dos runs on cpu or cuda tensors, got {eg.device}")
    lib = load_kernels()

    def launch(Es):
        W = Es.shape[0]
        out = torch.empty(W, dtype=REAL, device=eg.device)
        partials = torch.empty((lib.tetra_dos_num_blocks(m, npt, d, max(W, 1)), max(W, 1)), dtype=REAL,
                               device=eg.device)
        rc = lib.tetra_dos_launch(eg.data_ptr(), m, npt, d, Es.data_ptr(), W, tol, vol, int(bool(nos)),
                                  partials.data_ptr(), out.data_ptr(), stream_handle(eg.device))
        check_launch(rc, "tetra_dos")
        tetra_dos.launches += 1
        return out

    return in_sorted_order(launch, E)


tetra_dos.launches = 0


class LTM(DOSAlgorithm):
    """``LTM(npt=50)``: linear tetrahedron DOS over an ``npt^d`` grid.

    Exact for linear bands; resolves van Hove structure without a broadening
    parameter (unlike Lorentzian sums) and without the velocity data GGR
    needs. The delta function is sharp: values *at* band edges or critical
    energies follow the one-sided closed form, and outside the bands the
    DOS is exactly 0. Computes on the series' device (the card unless the
    series was placed on the CPU); sweeps return numpy float64 arrays."""

    def __init__(self, npt=50):
        self.npt = npt

    def init_cacheval(self, h, domain, p):
        if isinstance(h, JacobianSeries):
            h = h.s
        if not isinstance(h, FourierSeries):
            raise TypeError("LTM currently supports Fourier series Hamiltonians")
        if not isinstance(p, SymmetricBZ):
            raise TypeError("LTM supports BZ parameters from load_bz")
        bz = p
        d = bz.ndim
        if d not in _SIMPLICES:
            raise ValueError("LTM implemented for 1-, 2-, and 3-d BZs")
        npt = int(self.npt)
        dev = h.c.device
        if bz.syms is None:
            lin = full2rep = None
        else:
            reps, _, full2rep = symptr_orbit_map(npt, d, bz.syms)
            lin = np.ravel_multi_index(tuple(reps.T.astype(np.int64)), (npt,) * d)
        u = [np.arange(npt) / npt * h.period[j] for j in range(d)]
        hk = evaluate_grid(h.c, d, u, h.offset, h.period, None, COMPLEX)
        hk = hk.reshape((npt**d,) + tuple(hk.shape[d:]))
        if lin is not None:
            hk = hk[torch.as_tensor(lin, device=dev)]
        if hk.ndim == 1:
            e = hk.real[:, None]  # a scalar series: the value is the band
        else:
            e = eigvalsh_small(hk.contiguous())
        if full2rep is not None:
            e = e[torch.as_tensor(full2rep.astype(np.int64), device=dev)]  # scatter to the full grid
        eg = e.T.contiguous()  # band-major (m, npt^d)
        lo, hi = float(eg.min()), float(eg.max())
        scale = (hi - lo) or 1.0
        return {
            "eg": eg,
            "d": d,
            "tol": 1e-9 * scale,
            "vol": 1.0 / (len(_SIMPLICES[d]) * npt**d),  # fractional volume per simplex
            "emin": lo,
            "emax": hi,
            "numevals": int(npt**d if lin is None else len(lin)),
        }

    def _sum(self, cacheval, Es, nos):
        E = torch.as_tensor(np.atleast_1d(np.asarray(Es, np.float64)), device=cacheval["eg"].device)
        return tetra_dos(cacheval["eg"], cacheval["d"], E.contiguous(), cacheval["tol"],
                         cacheval["vol"], nos).cpu().numpy()

    def dos_solve(self, h, domain, p, cacheval, abstol=None, reltol=None, maxiters=None):
        if np.ndim(domain) != 0:
            raise TypeError("LTM supports domains of individual energies")
        return DOSSolution(float(self._sum(cacheval, domain, False)[0]), None, True,
                           cacheval["numevals"])

    def dos_sweep(self, cacheval, Es):
        """DOS over an energy grid: one K10 launch on the card."""
        return self._sum(cacheval, Es, False)

    def nos_sweep(self, cacheval, Es):
        """Integrated DOS N(E) (number of states per fractional zone volume,
        in [0, nbands]): the tetrahedron closed form, not a quadrature."""
        return self._sum(cacheval, Es, True)

    def fermi_level(self, cacheval, nstates, tol=1e-10, maxiter=200):
        """Energy E_F with N(E_F) = ``nstates`` (e.g. electrons per cell /
        spin degeneracy), by host bisection on the closed-form N(E), one
        single-energy evaluation per step.

        Conditioning: the E_F error is ~ (N-resolution)/D(E_F), so fillings
        that pin E_F at a band-touching point (D -> 0, e.g. graphene at half
        filling) resolve only to O(1/npt): raise ``npt`` there."""
        lo = cacheval["emin"] - 1.0
        hi = cacheval["emax"] + 1.0
        for _ in range(maxiter):
            mid = 0.5 * (lo + hi)
            if float(self._sum(cacheval, mid, True)[0]) < nstates:
                lo = mid
            else:
                hi = mid
            if hi - lo < tol:
                break
        return 0.5 * (lo + hi)


class AdaptiveGaussianBroadening(DOSAlgorithm):
    """``AdaptiveGaussianBroadening(npt=50, a=1.0, min_sigma=None,
    precision="auto")``: Gaussian-smeared DOS with a per-(k, band) width set
    by the local band velocity, ``sigma_kb = max(a |v_kb| / npt, floor)``
    (Yates et al., PRB 75, 195121 (2007)). The floor is ``min_sigma``, by
    default ``1e-3 (max e - min e) / npt``. Reuses GGR's spectral grid, so
    it shares GGR's expensive-init, cheap-sweep cache shape; every
    ``precision`` runs native complex128. Sweeps return numpy float64."""

    def __init__(self, npt=50, a=1.0, min_sigma=None, precision="auto"):
        self.npt = npt
        self.a = a
        self.min_sigma = min_sigma
        self.precision = precision

    def init_cacheval(self, h, domain, p):
        from .ggr import GGR

        cv = GGR(self.npt, self.precision).init_cacheval(h, domain, p)
        e, v, w = cv["energies"], cv["velocities"], cv["weights"]  # (K, m), (K, d, m), (K,)
        npt = self.npt
        sigma = self.a * torch.sqrt(torch.sum(v * v, dim=1)) / npt
        floor = self.min_sigma
        if floor is None:
            spread = float(e.max() - e.min()) or 1.0
            floor = 1e-3 * spread / npt
        sigma = torch.clamp_min(sigma, floor).contiguous()
        return {
            "energies": e,
            "sigma": sigma,
            "norm": (1.0 / (np.sqrt(2 * np.pi) * sigma)).contiguous(),
            "weights": w,
            "inv_total": 1.0 / float(torch.sum(w)),  # = npt^-d (fractional normalization)
            "numevals": cv["numevals"],
        }

    def _sum(self, cacheval, Es):
        from .ggr import gaussian_sum

        e = cacheval["energies"]
        E = torch.as_tensor(np.atleast_1d(np.asarray(Es, np.float64)), device=e.device)
        return gaussian_sum(e, cacheval["sigma"], cacheval["norm"], cacheval["weights"],
                            E.contiguous(), cacheval["inv_total"]).cpu().numpy()

    def dos_solve(self, h, domain, p, cacheval, abstol=None, reltol=None, maxiters=None):
        if np.ndim(domain) != 0:
            raise TypeError("AdaptiveGaussianBroadening supports scalar energies")
        return DOSSolution(float(self._sum(cacheval, domain)[0]), None, True, cacheval["numevals"])

    def dos_sweep(self, cacheval, Es):
        """DOS over an energy grid: one K13 launch (Gaussian mode) on the card."""
        return self._sum(cacheval, Es)
