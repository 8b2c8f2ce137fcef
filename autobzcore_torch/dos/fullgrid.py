"""Lorentzian-broadened DOS through the streaming full-grid engine (reference
``autobzcore_tpu/dos/fullgrid.py``).

``LorentzianFullGrid(eta)`` exposes the full-grid ladder
(:class:`~autobzcore_torch.ops.grid_sweep.FullGridSpectralSweep`: complex128
stage products, kernel K7's fused eigenvalues and Lorentzian sum) as a
:class:`~autobzcore_torch.dos.interfaces.DOSAlgorithm`: the Richardson
ladder of full npt^3 PTR grids refines until the sup-norm change of the
whole DOS curve falls under ``abstol``. It computes the eta-broadened
spectral density with a convergence guarantee in the grid.

Normalization as the reference: DOS per unit fractional zone volume (each
band integrates to 1 over energy).
"""
from __future__ import annotations

import math
import time

import numpy as np

from .._device import as_device
from ..brillouin import SymmetricBZ
from ..fourier import FourierSeries, JacobianSeries
from ..ops.grid_sweep import FullGridSpectralSweep
from .interfaces import DOSAlgorithm, DOSSolution


def _geometric_step(npt, nmax, factor):
    """Next blind geometric rung after ``npt``, or None at the cap (the one
    shared definition for both the ladder and the auto scheduler's fallback)."""
    if npt >= nmax:
        return None
    return min(int(nmax), max(int(npt) + 1, int(round(npt * factor))))


def next_rung_npt(npts, deltas, tol, factor, nmax):
    """Adaptive rung scheduler for exponentially convergent PTR ladders (the
    reference's, verbatim).

    PTR on an analytic periodic integrand converges exponentially,
    ``err(npt) ~ A exp(-c npt)``. Each observed sup-norm rung delta
    approximates the coarser rung's true error, ``deltas[j] ~ err(npts[j])``,
    so with two deltas the rate fits as
    ``c = ln(deltas[-2]/deltas[-1]) / (npts[-2] - npts[-3])``. Two-branch
    policy on the predicted current error
    ``e_k = deltas[-1] * exp(-c (n_k - n_{k-1}))``:

    - ``e_k <= 1.4 tol``: take the smallest honest confirmation step,
      ``delta = e_k (1 - e^{-c s}) <= 0.95 tol`` solved for ``s``, floored at
      ``1/c``;
    - otherwise: jump ``ln(e_k / (0.7 tol))/c`` toward the rung whose
      predicted error hits the target, capped at ``1.5x`` the geometric
      growth for two-delta fits and ``2.5x`` once three monotone deltas
      corroborate the rate.

    Steps are floored at ``max(8, 2% n_k)``, rounded up to a multiple of 32
    (8 below 256) and capped at ``nmax``. Falls back to geometric growth
    while fewer than two deltas exist or when the fitted rate is not
    trusted. Returns the next npt (> npts[-1]) or None when
    ``npts[-1] >= nmax``.
    """
    n_k = int(npts[-1])
    if n_k >= nmax:
        return None

    def geometric():
        return _geometric_step(n_k, nmax, factor)

    if len(npts) < 3 or len(deltas) < 2:
        return geometric()
    d_prev, d_last = float(deltas[-2]), float(deltas[-1])
    # trust a 2-point fit only for strong decay (>= 4x per pair); weaker
    # trends additionally need three monotone deltas
    if not (d_prev > d_last > 0.0):
        return geometric()
    strong = d_prev >= 4.0 * d_last and (
        len(deltas) < 3 or float(deltas[-3]) >= d_prev
    )
    mono3 = len(deltas) >= 3 and float(deltas[-3]) > d_prev
    if not (strong or mono3):
        return geometric()
    span = float(npts[-2] - npts[-3])
    if span <= 0:
        return geometric()
    c = math.log(d_prev / d_last) / span
    if not math.isfinite(c) or c <= 0:
        return geometric()
    e_cur = d_last * math.exp(-c * (n_k - float(npts[-2])))
    target = 0.7 * float(tol)
    if target <= 0:
        return geometric()
    if e_cur <= 1.4 * float(tol):
        # the current rung is already ~converged: the smallest honest
        # confirmation step, floored at the 1/c honesty step
        dt = 0.95 * float(tol)
        frac = 1.0 - dt / e_cur if e_cur > dt else 0.0
        step = -math.log(max(frac, math.exp(-3.0))) / c if frac > 0 else 1.0 / c
        step = max(step, 1.0 / c)
    else:
        # far from convergence: jump toward the rung whose predicted error
        # hits the 0.7 tol target, with the cap against garbage fits
        step = math.log(e_cur / target) / c
        cap_mult = 2.5 if len(deltas) >= 3 else 1.5
        step = min(step, max(1.0, cap_mult * (factor - 1.0) * n_k))
    step = max(step, 8.0, 0.02 * n_k)
    nxt = n_k + int(math.ceil(step))
    # quantize up to a multiple of 32 (8 for small rungs): fewer distinct
    # grid shapes, and rounding up only adds certification margin
    q = 32 if nxt >= 256 else 8
    nxt = q * ((nxt + q - 1) // q)
    return min(int(nmax), nxt)


class LorentzianFullGrid(DOSAlgorithm):
    """``LorentzianFullGrid(eta, nmin=50, nmax=2000, factor=sqrt(2))``.

    ``eta``: Lorentzian broadening. The npt ladder grows from ``nmin``
    (geometrically by ``factor`` or, with ``schedule="auto"``, by the
    rate-fitted :func:`next_rung_npt`), capped at ``nmax``, until
    ``max|D_k - D_{k-1}| <= max(abstol, reltol * max|D_k|)``; ``maxiters``
    bounds the total grid points evaluated (budget exhaustion ->
    ``retcode=False``). ``device`` is where the engines compute: the card
    unless the CPU is named. Other keywords go to
    :class:`~autobzcore_torch.ops.grid_sweep.FullGridSpectralSweep`.
    ``mesh`` is accepted; a rung sharded over several cards is ROADMAP A10
    and raises when it would run.

    Requires a 3D ``FourierSeries`` of square Hermitian matrices: m <= 3
    runs kernel K7, other band counts ``torch.linalg.eigvalsh`` and K8.

    Precision: eigenvalues and Lorentzians are native FP64, so rung-to-rung
    deltas bottom out at rounding (~1e-14 * max D), and an ``abstol`` below
    the reference's two-float floor of ~1e-6 * max D can certify.
    """

    def __init__(self, eta, nmin=50, nmax=2000, factor=np.sqrt(2.0), mesh=None,
                 schedule="auto", device="cuda", **engine_kwargs):
        self.eta = float(eta)
        self.nmin = int(nmin)
        self.nmax = int(nmax)
        self.factor = float(factor)
        self.mesh = mesh
        if schedule not in ("auto", "geometric"):
            raise ValueError("schedule must be 'auto' or 'geometric'")
        self.schedule = schedule
        self.device = as_device(device)
        self.engine_kwargs = engine_kwargs

    def _geometric_next(self, npt):
        """Next geometric rung after ``npt``, or None at the cap."""
        return _geometric_step(npt, self.nmax, self.factor)

    def npt_ladder(self):
        npt = self.nmin
        while npt is not None:
            yield npt
            npt = self._geometric_next(npt)

    def init_cacheval(self, h, domain, p):
        if isinstance(h, JacobianSeries):
            h = h.s
        if not isinstance(h, FourierSeries):
            raise TypeError("LorentzianFullGrid requires a FourierSeries Hamiltonian")
        if not isinstance(p, SymmetricBZ):
            raise TypeError("LorentzianFullGrid takes the BZ as the problem parameter")
        if p.ndim != 3 or h.c.ndim != 5 or h.c.shape[-2] != h.c.shape[-1]:
            raise ValueError(
                "LorentzianFullGrid supports 3D series of square Hermitian "
                "matrices (any band count; m <= 3 takes the fused kernel)"
            )
        # engines are built per energy-grid width at solve time and cached,
        # so repeated sweeps over grids of one width reuse one engine
        return {"h": h, "engines": {}}

    def _engine(self, cacheval, Es):
        """One engine per (padded width, eta): ``set_omegas`` swaps grids of
        the same width. Widths above 8 pad to multiples of 32; pad lanes
        repeat the last energy and are sliced off by the caller."""
        Es = np.atleast_1d(np.asarray(Es, np.float64))
        W = Es.size
        if W == 0:
            raise ValueError("empty energy grid")
        Wp = max(32 * ((W + 31) // 32), 1) if W > 8 else W
        Ep = np.concatenate([Es, np.full(Wp - W, Es[-1])])
        key = (Wp, self.eta)
        eng = cacheval["engines"].get(key)
        if eng is None:
            eng = FullGridSpectralSweep(cacheval["h"], Ep, self.eta, device=self.device,
                                        **self.engine_kwargs)
            cacheval["engines"][key] = eng
        else:
            eng.set_omegas(Ep)
        return eng

    def _ladder(self, cacheval, Es, abstol, reltol, maxiters):
        W = np.atleast_1d(np.asarray(Es)).size  # pad lanes sliced off below
        eng = self._engine(cacheval, Es)
        atol = 0.0 if abstol is None else float(abstol)
        rtol = 0.0 if reltol is None else float(reltol)
        if abstol is None and reltol is None:
            atol = 1e-8
        budget = np.inf if maxiters is None else float(maxiters)
        prev = None
        D = None
        err = np.inf
        nev = 0
        npts_done = []
        deltas = []
        # every rung run: its npt, seconds (ending in the rung's host read)
        # and delta to the rung before
        log = cacheval.setdefault("rung_log", [])
        # warm start: a previous converged ladder recorded its certifying
        # pair; the rate is a property of (series, eta), so later sweeps at a
        # comparable tolerance re-certify with those two rungs
        queue = []
        hint = cacheval.get("ladder_hint")
        if hint is not None and atol > 0:
            n1, n2, tol_u = hint
            if tol_u / 4 <= atol <= 64 * tol_u and n2 <= self.nmax and rtol == 0.0:
                queue = [n1, n2]
        npt = queue.pop(0) if queue else self.nmin
        while npt is not None:
            if nev + npt**3 > budget:
                # budget honoured even before the first rung: a NaN curve
                # with retcode=False rather than an overspend by nmin^3
                if prev is None:
                    D = np.full(np.atleast_1d(Es).shape, np.nan)
                return D, err, False, nev
            if self.mesh is not None:
                acc = eng.rung_sharded(npt, self.mesh)
            else:
                t0 = time.perf_counter()
                acc = eng.rung(npt)
                log.append({"npt": npt, "seconds": time.perf_counter() - t0, "delta": None})
            nev += npt**3
            D = acc[:W] / npt**3
            if prev is not None:
                err = float(np.max(np.abs(D - prev)))
                deltas.append(err)
                log[-1]["delta"] = err
                tol_now = max(atol, rtol * float(np.max(np.abs(D))))
                if err <= tol_now:
                    cacheval["ladder_hint"] = (npts_done[-1], npt, tol_now)
                    return D, err, True, nev
            prev = D
            npts_done.append(npt)
            if queue:
                npt = queue.pop(0)
            elif self.schedule == "auto":
                tol_now = max(atol, rtol * float(np.max(np.abs(D))))
                npt = next_rung_npt(npts_done, deltas, tol_now, self.factor, self.nmax)
            else:
                npt = self._geometric_next(npt)
        # reachable only after the in-loop test failed (or never ran) at nmax
        return D, err, False, nev

    def dos_solve(self, h, domain, p, cacheval, abstol=None, reltol=None, maxiters=None):
        """The converged DOS at ``domain`` (a number or an array of
        energies), as a numpy float64 value or array."""
        Es = np.atleast_1d(np.asarray(domain, np.float64))
        D, err, ok, nev = self._ladder(cacheval, Es, abstol, reltol, maxiters)
        val = D[0] if np.ndim(domain) == 0 else D
        return DOSSolution(val, err, bool(ok), int(nev))

    def dos_sweep(self, cacheval, Es, abstol=None, reltol=None, maxiters=None,
                  with_status=False):
        """Converged broadened DOS over a whole energy grid (the ladder's
        convergence test runs on the sup-norm of the full curve), as a numpy
        float64 array. ``with_status=True`` returns ``(D, ok)``."""
        D, err, ok, nev = self._ladder(
            cacheval, np.asarray(Es, np.float64), abstol, reltol, maxiters
        )
        if with_status:
            return D, bool(ok)
        return D
