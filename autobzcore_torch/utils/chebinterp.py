"""h-adaptive Chebyshev interpolation (HChebInterp.jl equivalent).

The reference's aps_example builds its DOS curve with ``hchebinterp(solver,
10, 15; atol=1e-2)`` (``aps_example/aps_example.jl:41-42``): adaptively
bisect the interval, interpolating with Chebyshev polynomials until the
interpolant matches the function to ``atol``.

Each refinement round gathers the Chebyshev nodes of *all* pending panels
into one batched call, so the function (usually a parameter sweep) evaluates
the whole frontier at once, where the reference evaluates solver calls
serially. This module is numpy only and is shared in content (not imported)
with ``autobzcore_tpu/utils/chebinterp.py``.
"""
from __future__ import annotations

import numpy as np


def _cheb_nodes(order):
    """Chebyshev-Lobatto points on [-1, 1], ascending."""
    return -np.cos(np.pi * np.arange(order + 1) / order)


def _cheb_coeffs(vals):
    """Chebyshev coefficients from values at *ascending* Lobatto points (DCT-I).

    The DCT ordering expects values at angles theta_j = pi j / n, i.e. x
    descending from +1 to -1, so reverse first.
    """
    vals = vals[::-1]
    n = len(vals) - 1
    ext = np.concatenate([vals, vals[-2:0:-1]])
    c = np.real(np.fft.fft(ext)) / n if np.isrealobj(vals) else np.fft.fft(ext) / n
    coef = c[: n + 1].copy()
    coef[0] /= 2
    coef[-1] /= 2
    return coef


class ChebPanel:
    __slots__ = ("a", "b", "coef")

    def __init__(self, a, b, coef):
        self.a = a
        self.b = b
        self.coef = coef


class ChebInterp:
    """Piecewise Chebyshev interpolant, callable on scalars or arrays."""

    def __init__(self, panels):
        self.panels = sorted(panels, key=lambda p: p.a)
        self._edges = np.array([p.a for p in self.panels] + [self.panels[-1].b])

    def __call__(self, x):
        x = np.asarray(x, dtype=float)
        scalar = x.ndim == 0
        xf = np.atleast_1d(x)
        idx = np.clip(np.searchsorted(self._edges, xf, side="right") - 1, 0, len(self.panels) - 1)
        out = np.empty(xf.shape, dtype=self.panels[0].coef.dtype)
        for i in np.unique(idx):
            p = self.panels[i]
            sel = idx == i
            t = 2 * (xf[sel] - p.a) / (p.b - p.a) - 1
            out[sel] = np.polynomial.chebyshev.chebval(t, p.coef)
        return out[0] if scalar else out


def hchebinterp(f, a, b, atol=1e-6, rtol=0.0, order=16, max_panels=2000, initdiv=1):
    """Adaptively interpolate ``f`` on [a, b] to absolute tolerance ``atol``.

    ``f`` must accept an array of points and return an array of values (a
    vmapped solver sweep does).  Error estimate per panel: interpolate at
    order ``order``, check against fresh evaluations at order ``2*order``
    nodes (which become the children's data on split).
    """
    nodes_hi = _cheb_nodes(2 * order)
    pending = []
    width = (b - a) / initdiv
    for i in range(initdiv):
        pending.append((a + i * width, a + (i + 1) * width))
    accepted = []
    fcount = 0

    while pending:
        if len(accepted) + len(pending) > max_panels:
            raise RuntimeError("hchebinterp: panel budget exhausted")
        # one batched evaluation for the whole frontier
        xs = np.concatenate(
            [pa + (pb - pa) * (nodes_hi + 1) / 2 for pa, pb in pending]
        )
        vals = np.asarray(f(xs))
        fcount += len(xs)
        nxt = []
        for k, (pa, pb) in enumerate(pending):
            v = vals[k * len(nodes_hi): (k + 1) * len(nodes_hi)]
            coef_hi = _cheb_coeffs(v)
            coef_lo = coef_hi[: order + 1]
            # error = tail energy of the degree-2n expansion
            err = np.sum(np.abs(coef_hi[order + 1:])) + abs(coef_hi[order])
            tol = max(atol, rtol * np.max(np.abs(v)))
            if err <= tol or (pb - pa) < 1e-12 * (b - a):
                accepted.append(ChebPanel(pa, pb, coef_lo))
            else:
                mid = (pa + pb) / 2
                nxt.extend([(pa, mid), (mid, pb)])
        pending = nxt

    interp = ChebInterp(accepted)
    interp.numevals = fcount
    return interp
