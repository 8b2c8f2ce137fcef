"""Host-side quadrature rule construction (copied from the reference
``autobzcore_tpu/ops/quad_rules.py``, which imports no JAX).

Native replacement for the rule surfaces the reference consumes from QuadGK.jl
(Gauss-Kronrod nodes/weights of arbitrary order, used at reference
``src/algorithms.jl:83-89``) and from its own ``trapz``
(``src/algorithms.jl:132-140``).  Rule *construction* is irregular scalar work
and stays on host (numpy); rule *application* is dense and runs on device.

Gauss-Kronrod extensions are computed with Laurie's algorithm
[D. P. Laurie, Math. Comp. 66 (1997) 1133] via the mixed-moment recursion as
popularized by Gautschi's OPQ ``kronrod.m``; results are cached per order.
"""
from __future__ import annotations

from functools import lru_cache
from math import ceil, floor

import numpy as np


def trapz(n: int):
    """Trapezoidal rule on [-1, 1]: ``(x, w)`` with sum(w*f(x)) ~ integral
    (reference ``src/algorithms.jl:132-140``)."""
    if n < 2:
        raise ValueError("trapz needs n > 1")
    x = np.linspace(-1.0, 1.0, n)
    h = x[1] - x[0]
    w = np.full(n, h)
    w[0] = w[-1] = h / 2
    return x, w


def gausslegendre(n: int):
    """Gauss-Legendre rule on [-1, 1] (FastGaussQuadrature.jl equivalent,
    cf. reference ``src/algorithms.jl:149-150``)."""
    return np.polynomial.legendre.leggauss(n)


def _legendre_recurrence(m: int):
    """Monic Legendre three-term recurrence coefficients a_k (=0), b_k."""
    a = np.zeros(m)
    b = np.zeros(m)
    b[0] = 2.0
    k = np.arange(1, m, dtype=np.float64)
    b[1:] = k**2 / (4.0 * k**2 - 1.0)
    return a, b


def _kronrod_jacobi(n: int):
    """Jacobi matrix coefficients of the (2n+1)-point Kronrod extension of the
    n-point Gauss-Legendre rule (Laurie's algorithm)."""
    a0, b0 = _legendre_recurrence(ceil(3 * n / 2) + 1)
    a = np.zeros(2 * n + 1)
    b = np.zeros(2 * n + 1)
    a[: floor(3 * n / 2) + 1] = a0[: floor(3 * n / 2) + 1]
    b[: ceil(3 * n / 2) + 1] = b0[: ceil(3 * n / 2) + 1]
    s = np.zeros(floor(n / 2) + 2)
    t = np.zeros(floor(n / 2) + 2)
    t[1] = b[n + 1]
    for m in range(n - 1):
        u = 0.0
        for k in range(floor((m + 1) / 2), -1, -1):
            l = m - k
            u += (a[k + n + 1] - a[l]) * t[k + 1] + b[k + n + 1] * s[k] - b[l] * s[k + 1]
            s[k + 1] = u
        s, t = t, s
    for j in range(floor(n / 2), -1, -1):
        s[j + 1] = s[j]
    for m in range(n - 1, 2 * n - 2):
        u = 0.0
        j = 0
        for k in range(m + 1 - n, floor((m - 1) / 2) + 1):
            l = m - k
            j = n - 1 - l
            u -= (a[k + n + 1] - a[l]) * t[j + 1] + b[k + n + 1] * s[j + 1] - b[l] * s[j + 2]
            s[j + 1] = u
        if m % 2 == 0:
            k = m // 2
            a[k + n + 1] = a[k] + (s[j + 1] - b[k + n + 1] * s[j + 2]) / t[j + 2]
        else:
            k = (m + 1) // 2
            b[k + n + 1] = s[j + 1] / s[j + 2]
        s, t = t, s
    a[2 * n] = a[n - 1] - b[2 * n] * s[1] / t[1]
    return a, b


def _golub_welsch(a, b):
    """Nodes/weights from a Jacobi matrix (b[0] = total weight)."""
    J = np.diag(a) + np.diag(np.sqrt(b[1:]), 1) + np.diag(np.sqrt(b[1:]), -1)
    x, V = np.linalg.eigh(J)
    w = b[0] * V[0, :] ** 2
    return x, w


@lru_cache(maxsize=None)
def kronrod(n: int):
    """(2n+1)-point Gauss-Kronrod rule embedding the n-point Gauss rule.

    Returns ``(xk, wk, wg)``: Kronrod nodes (ascending), Kronrod weights, and
    the embedded Gauss weights aligned with ``xk`` (zero at Kronrod-only
    nodes).  The n=7 instance is the reference's default 15-point kernel
    (``src/algorithms.jl:17``).
    """
    a, b = _kronrod_jacobi(n)
    xk, wk = _golub_welsch(a, b)
    xg, wg_g = np.polynomial.legendre.leggauss(n)
    wg = np.zeros_like(wk)
    # embedded Gauss nodes sit at the odd-indexed Kronrod nodes
    for xi, wi in zip(xg, wg_g):
        j = int(np.argmin(np.abs(xk - xi)))
        if abs(xk[j] - xi) > 1e-10:
            raise RuntimeError("Kronrod extension failed to embed Gauss nodes")
        wg[j] = wi
    return xk, wk, wg
