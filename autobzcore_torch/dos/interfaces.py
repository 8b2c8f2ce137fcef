"""Density-of-states problem family (reference
``autobzcore_tpu/dos/interfaces.py``).

``DOSProblem`` for ``D(E) = sum_k sum_lambda delta(E - lambda(H(k)))``, the
mutable ``DOSCache`` with ``isfresh`` invalidation when ``H`` is replaced,
and the ``init``/``solve``/``solve_`` verbs. An interval domain ``(lo,
hi)`` is interpolated adaptively by ``hchebinterp``.
"""
from __future__ import annotations

import inspect
from dataclasses import dataclass
from typing import Any

import numpy as np

from ..interfaces import checkkwargs
from ..parameters import NullParameters
from ..utils.chebinterp import hchebinterp


class DOSAlgorithm:
    def init_cacheval(self, h, domain, p):
        return None

    def dos_solve(self, h, domain, p, cacheval, abstol=None, reltol=None, maxiters=None):
        raise NotImplementedError


class DOSProblem:
    """Density-of-states problem: operator ``H(p)``, spectral ``domain``,
    parameters ``p``."""

    def __init__(self, H, domain, p=NullParameters()):
        self.H = H
        self.domain = domain
        self.p = p


@dataclass
class DOSSolution:
    u: Any
    err: Any
    retcode: bool
    numevals: int = -1


class DOSCache:
    """Mutable cache; assigning ``cache.H`` marks it stale so the next
    ``solve_`` rebuilds the spectral data."""

    def __init__(self, H, domain, p, alg, cacheval, kwargs):
        object.__setattr__(self, "isfresh", False)
        object.__setattr__(self, "H", H)
        self.domain = domain
        self.p = p
        self.alg = alg
        self.cacheval = cacheval
        self.kwargs = kwargs

    def __setattr__(self, name, value):
        if name == "H":
            object.__setattr__(self, "isfresh", True)
        object.__setattr__(self, name, value)


def init(prob: DOSProblem, alg: DOSAlgorithm, **kwargs) -> DOSCache:
    checkkwargs(kwargs)
    cacheval = alg.init_cacheval(prob.H, prob.domain, prob.p)
    return DOSCache(prob.H, prob.domain, prob.p, alg, cacheval, kwargs)


def solve(prob: DOSProblem, alg: DOSAlgorithm, **kwargs) -> DOSSolution:
    return solve_(init(prob, alg, **kwargs))


def solve_(cache: DOSCache) -> DOSSolution:
    if cache.isfresh:
        cache.cacheval = cache.alg.init_cacheval(cache.H, cache.domain, cache.p)
        object.__setattr__(cache, "isfresh", False)
    if isinstance(cache.domain, tuple) and len(cache.domain) == 2:
        return _interval_solve(cache)
    return cache.alg.dos_solve(cache.H, cache.domain, cache.p, cache.cacheval, **cache.kwargs)


def _interval_solve(cache: DOSCache) -> DOSSolution:
    """Interval spectral domain ``(lo, hi)``: adaptively Chebyshev-interpolate
    the DOS curve over the interval and return the interpolant as ``sol.u``,
    a callable with a certified sup-norm error ``<= abstol``. Frontiers go
    through the algorithm's ``dos_sweep`` when it has one (one batched call
    per refinement round), else through pointwise ``dos_solve``."""
    lo, hi = (float(x) for x in cache.domain)
    kwargs = dict(cache.kwargs)
    atol = kwargs.get("abstol")
    atol = 1e-2 if atol is None else float(atol)
    alg, cv = cache.alg, cache.cacheval

    status = {"ok": True}
    sweep = getattr(alg, "dos_sweep", None)
    # the certificate is |interpolant - true DOS| <= atol: when the frontier
    # solver honours abstol (its sweep takes one), split the budget between
    # the two error sources; fixed-grid sweeps get it all for interpolation
    honors_abstol = (
        sweep is not None
        and "abstol" in inspect.signature(sweep).parameters
    )
    atol_interp = atol / 2 if honors_abstol else atol
    if honors_abstol:
        kwargs["abstol"] = atol / 2
    if sweep is not None:
        params = inspect.signature(sweep).parameters
        extra = {k: v for k, v in kwargs.items() if k in params}
        if "with_status" in params:
            extra["with_status"] = True

        def frontier(xs):
            out = sweep(cv, np.asarray(xs, np.float64), **extra)
            if "with_status" in params:
                out, ok = out
                status["ok"] = status["ok"] and bool(ok)
            return np.asarray(out)
    else:
        def frontier(xs):
            sols = [alg.dos_solve(cache.H, float(x), cache.p, cv, **kwargs)
                    for x in np.asarray(xs)]
            for s in sols:
                status["ok"] = status["ok"] and bool(s.retcode)
            return np.array([float(s.u) for s in sols])

    def checked_frontier(xs):
        D = frontier(xs)
        # a truncated ladder can return NaN (budget before the first rung);
        # zero-fill so hchebinterp terminates: retcode=False already marks
        # the interpolant uncertified
        if np.any(np.isnan(D)):
            status["ok"] = False
            D = np.nan_to_num(D)
        return D

    interp = hchebinterp(checked_frontier, lo, hi, atol=atol_interp)
    ok = status["ok"]
    return DOSSolution(interp, atol if ok else np.inf, ok, interp.numevals)
