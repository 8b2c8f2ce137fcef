"""Problem/solver interface (reference ``autobzcore_tpu/interfaces.py``).

``init`` builds an algorithm's rule data once (for a PTR rule: the points,
weights and the series values at the points, on the rule's device) and
``solve_`` reuses it at new parameters.
"""
from __future__ import annotations

from dataclasses import dataclass
from typing import Any

from .parameters import MixedParameters, NullParameters, ParameterIntegrand


@dataclass
class IntegralSolution:
    """``u``: the integral; ``resid``: error estimate (or None); ``retcode``:
    converged flag; ``numevals``: integrand evaluations (-1 = not counted)."""

    u: Any
    resid: Any
    retcode: bool
    numevals: int = -1


class IntegralProblem:
    """``IntegralProblem(f, dom[, p])``: integrand ``f(x, p)``, domain and
    parameters."""

    def __init__(self, f, dom, p=NullParameters()):
        self.f = f
        self.dom = dom
        self.p = p


_ALLOWED_KWARGS = ("abstol", "reltol", "maxiters")


def checkkwargs(kwargs):
    for key in kwargs:
        if key not in _ALLOWED_KWARGS:
            raise ValueError(f"keyword {key} unrecognized (allowed: {_ALLOWED_KWARGS})")


class IntegralCache:
    """Reusable solve state: problem data, the algorithm's cacheval and the
    solver kwargs."""

    def __init__(self, f, dom, p, alg, cacheval, kwargs):
        self.f = f
        self.dom = dom
        self.p = p
        self.alg = alg
        self.cacheval = cacheval
        self.kwargs = kwargs


def init(prob: IntegralProblem, alg, **kwargs) -> IntegralCache:
    """Build a reusable cache for the problem/algorithm pair; kwargs are
    ``abstol``/``reltol``/``maxiters``."""
    checkkwargs(kwargs)
    f, p = _resolve_parameters(prob.f, prob.p)
    cacheval = alg.init_cacheval(f, prob.dom, p)
    return IntegralCache(f, prob.dom, p, alg, cacheval, kwargs)


def solve(prob: IntegralProblem, alg, **kwargs) -> IntegralSolution:
    """One-shot ``init`` + ``solve_``."""
    return solve_(init(prob, alg, **kwargs))


def solve_(cache: IntegralCache) -> IntegralSolution:
    """Compute the solution from an initialized cache."""
    return cache.alg.do_solve(cache.f, cache.dom, cache.p, cache.cacheval, **cache.kwargs)


class IntegralSolver:
    """Functor ``solver(p) -> u``. For :class:`ParameterIntegrand` and
    ``FourierIntegrand`` integrands the call is ``solver(*args, **kwargs)``
    and the parameters merge with the integrand's preset ones."""

    def __init__(self, f, dom, alg, **kwargs):
        checkkwargs(kwargs)
        self.f = f
        self.dom = dom
        self.alg = alg
        self.kwargs = kwargs
        self.cache = None

    def solve_p(self, p) -> IntegralSolution:
        if self.cache is None:
            self.cache = init(IntegralProblem(self.f, self.dom, p), self.alg, **self.kwargs)
            return solve_(self.cache)
        _, self.cache.p = _resolve_parameters(self.f, p)
        return solve_(self.cache)

    def __call__(self, *args, **kwargs):
        if _takes_mixed_parameters(self.f):
            p = MixedParameters(*args, **kwargs)
        else:
            if kwargs or len(args) > 1:
                raise TypeError("plain integrands take a single parameter argument")
            p = args[0] if args else NullParameters()
        return self.solve_p(p).u


def _takes_mixed_parameters(f):
    from .fourier import FourierIntegrand

    return isinstance(f, (ParameterIntegrand, FourierIntegrand))


def _resolve_parameters(f, p):
    """Merge integrand-preset parameters with solve-time ones."""
    if _takes_mixed_parameters(f):
        return f.with_parameters(p)
    return f, p
