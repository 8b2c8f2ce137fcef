"""Meta-algorithms: AbsoluteEstimate and EvalCounter (reference
``autobzcore_tpu/algorithms/meta.py``).

Every driver of the port counts its integrand evaluations in its loop state,
so ``EvalCounter`` only surfaces the count of the algorithm it wraps.
``AbsoluteEstimate`` solves twice: a cheap estimate, then the absolute solve
at ``abstol = max(abstol, reltol |I|)``; both phases count. Its lane form
(sweeps) gives each lane its own tolerance from its own estimate.
"""
from __future__ import annotations

import math

import torch

from .._device import REAL
from ..interfaces import IntegralSolution, checkkwargs
from ..parameters import LaneParams
from ..utils.tree import tree_leaves, tree_norm
from .base import IntegralAlgorithm, effective_tolerances

_SQRT_EPS = math.sqrt(torch.finfo(REAL).eps)


def lane_solve_fn(alg, cacheval):
    """``fn(params (LaneParams), atol, rtol) -> (u (L, ...), resid, converged
    (L,), numevals (L,))`` for any algorithm: the lane form of one that
    solves lanes independently, else one solve over the lanes' parameter
    vector (a fixed rule's), its certificate spread over the lanes."""
    if getattr(alg, "solves_lanes", False):
        return alg.solve_fn(cacheval, lanes=True)
    fn = alg.solve_fn(cacheval, lanes=True)

    def lanes(params, atol, rtol):
        u, e, conv, ne = fn(params.merged(), atol, rtol)
        L = 1 if params.x is None else params.x.shape[0]
        dev = tree_leaves(u)[0].device
        if params.x is None:
            u = tree_leaves(u)[0][None]
        full = lambda v, dt: torch.as_tensor(v, dtype=dt, device=dev).expand(L)  # noqa: E731
        return u, full(e, REAL), full(conv, torch.bool), full(ne, REAL)

    return lanes


class AbsoluteEstimate(IntegralAlgorithm):
    """Two-phase: a cheap estimate under ``est_alg`` (with the kwargs given at
    construction), then ``abs_alg`` at ``abstol = max(abstol, reltol *
    norm(I))``, ``reltol = 0`` (reference ``AbsoluteEstimate``). An unset
    reltol is sqrt(eps)."""

    solves_lanes = True

    def __init__(self, est_alg, abs_alg, norm=tree_norm, **kwargs):
        checkkwargs(kwargs)
        self.est_alg = est_alg
        self.abs_alg = abs_alg
        self.norm = norm
        self.kwargs = kwargs

    def init_cacheval(self, f, dom, p):
        if self.norm is not tree_norm:
            raise NotImplementedError("custom norms are not ported yet (ROADMAP A5)")
        from ..parallel.sweep import _find

        est = self.est_alg.init_cacheval(f, dom, p)
        ab = self.abs_alg.init_cacheval(f, dom, p)
        return {"est": est, "abs": ab, "device": _find(ab, "device"), "stats": _find(ab, "stats")}

    def do_solve(self, f, dom, p, cacheval, abstol=None, reltol=None, maxiters=None):
        sol = self.est_alg.do_solve(f, dom, p, cacheval["est"], **self.kwargs)
        val = float(self.norm(sol.u))
        rtol = _SQRT_EPS if reltol is None else reltol
        atol = max(0.0 if abstol is None else abstol, rtol * val)
        out = self.abs_alg.do_solve(f, dom, p, cacheval["abs"], abstol=atol, reltol=0.0,
                                    maxiters=maxiters)
        # both phases evaluate the integrand: count both (uncounted phases
        # keep the -1 of "not counted")
        if out.numevals >= 0 and sol.numevals >= 0:
            out = IntegralSolution(out.u, out.resid, out.retcode, out.numevals + sol.numevals)
        return out

    def solve_fn(self, cacheval, lanes=False):
        """fn(p, atol, rtol) -> (u, resid, converged, numevals), the two
        phases in one call (reference ``solve_fn_consts``): each lane's
        estimate sets its absolute tolerance. A sweep passes an unset reltol
        as 0, which takes the sqrt(eps) floor here, as in the reference."""
        est_fn = lane_solve_fn(self.est_alg, cacheval["est"])
        abs_fn = lane_solve_fn(self.abs_alg, cacheval["abs"])
        est_atol, est_rtol = effective_tolerances(self.kwargs.get("abstol"), self.kwargs.get("reltol"))

        def fn(p, atol, rtol):
            params = p if lanes else LaneParams(p)
            u_est, _, _, ne_est = est_fn(params, est_atol, est_rtol)
            u_est = tree_leaves(u_est)[0]
            norm = torch.sqrt(torch.sum(torch.abs(u_est.reshape(u_est.shape[0], -1)) ** 2, dim=1))
            rtol_eff = rtol if rtol > 0 else _SQRT_EPS
            atol2 = torch.clamp(rtol_eff * norm.to(REAL), min=float(atol))
            u, e, conv, ne = abs_fn(params, atol2, 0.0)
            ne = ne + ne_est.to(ne.device)
            if lanes:
                return u, e, conv, ne
            return u[0], e[0], bool(conv[0]), int(ne[0])

        return fn


class EvalCounter(IntegralAlgorithm):
    """Surface the wrapped algorithm's integrand evaluation count in
    ``sol.numevals`` (reference ``EvalCounter``)."""

    def __init__(self, alg):
        self.alg = alg

    @property
    def solves_lanes(self):
        return getattr(self.alg, "solves_lanes", False)

    def init_cacheval(self, f, dom, p):
        return self.alg.init_cacheval(f, dom, p)

    def do_solve(self, f, dom, p, cacheval, **kwargs):
        return self.alg.do_solve(f, dom, p, cacheval, **kwargs)

    def solve_fn(self, cacheval, lanes=False):
        return self.alg.solve_fn(cacheval, lanes)

    def solve_fn_consts(self, cacheval, lanes=False):
        return self.alg.solve_fn_consts(cacheval, lanes)
