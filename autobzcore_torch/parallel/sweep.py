"""Parameter sweeps (reference ``autobzcore_tpu/parallel/sweep.py``).

Two forms, by algorithm:

- **Fixed rules (PTR).** Where the reference vmaps one solve per parameter,
  the port hands a whole chunk of parameters to ONE solve as a lane vector:
  a ``(W,)`` frequency tensor reaches the PTR rule, which broadcasts over it
  the way the reference's frequency-block solves do (``dos_trace`` returns
  one value per lane, and kernel K2 sums all lanes in one launch).
  Integrands swept this way must broadcast over a leading parameter axis. A
  fixed rule converges every lane, and ``numevals`` counts the rule's points
  once per real (non-pad) lane.
- **Adaptive solvers (IAI, NestedQuad, QuadGKJL; ``solves_lanes``).** Each
  parameter is one independent solve. A chunk's solves run as lanes of one
  batched pool, each lane with its own pools, convergence and count, so each
  value, residual, retcode and ``numevals`` equal the solve alone (the
  reference's ``scan`` sequences them, its plain sweep vmaps them; cold
  solves give the same per-lane results either way). Pad lanes are not
  solved.

Either way ``numevals`` sums the real lanes and ``retcode`` is their AND, so
a sweep's totals equal the reference's exactly.

Not ported yet: ``warm``/``block``/``group`` sweeps (ROADMAP A5, the IAI
warm slice), ``mesh`` sharding (ROADMAP A10) and the AutoPTR ladder
(ROADMAP A4).
"""
from __future__ import annotations

import numpy as np
import torch

from ..algorithms.base import effective_tolerances
from ..interfaces import IntegralProblem, _takes_mixed_parameters, init
from ..parameters import LaneParams, MixedParameters, merge_parameters
from ..utils.tree import tree_leaves, tree_map


def _solve_fn_with_consts(prob, alg, cache):
    """(fn(consts, p, atol, rtol), consts) for lane-vector parameters, with
    integrand-preset parameters merged in."""
    fnc, consts = alg.solve_fn_consts(cache.cacheval, lanes=True)
    if _takes_mixed_parameters(prob.f):
        preset = cache.p

        def fn2(consts, p, atol, rtol):
            return fnc(consts, merge_parameters(preset, p), atol, rtol)

        return fn2, consts
    return fnc, consts


def _check_sweep_knobs(mesh=None, warm=False, block=1, group=1):
    if mesh is not None:
        raise NotImplementedError("mesh-sharded sweeps are not ported yet (ROADMAP A10)")
    if warm or int(block) != 1 or int(group) != 1:
        raise NotImplementedError(
            "warm, block and group sweeps are not ported yet (ROADMAP A5, IAI warm slice)")


def _find(cacheval, key):
    """The entry ``key`` of a cacheval, looking through BZ wrappers'
    ``"inner"`` entries; None where there is none."""
    while isinstance(cacheval, dict):
        if key in cacheval:
            return cacheval[key]
        cacheval = cacheval.get("inner")
    return None


def _lane_values(ps):
    """The (n,) float64 lane vector of sweep parameters ``ps``: an array or
    tensor, or a MixedParameters holding one."""
    if isinstance(ps, MixedParameters):
        if len(ps.args) != 1 or ps.kwargs:
            raise NotImplementedError("independent-lane sweeps take one swept value per lane "
                                      "(ROADMAP A5)")
        ps = ps.args[0]
    x = ps if isinstance(ps, torch.Tensor) else torch.as_tensor(np.asarray(ps, dtype=np.float64))
    if x.ndim != 1:
        raise NotImplementedError("independent-lane sweeps take one swept number per lane "
                                  "(ROADMAP A5)")
    return x.to(torch.float64)


def sweep_solve(prob: IntegralProblem, alg, ps, abstol=None, reltol=None, mesh=None):
    """Solve ``prob`` at every parameter of ``ps`` (a tensor or array, or a
    MixedParameters of them, with the sweep axis leading) in one solve.

    Returns ``(us, resids, converged, numevals)`` with the sweep axis
    leading."""
    _check_sweep_knobs(mesh=mesh)
    cache = init(prob, alg)
    atol, rtol = effective_tolerances(abstol, reltol)
    if getattr(alg, "solves_lanes", False):
        fn = alg.solve_fn(cache.cacheval, lanes=True)
        params = LaneParams(cache.p, _lane_values(ps), _takes_mixed_parameters(prob.f))
        u, resid, conv, ne = fn(params, atol, rtol)
        return u, resid.cpu().numpy(), conv.cpu().numpy(), ne.cpu().numpy().astype(np.int64)
    fn2, consts = _solve_fn_with_consts(prob, alg, cache)
    n = int(np.shape(tree_leaves(ps.args + tuple(ps.kwargs.values()))[0]
                     if isinstance(ps, MixedParameters) else ps)[0])
    u, resid, conv, ne = fn2(consts, ps, atol, rtol)
    return (u, np.full(n, float(resid)), np.full(n, bool(conv)), np.full(n, int(ne)))


class SweepSolver:
    """Reusable parameter sweep in fixed-size chunks.

    Parameters are single numbers; for FourierIntegrand/ParameterIntegrand
    problems each is merged as the next positional argument. For a fixed
    rule, inputs are padded to a multiple of ``chunk`` with the last value
    and each chunk is one solve over a ``(chunk,)`` lane vector; for an
    adaptive solver each chunk's real parameters are independent solves run
    as lanes of one batched pool (``scan`` is accepted either way: cold
    solves give the same per-lane results in sequence or in lockstep).

    After each call ``self.retcode`` is True iff every real parameter's solve
    converged, and ``self.numevals`` has accumulated the integrand
    evaluations of the real lanes (pad lanes are not counted). For nested
    solvers ``self.stats`` holds the trips of each level and the host syncs
    (:class:`~autobzcore_torch.ops.adaptive.LoopStats`), and for adaptive
    solvers ``self.lane_numevals`` the last call's count of each parameter.
    """

    def __init__(self, prob, alg, abstol=None, reltol=None, chunk=256, mesh=None,
                 scan=False, group=1, warm=False, block=1):
        _check_sweep_knobs(mesh=mesh, warm=warm, block=block, group=group)
        cache = init(prob, alg)
        self.numevals = 0
        self.retcode = None  # set by __call__
        self.lane_numevals = None
        self.chunk = int(chunk)
        self.scan = bool(scan)
        self._atol, self._rtol = effective_tolerances(abstol, reltol)
        self._lanes = getattr(alg, "solves_lanes", False)
        if self._lanes:
            self._fn = alg.solve_fn(cache.cacheval, lanes=True)
            self._p, self._merge = cache.p, _takes_mixed_parameters(prob.f)
        else:
            self._fn, self._consts = _solve_fn_with_consts(prob, alg, cache)
        self._wrap = MixedParameters if _takes_mixed_parameters(prob.f) else (lambda x: x)
        self.device = _find(cache.cacheval, "device") or torch.device("cpu")
        self.stats = _find(cache.cacheval, "stats")

    def __call__(self, xs):
        xs = np.asarray(xs.cpu() if isinstance(xs, torch.Tensor) else xs, dtype=np.float64)
        n = xs.shape[0]
        if n == 0:
            self.retcode = True
            return np.zeros((0,))
        c = self.chunk
        if self._lanes:
            return self._solve_lanes(xs, n, c)
        npad = -(-n // c) * c
        # pad with the last real value, not 0.0, as the reference does
        xp = np.full(npad, xs[n - 1])
        xp[:n] = xs
        outs, convs = [], []
        for i in range(0, npad, c):
            x = torch.as_tensor(xp[i:i + c], device=self.device)
            u, _, conv, ne = self._fn(self._consts, self._wrap(x), self._atol, self._rtol)
            outs.append(u)
            convs.append(bool(conv))
            self.numevals += int(ne) * min(c, n - i)
        self.retcode = all(convs)
        return tree_map(lambda *vs: torch.cat(vs)[:n].cpu().numpy(), *outs)

    def _solve_lanes(self, xs, n, c):
        outs, convs, counts = [], [], []
        for i in range(0, n, c):
            x = torch.as_tensor(xs[i:i + c], device=self.device)
            u, _, conv, ne = self._fn(LaneParams(self._p, x, self._merge), self._atol, self._rtol)
            outs.append(u)
            convs.append(bool(torch.all(conv)))
            counts.append(ne.cpu().numpy().astype(np.int64))
        self.lane_numevals = np.concatenate(counts)
        self.numevals += int(self.lane_numevals.sum())
        self.retcode = all(convs)
        return tree_map(lambda *vs: torch.cat(vs).cpu().numpy(), *outs)
