"""Parameter sweeps (reference ``autobzcore_tpu/parallel/sweep.py``).

Where the reference vmaps one solve per parameter, the port hands a whole
chunk of parameters to ONE solve as a lane vector: a ``(W,)`` frequency
tensor reaches the PTR rule, which broadcasts over it the way the
reference's frequency-block solves do (``dos_trace`` returns one value per
lane, and kernel K2 sums all lanes in one launch). Integrands swept this way
must broadcast over a leading parameter axis.

Certificates keep the reference's per-lane contract: a fixed rule converges
every lane, and ``numevals`` counts the rule's points once per real
(non-pad) lane, so a sweep's total equals the reference's exactly.

Not ported yet: ``scan``/``warm``/``block`` sweeps (ROADMAP A5), ``mesh``
sharding (ROADMAP A10) and the AutoPTR ladder (ROADMAP A4).
"""
from __future__ import annotations

import numpy as np
import torch

from ..algorithms.base import effective_tolerances
from ..interfaces import IntegralProblem, _takes_mixed_parameters, init
from ..parameters import MixedParameters, merge_parameters
from ..utils.tree import tree_leaves, tree_map


def _rule_device(cacheval):
    """Device of the rule's data, which the PTR cacheval records; BZ
    wrappers nest their inner cacheval under ``"inner"``."""
    while isinstance(cacheval, dict):
        if "device" in cacheval:
            return cacheval["device"]
        cacheval = cacheval.get("inner")
    return torch.device("cpu")


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


def _check_sweep_knobs(mesh=None, scan=False, warm=False, block=1):
    if mesh is not None:
        raise NotImplementedError("mesh-sharded sweeps are not ported yet (ROADMAP A10)")
    if scan or warm or int(block) != 1:
        raise NotImplementedError(
            "scan/warm/block sweeps belong to the IAI slice, not ported yet (ROADMAP A5)")


def sweep_solve(prob: IntegralProblem, alg, ps, abstol=None, reltol=None, mesh=None):
    """Solve ``prob`` at every parameter of ``ps`` (a tensor or array, or a
    MixedParameters of them, with the sweep axis leading) in one solve.

    Returns ``(us, resids, converged, numevals)`` with the sweep axis
    leading."""
    _check_sweep_knobs(mesh=mesh)
    cache = init(prob, alg)
    fn2, consts = _solve_fn_with_consts(prob, alg, cache)
    atol, rtol = effective_tolerances(abstol, reltol)
    n = int(np.shape(tree_leaves(ps.args + tuple(ps.kwargs.values()))[0]
                     if isinstance(ps, MixedParameters) else ps)[0])
    u, resid, conv, ne = fn2(consts, ps, atol, rtol)
    return (u, np.full(n, float(resid)), np.full(n, bool(conv)), np.full(n, int(ne)))


class SweepSolver:
    """Reusable parameter sweep in fixed-size chunks.

    Inputs are padded to a multiple of ``chunk`` with the last value, and
    each chunk is one solve over a ``(chunk,)`` lane vector. Parameters are
    single numbers; for FourierIntegrand/ParameterIntegrand problems each
    chunk is merged as the next positional argument.

    After each call ``self.retcode`` is True iff every real parameter's solve
    converged, and ``self.numevals`` has accumulated the integrand
    evaluations of the real lanes (pad lanes are not counted).
    """

    def __init__(self, prob, alg, abstol=None, reltol=None, chunk=256, mesh=None,
                 scan=False, warm=False, block=1):
        _check_sweep_knobs(mesh=mesh, scan=scan, warm=warm, block=block)
        cache = init(prob, alg)
        self.numevals = 0
        self.retcode = None  # set by __call__
        self.chunk = int(chunk)
        self._fn, self._consts = _solve_fn_with_consts(prob, alg, cache)
        self._atol, self._rtol = effective_tolerances(abstol, reltol)
        self._wrap = MixedParameters if _takes_mixed_parameters(prob.f) else (lambda x: x)
        self.device = _rule_device(cache.cacheval)

    def __call__(self, xs):
        xs = np.asarray(xs.cpu() if isinstance(xs, torch.Tensor) else xs, dtype=np.float64)
        n = xs.shape[0]
        if n == 0:
            self.retcode = True
            return np.zeros((0,))
        c = self.chunk
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
