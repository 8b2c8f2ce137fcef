"""Adaptive 1D Gauss-Kronrod algorithms (reference
``autobzcore_tpu/algorithms/gk.py``).

``QuadGKJL`` and ``AuxQuadGKJL`` run the lane-batched interval pool of
:mod:`autobzcore_torch.ops.adaptive`, with one lane per solve, including the
reference's infinite-limit variable transformations. Inside a
:class:`~autobzcore_torch.algorithms.nested.NestedQuad` they only name each
level's rule order, cap and bisection width.
"""
from __future__ import annotations

import numpy as np
import torch

from .._device import REAL, as_device
from ..interfaces import IntegralSolution
from ..ops.adaptive import (_as_eval_budget, gk_adaptive_lanes, gk_nodes, gk_rule, pool_kernels,
                            scatter_lanes)
from ..parameters import LaneParams
from ..utils.tree import tree_norm
from ..wrappers import BatchIntegrand, InplaceIntegrand
from .base import IntegralAlgorithm, effective_tolerances, segments_of


def _budget(maxiters):
    """Evaluation budget as a float (the pools' float64 counters)."""
    return _as_eval_budget(maxiters)


def _infinity_transform(segs):
    """Map (semi-)infinite segments to finite ones, quadgk-style.

    Both ends infinite: x = t/(1-t^2) over (-1, 1); right-infinite [a, inf):
    x = a + t/(1-t) over [0, 1); left-infinite mirrored. Returns
    (finite_segs, map_fn, jac_fn) or None when all endpoints are finite.
    """
    segs = np.asarray(segs, dtype=np.float64)
    if np.all(np.isfinite(segs)):
        return None
    if len(segs) != 2:
        raise ValueError("infinite domains support a single segment")
    a, b = segs
    # reversed orientations: transform the ascending domain and negate the
    # jacobian (int_a^b = -int_b^a)
    if (np.isinf(a) and a > 0) or (np.isinf(b) and b < 0):
        fsegs, map_fn, jac_fn = _infinity_transform(np.array([b, a]))
        return fsegs, map_fn, (lambda t, _j=jac_fn: -_j(t))
    if np.isinf(a) and np.isinf(b):
        return (
            np.array([-1.0 + 1e-15, 1.0 - 1e-15]),
            lambda t: t / (1 - t**2),
            lambda t: (1 + t**2) / (1 - t**2) ** 2,
        )
    if np.isinf(b):
        return (
            np.array([0.0, 1.0 - 1e-15]),
            lambda t: a + t / (1 - t),
            lambda t: 1 / (1 - t) ** 2,
        )
    return (
        np.array([0.0, 1.0 - 1e-15]),
        lambda t: b - t / (1 - t),
        lambda t: 1 / (1 - t) ** 2,
    )


class QuadGKJL(IntegralAlgorithm):
    """h-adaptive Gauss-Kronrod (order 2n+1) on the interval pool; the
    reference wrapper over ``quadgk``. ``device`` places a standalone solve's
    pool (the card by default; resolved when a solve is set up); inside a
    nest the nest's device holds."""

    solves_lanes = True

    def __init__(self, order=7, norm=tree_norm, cap=2048, nbisect=4, device="cuda"):
        self.order = order
        self.norm = norm
        self.cap = cap
        self.nbisect = nbisect
        self.device = device

    def init_cacheval(self, f, dom, p):
        if self.norm is not tree_norm:
            raise NotImplementedError("custom norms are not ported yet: the pools use the 2-norm "
                                      "(ROADMAP A5)")
        segs = np.asarray(segments_of(dom), dtype=np.float64)
        tf = _infinity_transform(segs)
        map_fn = jac_fn = None
        if tf is not None:
            segs, map_fn, jac_fn = tf
        if isinstance(f, BatchIntegrand):
            point_f, batch = None, f.f
        else:
            point_f, batch = (f.to_pure() if isinstance(f, InplaceIntegrand) else f), None
        return {"segs": segs, "map": map_fn, "jac": jac_fn, "f": point_f, "batch": batch,
                "device": as_device(self.device), "kernels": pool_kernels()}

    def solve_lanes(self, cacheval, params, atol, rtol, maxiters=None):
        """Solve every lane of ``params`` (a :class:`LaneParams`)
        independently: (val (L, *V), err (L,), numevals (L,), converged (L,))."""
        dev = cacheval["device"]
        L = 1 if params.x is None else params.x.shape[0]
        if params.x is not None:
            params = LaneParams(params.p, params.x.to(device=dev, dtype=REAL), params.merge)
        xk, wk, wg = gk_rule(self.order, dev)
        kernels = cacheval["kernels"]
        map_fn, jac_fn = cacheval["map"], cacheval["jac"]

        def rule(ca, cb, active, live):
            if live is None:
                live = active.nonzero().squeeze(1)
            I, P = ca.shape[1], xk.shape[0]
            nodes, half = gk_nodes(ca[live], cb[live], xk)
            ts = nodes.reshape(-1)
            xs = ts if map_fn is None else map_fn(ts)
            if cacheval["batch"] is not None:
                if params.x is not None:
                    raise NotImplementedError(
                        "a BatchIntegrand takes one parameter per call: sweep it one solve at a "
                        "time (ROADMAP A5)")
                fx = cacheval["batch"](xs, params.p)
            else:
                lanes = live.repeat_interleave(I * P)
                fx = params.map_points(cacheval["f"], (xs,), lanes)
            if jac_fn is not None:
                jac = jac_fn(ts)
                fx = fx * jac.reshape(jac.shape + (1,) * (fx.ndim - 1))
            fx = fx.reshape((live.numel(), I, P) + tuple(fx.shape[1:]))
            if not fx.is_complex():
                fx = fx.to(REAL)
            out = kernels.rule_reduce(fx.contiguous(), None, half.contiguous(), wk, wg)
            return scatter_lanes(L, live, *out)

        segs = torch.as_tensor(cacheval["segs"], dtype=REAL, device=dev).expand(L, -1).contiguous()
        atol_t = torch.full((L,), float(atol), dtype=REAL, device=dev)
        return gk_adaptive_lanes(rule, segs, atol_t, cap=self.cap, nbisect=self.nbisect, rtol=rtol,
                                 maxiters=maxiters, kernels=kernels)

    def do_solve(self, f, dom, p, cacheval, abstol=None, reltol=None, maxiters=None):
        atol, rtol = effective_tolerances(abstol, reltol)
        val, err, ne, conv = self.solve_lanes(cacheval, LaneParams(p), atol, rtol, _budget(maxiters))
        return IntegralSolution(val[0], err[0], bool(conv[0]), int(ne[0]))

    def solve_fn(self, cacheval, lanes=False):
        """fn(p, atol, rtol) -> (u, resid, converged, numevals); with
        ``lanes``, ``p`` is a :class:`LaneParams` and outputs carry the lane
        axis."""
        def fn(p, atol, rtol):
            val, err, ne, conv = self.solve_lanes(cacheval, p if lanes else LaneParams(p), atol, rtol)
            if lanes:
                return val, err, conv, ne
            return val[0], err[0], bool(conv[0]), int(ne[0])

        return fn


class AuxQuadGKJL(QuadGKJL):
    """Gauss-Kronrod with auxiliary error control, the reference's default
    inner rule for IAI. ``AuxValue`` results are not ported yet (ROADMAP A1),
    so it runs as :class:`QuadGKJL`."""
