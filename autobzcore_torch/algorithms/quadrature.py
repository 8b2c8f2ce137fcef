"""Fixed-order quadrature from a user rule function (reference
``autobzcore_tpu/algorithms/quadrature.py``).

``QuadratureFunction(fun, npt)`` applies the rule ``x, w = fun(npt)`` on
[-1, 1] to every segment of a 1-D domain, with one batched integrand call
over the nodes of every lane of a solve, and reduces the values with kernel
K17 (:func:`~autobzcore_torch.ops.adaptive.fixed_rule_reduce`). Inside a
:class:`~autobzcore_torch.algorithms.nested.NestedQuad` it names a fixed
level's rule.
"""
from __future__ import annotations

import torch

from .._device import REAL, as_device
from ..interfaces import IntegralSolution
from ..ops.adaptive import fixed_rule_nodes, fixed_rule_reduce
from ..ops.quad_rules import trapz
from ..parameters import LaneParams
from ..wrappers import BatchIntegrand, InplaceIntegrand
from .base import IntegralAlgorithm, segments_of


class QuadratureFunction(IntegralAlgorithm):
    """Fixed rule ``x, w = fun(npt)`` on [-1, 1] applied per segment
    (reference ``QuadratureFunction``). ``numevals`` is ``npt`` times the
    segments, the retcode True and the error None (0 in the sweep form).
    ``device`` places a standalone solve's nodes (the card by default;
    resolved when a solve is set up); inside a nest the nest's device
    holds."""

    solves_lanes = True

    def __init__(self, fun=trapz, npt=50, device="cuda"):
        self.fun = fun
        self.npt = npt
        self.device = device

    def rule(self, device):
        """The rule's nodes and weights (npt,) as float64 tensors on ``device``."""
        x, w = self.fun(self.npt)
        return (torch.as_tensor(x, dtype=REAL, device=device),
                torch.as_tensor(w, dtype=REAL, device=device))

    def init_cacheval(self, f, dom, p):
        from ..fourier import FourierIntegrand

        device = f.s.device if isinstance(f, FourierIntegrand) else as_device(self.device)
        segs = torch.as_tensor(segments_of(dom), dtype=REAL, device=device)
        x, w = self.rule(device)
        if isinstance(f, BatchIntegrand):
            point_f, batch = None, f.f
        else:
            point_f, batch = (f.to_pure() if isinstance(f, InplaceIntegrand) else f), None
        return {"segs": segs, "x": x, "w": w, "f": point_f, "batch": batch, "device": device,
                "numevals": x.shape[0] * (segs.shape[0] - 1)}

    def solve_lanes(self, cacheval, params, atol=None, rtol=None, maxiters=None):
        """Every lane of ``params`` (a :class:`LaneParams`) by the rule, in one
        integrand call: (val (L, *V), err (L,) zeros, numevals (L,),
        converged (L,) True)."""
        from ..fourier import lanes_per_point

        dev = cacheval["device"]
        L = 1 if params.x is None else params.x.shape[0]
        if params.x is not None:
            params = LaneParams(params.p, params.x.to(device=dev, dtype=REAL), params.merge)
        nodes, half = fixed_rule_nodes(cacheval["segs"].expand(L, -1), cacheval["x"])
        S, P = half.shape[1], nodes.shape[2]
        xs = nodes.reshape(-1)
        if cacheval["batch"] is not None:
            if params.x is not None:
                raise NotImplementedError("a BatchIntegrand takes one parameter per call: sweep it "
                                          "one solve at a time (ROADMAP A5)")
            fx = cacheval["batch"](xs, params.p)
        else:
            fx = params.map_points(cacheval["f"], (xs,), lanes_per_point(L, S * P, dev))
        if not fx.is_complex():
            fx = fx.to(REAL)
        fx = fx.reshape((L, S, P) + tuple(fx.shape[1:])).contiguous()
        val = fixed_rule_reduce(fx, cacheval["w"], half.contiguous())
        return (val, torch.zeros(L, dtype=REAL, device=dev),
                torch.full((L,), float(cacheval["numevals"]), dtype=REAL, device=dev),
                torch.ones(L, dtype=torch.bool, device=dev))

    def do_solve(self, f, dom, p, cacheval, abstol=None, reltol=None, maxiters=None):
        val = self.solve_lanes(cacheval, LaneParams(p))[0]
        return IntegralSolution(val[0], None, True, cacheval["numevals"])

    def solve_fn(self, cacheval, lanes=False):
        """fn(p, atol, rtol) -> (u, resid, converged, numevals); with
        ``lanes``, ``p`` is a :class:`LaneParams` and outputs carry the lane
        axis."""
        def fn(p, atol, rtol):
            if lanes:
                val, err, ne, conv = self.solve_lanes(cacheval, p)
                return val, err, conv, ne
            val = self.solve_lanes(cacheval, LaneParams(p))[0]
            return val[0], 0.0, True, cacheval["numevals"]

        return fn
