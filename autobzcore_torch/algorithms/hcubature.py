"""h-adaptive cubature (Genz-Malik) over hypercubes (reference
``autobzcore_tpu/algorithms/hcubature.py``).

``HCubatureJL`` runs the lane-batched box pool of
:mod:`autobzcore_torch.ops.genz_malik`, one lane per solve. At each trip the
live lanes' children are evaluated in one batch: a FourierIntegrand's series
at the rule's nodes through kernel K1, then ``dos_trace`` fused with the rule
(K15) where the integrand is this package's ``dos_trace`` of at most three
bands, else the user function and the rule's reduction (K14); the pool step
is K16. A 1-D domain runs the order-7 Gauss-Kronrod interval pool of
:mod:`autobzcore_torch.ops.adaptive` (K5) at the same cap and bisection
width, as the reference does, with scalars lifted to 1-vectors for a
``HyperCube``.
"""
from __future__ import annotations

import numpy as np
import torch

from .._device import REAL, as_device
from ..domains import HyperCube
from ..interfaces import IntegralSolution
from ..ops.adaptive import (LoopStats, NodeChildren, gk_adaptive_lanes, gk_nodes, gk_rule, pool_kernels,
                            scatter_lanes)
from ..ops.genz_malik import box_kernels, gm_adaptive_lanes, gm_box_nodes, gm_rule_tensors
from ..parameters import LaneParams
from ..utils.tree import tree_norm
from ..wrappers import BatchIntegrand, InplaceIntegrand
from .base import IntegralAlgorithm, effective_tolerances
from .gk import _budget


def box_leaf_kernels(plain=False):
    """The box pool's kernel functions: K14 and K16 (:func:`box_kernels`)
    and K15 (``leaf_dos``), or with ``plain`` their plain versions."""
    from ..models.observables import gm_leaf_dos, gm_leaf_dos_plain

    k = box_kernels(plain)
    k.leaf_dos = gm_leaf_dos_plain if plain else gm_leaf_dos
    return k


class HCubatureJL(IntegralAlgorithm):
    """h-adaptive Genz-Malik cubature over hypercubes (reference
    ``HCubatureJL``); 1-D domains run adaptive Gauss-Kronrod. ``initdiv`` is
    accepted and unused, as in the reference. ``device`` places the pools of
    integrands that carry no series (a FourierIntegrand's pools live on its
    series' device; resolved when a solve is set up); ``plain_kernels`` runs
    the solve on the kernels' plain versions."""

    solves_lanes = True

    def __init__(self, norm=tree_norm, initdiv=1, cap=4096, nbisect=4, device="cuda",
                 plain_kernels=False):
        self.norm = norm
        self.initdiv = initdiv
        self.cap = cap
        self.nbisect = nbisect
        self.device = device
        self.plain_kernels = bool(plain_kernels)

    @staticmethod
    def _endpoints(dom):
        """(a, b, lift): a HyperCube's corners (its integrand takes d-vectors),
        or the two breakpoints of the interval form ``(a, b)`` (scalars)."""
        if isinstance(dom, HyperCube):
            return dom.a, dom.b, True
        segs = np.asarray(dom, dtype=np.float64) if isinstance(dom, (tuple, list, np.ndarray)) else None
        if segs is not None and segs.shape == (2,):
            return segs[:1], segs[1:], False
        raise TypeError("HCubatureJL requires a HyperCube-like domain")

    def init_cacheval(self, f, dom, p):
        if self.norm is not tree_norm:
            raise NotImplementedError("custom norms are not ported yet: the pools use the 2-norm "
                                      "(ROADMAP A5)")
        a, b, lift = self._endpoints(dom)
        d = a.shape[0]
        from ..fourier import FourierIntegrand, FourierSeries
        from ..models.observables import dos_trace

        if d == 1:
            device = f.s.device if isinstance(f, FourierIntegrand) else as_device(self.device)
            return {"segs": torch.as_tensor([a[0], b[0]], dtype=REAL, device=device), "lift": lift,
                    "gk_rule": gk_rule(7, device), "f": f, "device": device,
                    "kernels": pool_kernels(self.plain_kernels), "stats": LoopStats()}
        if isinstance(f, FourierIntegrand):
            device = f.s.device
            vs = f.s.valshape if isinstance(f.s, FourierSeries) else ()
            fused = (f.pf.f is dos_trace and isinstance(f.s, FourierSeries) and len(vs) == 2
                     and vs[0] == vs[1] and vs[0] <= 3)
        else:
            device = as_device(self.device)
            fused = False
        pts, wk, we, diff_idx = gm_rule_tensors(d, device)
        return {"a": torch.as_tensor(a, dtype=REAL, device=device),
                "b": torch.as_tensor(b, dtype=REAL, device=device),
                "rule": (pts, wk, we, diff_idx), "f": f, "fused_dos": fused, "device": device,
                "kernels": box_leaf_kernels(self.plain_kernels), "stats": LoopStats()}

    def solve_lanes(self, cacheval, params, atol, rtol, maxiters=None, return_state=False):
        """Solve every lane of ``params`` (a :class:`LaneParams`)
        independently: (val (L, *V), err (L,), numevals (L,), converged (L,)),
        and with ``return_state`` the final pool. ``atol`` is a
        number or one per lane (L,)."""
        dev = cacheval["device"]
        L = 1 if params.x is None else params.x.shape[0]
        if params.x is not None:
            params = LaneParams(params.p, params.x.to(device=dev, dtype=REAL), params.merge)
        if "gk_rule" in cacheval:
            segs = cacheval["segs"].expand(L, -1).contiguous()
            atol_t = torch.as_tensor(atol, dtype=REAL, device=dev).expand(L).contiguous()
            return gk_adaptive_lanes(self._gk_rule(cacheval, params), segs, atol_t, cap=self.cap,
                                     nbisect=self.nbisect, rtol=rtol, maxiters=maxiters,
                                     kernels=cacheval["kernels"], stats=cacheval["stats"],
                                     return_state=return_state)
        a, b = (t.expand(L, -1).contiguous() for t in (cacheval["a"], cacheval["b"]))
        rule = self._rule(cacheval, params, L)
        return gm_adaptive_lanes(rule, a, b, atol, cap=self.cap, nbisect=self.nbisect,
                                 npts=cacheval["rule"][0].shape[0], rtol=rtol, maxiters=maxiters,
                                 kernels=cacheval["kernels"], stats=cacheval["stats"],
                                 return_state=return_state)

    @staticmethod
    def _gk_rule(cacheval, params):
        """The 1-D rule of :func:`gk_adaptive_lanes` (the reference's
        ``gk_adaptive`` at order 7): the integrand at the live lanes' Kronrod
        nodes, scalars lifted to 1-vectors for a HyperCube."""
        xk, wk, wg = cacheval["gk_rule"]
        evaluate = _evaluator(cacheval["f"], params)
        lift = cacheval["lift"]

        def rule(ca, cb, active, live):
            if live is None:
                live = active.nonzero().squeeze(1)
            I, P = ca.shape[1], xk.shape[0]
            nodes, half = gk_nodes(ca[live], cb[live], xk)
            ts = nodes.reshape(-1)
            fx = evaluate(ts[:, None] if lift else ts, live.repeat_interleave(I * P))
            if not fx.is_complex():
                fx = fx.to(REAL)
            fx = fx.reshape((live.numel(), I, P) + tuple(fx.shape[1:])).contiguous()
            return NodeChildren(fx, None, half.contiguous(), live, wk, wg)

        return rule

    @staticmethod
    def _rule(cacheval, params, L):
        """``rule(cc, hh, active, live)`` of :func:`gm_adaptive_lanes` for the
        lanes ``params``: the live lanes' boxes in one evaluation."""
        pts, wk, we, diff_idx = cacheval["rule"]
        f, kernels = cacheval["f"], cacheval["kernels"]
        P, d = pts.shape
        dos = None
        if cacheval["fused_dos"]:
            from ..models.observables import dos_lanes

            dos = dos_lanes(params, L, cacheval["device"])
        evaluate = None if dos is not None else _evaluator(f, params)

        def rule(cc, hh, active, live):
            if live is None:
                live = active.nonzero().squeeze(1)
            K = cc.shape[1]
            La = live.numel()
            nodes, vol = gm_box_nodes(cc[live], hh[live], pts)
            X = nodes.reshape(-1, d)
            vol = vol.reshape(-1).contiguous()
            if dos is not None:
                om, eta = (t[live].repeat_interleave(K, dim=0).contiguous() for t in dos)
                H = f.s.eval_points(X)
                m = H.shape[-1]
                out = kernels.leaf_dos(H.reshape(La * K, P, m, m), om, eta, vol, wk, we, diff_idx)
            else:
                fx = evaluate(X, live.repeat_interleave(K * P))
                if not fx.is_complex():
                    fx = fx.to(REAL)
                fx = fx.reshape((La * K, P) + tuple(fx.shape[1:])).contiguous()
                out = kernels.rule_reduce(fx, vol, wk, we, diff_idx)
            val, err, sd = (o.reshape((La, K) + tuple(o.shape[1:])) for o in out)
            return scatter_lanes(L, live, val, err, sd)

        return rule

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


def _evaluator(f, params):
    """``evaluate(X, lanes (N,)) -> (N, *V)``: the integrand at the points X,
    (N, d) or (N,) scalars, each with its lane's parameter (a
    FourierIntegrand's series through K1, or K11 for a JacobianSeries; its
    user function sees 1-vectors for scalars, as a FourierIntegrand call
    does)."""
    from ..fourier import FourierIntegrand, FourierValue

    if isinstance(f, FourierIntegrand):
        pf = f.pf

        def evaluate(X, lanes):
            X = X if X.ndim == 2 else X[:, None]
            sv = f.s.eval_points(X)
            if f.batched:  # the user function takes the whole batch
                return pf(FourierValue(X, sv), params.batch_params(lanes))
            if isinstance(sv, tuple):  # a JacobianSeries' (H, dH)
                return params.map_points(lambda x, h, v, q: pf(FourierValue(x, (h, v)), q),
                                         (X,) + sv, lanes)
            return params.map_points(lambda x, s, q: pf(FourierValue(x, s), q), (X, sv), lanes)

        return evaluate
    if isinstance(f, BatchIntegrand):
        if params.x is not None:
            raise NotImplementedError("a BatchIntegrand takes one parameter per call: sweep it one "
                                      "solve at a time (ROADMAP A5)")
        return lambda X, lanes: f.f(X, params.p)
    g = f.to_pure() if isinstance(f, InplaceIntegrand) else f
    return lambda X, lanes: params.map_points(g, (X,), lanes)
