"""Nested (iterated) adaptive integration, the IAI backbone (reference
``autobzcore_tpu/algorithms/nested.py``, plain tier, cold start).

The reference compiles its nest as ``vmap`` of inner ``while_loop`` solves
over each outer node panel. Here every level is a lane-batched pool
(:func:`~autobzcore_torch.ops.adaptive.gk_adaptive_lanes`): the outermost
level has one lane per solve, and a level's lanes are the (lane, node) pairs
of one trip of the level above. Each trip of a non-leaf level gathers its
live lanes (one host sync), contracts the series at their nodes (kernel K3),
solves all the inner lanes to completion as one batched pool, and reduces
their values and counts with the rule (K5). Inner solves of finished lanes
are skipped (the reference computes and discards them). The innermost level
of a ``dos_trace`` integrand runs the fused leaf kernel K4; any other
integrand evaluates its 1-D series with K3, calls the user function and
reduces with K5.

Per-level tolerances follow the reference: an inner solve at node ``x`` gets
``atol / len(inner segments)``, per lane, so wedge limits give every lane its
own tolerance. Counts at non-leaf levels are the sums of the inner solves'
counts.

Not ported here: the warm start and its mid-level carry (the IAI warm
slice), the guided and split tiers (``precision`` runs this complex128
tier), the host-side outer heap (``host_outer=True`` runs on the device),
fixed-rule and pole levels (ROADMAP A7).
"""
from __future__ import annotations

import warnings

import torch

from .._device import REAL, as_device
from ..fourier import lanes_per_point
from ..interfaces import IntegralSolution
from ..limits import IteratedLimits
from ..ops.adaptive import (LoopStats, gk_adaptive_lanes, gk_nodes, gk_rule, pool_kernels,
                            scatter_lanes)
from ..parameters import LaneParams
from ..utils.tree import tree_norm
from ..wrappers import BatchIntegrand, InplaceIntegrand
from .base import IntegralAlgorithm, effective_tolerances
from .gk import QuadGKJL, _budget

_TINY = torch.finfo(REAL).tiny
# leaf trips between host tests of "any lane live" on the card (the fused
# leaf needs no live-lane list, so it need not sync on every trip)
LEAF_SYNC_EVERY = 4


def nest_kernels(plain=False):
    """The nest's kernel functions: the wrappers of K3 (``contract``), K4
    (``leaf_dos``) and K5 (the pool step), or with ``plain`` their plain
    PyTorch versions, which run on any device (to hold a whole solve on the
    card against the kernels)."""
    from ..models.observables import gk_leaf_dos, gk_leaf_dos_plain
    from ..ops.fourier_eval import fourier_contract, fourier_contract_plain

    k = pool_kernels(plain)
    k.contract = fourier_contract_plain if plain else fourier_contract
    k.leaf_dos = gk_leaf_dos_plain if plain else gk_leaf_dos
    return k


def assemble_points(xs, coords):
    """(L, J, d) points: the innermost variable ``xs`` (L, J) and the lanes'
    already-fixed outer coordinates ``coords`` ((L,) each, outermost first)."""
    cols = [xs] + [c[:, None].expand(xs.shape) for c in reversed(coords)]
    return torch.stack(cols, dim=-1)


class PlainCarrier:
    """Nest carrier for ordinary integrands: no per-level state."""

    def __init__(self, f):
        if isinstance(f, BatchIntegrand):
            self.f = None
            self.batch = f.f
        else:
            self.f = f.to_pure() if isinstance(f, InplaceIntegrand) else f
            self.batch = None

    def take(self, idx):
        return self

    def fix(self, x):
        return self

    def eval_batch(self, xs, coords, params):
        L, J = xs.shape
        pts = assemble_points(xs, coords).reshape(L * J, -1)
        if self.batch is not None:
            if params.x is not None:
                raise NotImplementedError(
                    "a BatchIntegrand takes one parameter per call: sweep it one solve at a time "
                    "(lane-batched BatchIntegrand sweeps are not ported, ROADMAP A5)")
            out = self.batch(pts, params.p)
        else:
            out = params.map_points(self.f, (pts,), lanes_per_point(L, J, xs.device))
        return out.reshape((L, J) + tuple(out.shape[1:]))


class _Level:
    """The lanes of one nest level: limits, series carrier, fixed outer
    coordinates, parameters and absolute tolerance of each lane."""

    def __init__(self, lims, carrier, coords, params, atol):
        self.lims = lims
        self.carrier = carrier
        self.coords = coords
        self.params = params
        self.atol = atol

    def take(self, idx):
        return _Level(self.lims, self.carrier.take(idx), tuple(c[idx] for c in self.coords),
                      self.params.take(idx), self.atol[idx])

    def spawn(self, x):
        """The next level's lanes at the nodes ``x`` (L, J), lane-major, and
        their breakpoints (L*J, S+1)."""
        L, J = x.shape
        xf = x.reshape(-1)
        parent = torch.arange(L, device=x.device).repeat_interleave(J)
        lims2 = self.lims.fix(xf)
        segs2 = lims2.outer_segments(x.device)
        segs2 = segs2.expand(L * J, segs2.shape[-1]).contiguous()
        len2 = segs2[:, -1] - segs2[:, 0]
        atol2 = self.atol[parent] / torch.clamp(len2, min=_TINY)
        coords = tuple(c[parent] for c in self.coords) + (xf,)
        return (_Level(lims2, self.carrier.fix(x), coords, self.params.take(parent), atol2),
                segs2)


class NestedQuad(IntegralAlgorithm):
    """``NestedQuad(alg)`` or ``NestedQuad(algs_tuple)`` with one algorithm per
    dimension (index 0 = innermost), as in the reference. Every level must be
    a :class:`QuadGKJL`. ``device`` holds the pools of integrands that carry
    no series (a FourierIntegrand's pools live on its series' device);
    ``plain_kernels`` runs the nest on the kernels' plain versions
    (:func:`nest_kernels`)."""

    solves_lanes = True

    def __init__(self, algs, inner_cap=512, inner_nbisect=2, split=False,
                 host_outer=False, host_nbisect=None, checkpoint=None,
                 leaf_nbisect=None, leaf_presplit=None, nest_presplit=None,
                 guide_rfloor="auto", guide_patience=6, guide_slack=1.0,
                 warm_start=False, warm_width=None, inner_seed_width=None,
                 device="cuda", plain_kernels=False):
        if warm_start:
            raise NotImplementedError("warm-started nests are the IAI warm slice, not ported yet "
                                      "(ROADMAP A5, IAI warm slice)")
        if checkpoint is not None:
            raise NotImplementedError("the host-side outer heap and its checkpoints are not ported "
                                      "(ROADMAP A5, 'Not to port')")
        self.algs = algs
        # split/guided are the reference's emulated-f64 tiers: the port runs
        # native complex128, the precision both tiers certify
        self.split = split
        # host_outer bounded single-dispatch time on a hosted TPU; accepted,
        # and the outer level runs on the device like the others
        self.host_outer = host_outer
        self.host_nbisect = host_nbisect
        self.inner_cap = inner_cap
        self.inner_nbisect = inner_nbisect
        self.leaf_nbisect = leaf_nbisect
        self.leaf_presplit = leaf_presplit
        self.nest_presplit = nest_presplit
        # cold-start knobs of the guided tier and the warm seeds are unused
        # by the cold complex128 tier, as the reference's cold solves leave them
        self.guide_rfloor = guide_rfloor
        self.guide_patience = guide_patience
        self.guide_slack = guide_slack
        self.warm_width = warm_width
        self.inner_seed_width = inner_seed_width
        self.device = as_device(device)
        self.plain_kernels = bool(plain_kernels)

    def _presplit_for(self, d_rem):
        """Uniform presplit for one nest level: the innermost honors
        ``leaf_presplit``, every level ``nest_presplit``."""
        if d_rem == 1 and self.leaf_presplit:
            return int(self.leaf_presplit)
        return int(self.nest_presplit) if self.nest_presplit else 1

    def _level_knobs(self, alg, d_rem, ndim):
        """Pool cap and bisection width of one level: the outermost keeps the
        algorithm's own; inner levels clamp to ``inner_cap``/
        ``inner_nbisect``; the leaf may widen to ``leaf_nbisect``."""
        outermost = d_rem == ndim
        cap = alg.cap if outermost else min(alg.cap, self.inner_cap)
        if outermost:
            nbisect = alg.nbisect
        elif d_rem == 1 and self.leaf_nbisect is not None:
            nbisect = max(1, int(self.leaf_nbisect))
        else:
            nbisect = min(alg.nbisect, self.inner_nbisect)
        return cap, nbisect

    def _algs_for(self, ndim):
        if isinstance(self.algs, (tuple, list)):
            if len(self.algs) != ndim:
                raise ValueError("need one algorithm per dimension")
            return tuple(self.algs)
        return (self.algs,) * ndim

    def init_cacheval(self, f, dom, p):
        if not isinstance(dom, IteratedLimits):
            raise TypeError("NestedQuad requires an IteratedLimits domain")
        algs = self._algs_for(dom.ndim)
        for a in algs:
            if not isinstance(a, QuadGKJL):
                raise NotImplementedError(
                    f"{type(a).__name__} levels are not ported yet: NestedQuad takes QuadGKJL "
                    "levels (fixed-rule and pole levels, ROADMAP A7)")
        from ..fourier import FourierIntegrand
        from .ptr import _uses_dos_kernel

        kernels = nest_kernels(self.plain_kernels)
        if isinstance(f, FourierIntegrand):
            carrier = f.nest_carrier(split=bool(self.split))
            carrier.contract = kernels.contract
            device = f.s.device
            vs = carrier.valshape
            fused = (_uses_dos_kernel(f) and len(vs) == 2 and vs[0] == vs[1] and vs[0] <= 3)
        else:
            carrier = PlainCarrier(f)
            device = self.device
            fused = False
        return {"dom": dom, "algs": algs, "carrier": carrier, "device": device,
                "fused_dos": fused, "kernels": kernels, "stats": LoopStats()}

    # --- the lane-batched solve --------------------------------------------
    def solve_lanes(self, cacheval, params, atol, rtol, maxiters=None):
        """Solve every lane of ``params`` (a :class:`LaneParams`)
        independently: returns (val (L, *V), err (L,), numevals (L,) float64,
        converged (L,) bool)."""
        dom, device = cacheval["dom"], cacheval["device"]
        L = 1 if params.x is None else params.x.shape[0]
        if params.x is not None:
            params = LaneParams(params.p, params.x.to(device=device, dtype=REAL), params.merge)
        carrier = cacheval["carrier"]
        if hasattr(carrier, "lanes"):
            carrier = carrier.lanes(L)
        atol_t = torch.full((L,), float(atol), dtype=REAL, device=device)
        level = _Level(dom, carrier, (), params, atol_t)
        segs = dom.outer_segments(device).expand(L, -1).contiguous()
        return self._solve_level(cacheval, level, segs, dom.ndim, float(rtol), maxiters)

    def _solve_level(self, cacheval, level, segs, d_rem, rtol, maxiters):
        algs, ndim = cacheval["algs"], cacheval["dom"].ndim
        alg = algs[d_rem - 1]
        cap, nbisect = self._level_knobs(alg, d_rem, ndim)
        if alg.norm is not tree_norm:
            raise NotImplementedError("custom norms are not ported yet: the pools use the 2-norm "
                                      "(ROADMAP A5)")
        kernels = cacheval["kernels"]
        xk, wk, wg = gk_rule(alg.order, segs.device)
        sync_every = 1
        if d_rem > 1:
            rule = self._nonleaf_rule(cacheval, level, xk, wk, wg, d_rem, rtol, maxiters, kernels)
        else:
            lanes = None
            if cacheval["fused_dos"]:
                from ..models.observables import dos_lanes

                lanes = dos_lanes(level.params, segs.shape[0], segs.device)
            if lanes is not None:
                rule = _fused_dos_rule(level, lanes, xk, wk, wg, kernels.leaf_dos)
                if segs.device.type == "cuda":
                    sync_every = LEAF_SYNC_EVERY
            else:
                rule = _leaf_rule(level, xk, wk, wg, kernels)
        return gk_adaptive_lanes(rule, segs, level.atol, cap=cap, nbisect=nbisect, rtol=rtol,
                                 maxiters=maxiters, presplit=self._presplit_for(d_rem),
                                 sync_every=sync_every, kernels=kernels,
                                 stats=cacheval["stats"], level=d_rem)

    def _nonleaf_rule(self, cacheval, level, xk, wk, wg, d_rem, rtol, maxiters, kernels):
        def rule(ca, cb, active, live):
            if live is None:
                live = active.nonzero().squeeze(1)
            L, I = ca.shape
            P = xk.shape[0]
            nodes, half = gk_nodes(ca[live], cb[live], xk)
            inner, segs2 = level.take(live).spawn(nodes.reshape(live.numel(), I * P))
            val, _, ne, _ = self._solve_level(cacheval, inner, segs2, d_rem - 1, rtol, maxiters)
            La = live.numel()
            fx = val.reshape((La, I, P) + tuple(val.shape[1:])).contiguous()
            out = kernels.rule_reduce(fx, ne.reshape(La, I, P).contiguous(), half.contiguous(),
                                      wk, wg)
            return scatter_lanes(L, live, *out)

        return rule

    # --- the solver contract -------------------------------------------------
    def do_solve(self, f, dom, p, cacheval, abstol=None, reltol=None, maxiters=None):
        atol, rtol = effective_tolerances(abstol, reltol)
        val, err, ne, conv = self.solve_lanes(cacheval, LaneParams(p), atol, rtol,
                                              _budget(maxiters))
        if not bool(conv[0]) and maxiters is None:
            warnings.warn(
                "NestedQuad did not reach the requested tolerance (pool capacity); "
                "inspect sol.resid or raise cap/inner_cap", stacklevel=2)
        return IntegralSolution(val[0], err[0], bool(conv[0]), int(ne[0]))

    def solve_fn(self, cacheval, lanes=False):
        """fn(p, atol, rtol) -> (u, resid, converged, numevals). With
        ``lanes``, ``p`` is a :class:`LaneParams` and every output carries
        the lane axis."""
        def fn(p, atol, rtol):
            params = p if lanes else LaneParams(p)
            val, err, ne, conv = self.solve_lanes(cacheval, params, atol, rtol)
            if lanes:
                return val, err, conv, ne
            return val[0], err[0], bool(conv[0]), int(ne[0])

        return fn


def _leaf_rule(level, xk, wk, wg, kernels):
    """Innermost rule of a generic integrand: the 1-D series (K3) or the
    plain function at the live lanes' nodes, the user function, then the
    rule's reduction (K5)."""
    def rule(ca, cb, active, live):
        if live is None:
            live = active.nonzero().squeeze(1)
        L, I = ca.shape
        P = xk.shape[0]
        nodes, half = gk_nodes(ca[live], cb[live], xk)
        sub = level.take(live)
        fx = sub.carrier.eval_batch(nodes.reshape(live.numel(), I * P), sub.coords, sub.params)
        fx = fx.reshape((live.numel(), I, P) + tuple(fx.shape[2:]))
        if not fx.is_complex():
            fx = fx.to(REAL)
        out = kernels.rule_reduce(fx.contiguous(), None, half.contiguous(), wk, wg)
        return scatter_lanes(L, live, *out)

    return rule


def _fused_dos_rule(level, lanes, xk, wk, wg, leaf):
    """Innermost rule of ``dos_trace``: kernel K4 on every lane (inactive
    lanes are skipped inside the kernel), or on the live lanes when the loop
    has them at hand."""
    om, eta = lanes
    car = level.carrier

    def rule(ca, cb, active, live):
        args = (car.offset[0], car.period[0])
        if live is None or live.numel() == ca.shape[0]:
            return leaf(car.c, car.cmap, *args, ca, cb, om, eta, active, xk, wk, wg)
        ones = torch.ones(live.numel(), dtype=torch.bool, device=ca.device)
        out = leaf(car.c, car.cmap[live], *args, ca[live], cb[live], om[live], eta[live], ones,
                   xk, wk, wg)
        return scatter_lanes(ca.shape[0], live, *out)

    return rule
