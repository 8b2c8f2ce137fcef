"""Nested (iterated) adaptive integration, the IAI backbone (reference
``autobzcore_tpu/algorithms/nested.py``, plain tier, cold start).

The reference compiles its nest as ``vmap`` of inner ``while_loop`` solves
over each outer node panel. Here every level is a lane-batched pool
(:func:`~autobzcore_torch.ops.adaptive.gk_adaptive_lanes`): the outermost
level has one lane per solve, and a level's lanes are the (lane, node) pairs
of one trip of the level above. Each trip of a non-leaf level gathers its
live lanes (one host sync), contracts the series at their nodes (kernel K3),
solves all the inner lanes to completion as one batched pool, and hands
their values and counts to the pool's step (K5), which reduces them with the
rule on the way into the pool. Inner solves of finished lanes
are skipped (the reference computes and discards them). The innermost level
of a ``dos_trace`` integrand starts its pools with the fused leaf kernel K4
and runs them to their ends in one launch of the fused leaf solve
(``gk_leaf_dos_solve``: the lanes' select, K4 and update trips on the
device, no host test between trips); any other integrand evaluates its 1-D
series with K3 and calls the user function, and K5's step reduces. A lane may
carry an omega block (``SweepSolver(block=W)``): its parameter is a (W,)
vector, its values (W,) channels at every level and its error the 2-norm
over them; the fused leaf then runs K4 and the solve over the block.

Per-level tolerances follow the reference: an inner solve at node ``x`` gets
``atol / len(inner segments)``, per lane, so wedge limits give every lane its
own tolerance. Counts at non-leaf levels are the sums of the inner solves'
counts.

The warm form (:meth:`NestedQuad.solve_fn_warm`, for
``SweepSolver(warm=True)``) solves one parameter from a carried
:class:`WarmPool`: the outermost pool starts from the previous solve's
final partition (coarsened by K6), and every pool of the level below starts
from one carried partition in normalized coordinates (:class:`MidSeed`,
remapped per lane, not coarsened); deeper levels start cold.
:meth:`NestedQuad.harvest_fn` refreshes that partition with one seeded
solve at the worst outer interval's midpoint.

A fixed level (:class:`~autobzcore_torch.algorithms.quadrature.QuadratureFunction`,
reference ``solve_level`` at ``algorithms/nested.py:481-490``) evaluates its
rule's S * npt nodes per lane in one go: below the leaf, as the lanes of one
batched solve of the level below; at the leaf, by the carrier. Kernel K17
reduces them, and the counts sum. A fixed level certifies nothing: its error
is 0 and its retcode True. It carries no warm pool: the warm form needs an
adaptive outermost level, and the mid seed an adaptive level below it, as in
the reference.

Not ported here: the guided and split tiers (``precision`` runs this
complex128 tier), the host-side outer heap (``host_outer=True`` runs on the
device; ``warm_start=True`` seeded that heap and raises), pole levels
(ROADMAP A7).
"""
from __future__ import annotations

import math
import warnings
from typing import NamedTuple

import numpy as np
import torch

from .._device import REAL, as_device
from ..fourier import lanes_per_point
from ..interfaces import IntegralSolution
from ..limits import IteratedLimits
from ..ops.adaptive import (LoopStats, NodeChildren, fixed_rule_nodes, fixed_rule_reduce,
                            fixed_rule_reduce_plain, gk_adaptive_lanes, gk_nodes, gk_rule,
                            pool_kernels)
from ..parameters import LaneParams
from ..utils.tree import tree_norm
from ..wrappers import BatchIntegrand, InplaceIntegrand
from .base import IntegralAlgorithm, effective_tolerances
from .gk import QuadGKJL, _budget
from .quadrature import QuadratureFunction

_TINY = torch.finfo(REAL).tiny
# leaf trips between host tests of "any lane live" on the card's trip route
# (plain_kernels=True, or a DOS leaf the fused solve does not take): the
# fused leaf rule needs no live-lane list, so it need not sync on every trip
LEAF_SYNC_EVERY = 4


def nest_kernels(plain=False):
    """The nest's kernel functions: the wrappers of K3 (``contract``), K4
    (``leaf_dos``), K5 (the pool step) and K17 (``fixed_reduce``), or with
    ``plain`` their plain PyTorch versions, which run on any device (to hold
    a whole solve on the card against the kernels)."""
    from ..models.observables import gk_leaf_dos, gk_leaf_dos_plain
    from ..ops.fourier_eval import fourier_contract, fourier_contract_plain

    k = pool_kernels(plain)
    k.contract = fourier_contract_plain if plain else fourier_contract
    k.leaf_dos = gk_leaf_dos_plain if plain else gk_leaf_dos
    k.fixed_reduce = fixed_rule_reduce_plain if plain else fixed_rule_reduce
    return k


def assemble_points(xs, coords):
    """(L, J, d) points: the innermost variable ``xs`` (L, J) and the lanes'
    already-fixed outer coordinates ``coords`` ((L,) each, outermost first)."""
    cols = [xs] + [c[:, None].expand(xs.shape) for c in reversed(coords)]
    return torch.stack(cols, dim=-1)


class MidSeed(NamedTuple):
    """A carried inner-level partition in normalized coordinates ``t`` in
    [0, 1] (reference ``mid_seed = (ta, tb, te, tn)``): ``ta, tb, te``
    (capm,) tensors on the pools' device, ``tn`` the host's count of live
    slots (0 = the cold sentinel: seed from the breakpoints)."""

    ta: torch.Tensor
    tb: torch.Tensor
    te: torch.Tensor
    tn: int


class WarmPool(NamedTuple):
    """The state a warm sweep carries from solve to solve (the reference's
    pool tuple ``(a, b, err, n[, mid_seed])``): the outermost level's final
    pool ``a, b, e`` (cap,) with ``n`` live slots (a one-element int64
    tensor on the device), and for nests the :class:`MidSeed` of the level
    below (None in 1-D)."""

    a: torch.Tensor
    b: torch.Tensor
    e: torch.Tensor
    n: torch.Tensor
    mid: MidSeed | None = None


def _mid_seed_pool(mid, segs2):
    """Denormalize a carried partition onto each lane's inner domain (the
    reference's ``_mid_seed_pool``, per lane): returns the lanes' pools
    ``(A, B, E, N)`` ((L, capm) each, N (L,)) and N's host value. Rows past
    the live count are zero-width, and ``tn == 0`` seeds from the lanes'
    breakpoints with errors +inf."""
    L, S1 = segs2.shape
    dev = segs2.device
    capm = mid.ta.shape[0]
    lo, hi = segs2[:, :1], segs2[:, -1:]
    length = torch.clamp(hi - lo, min=_TINY)
    if mid.tn > 0:
        A = lo + mid.ta[None] * length
        B = lo + mid.tb[None] * length
        E = mid.te[None].expand(L, capm)
        N = mid.tn
    else:
        N = S1 - 1
        A = torch.zeros((L, capm), dtype=REAL, device=dev)
        B = torch.zeros((L, capm), dtype=REAL, device=dev)
        A[:, :N] = segs2[:, :-1]
        B[:, :N] = segs2[:, 1:]
        E = torch.full((L, capm), math.inf, dtype=REAL, device=dev)
    live = torch.arange(capm, device=dev)[None, :] < N
    zero = torch.zeros((), dtype=REAL, device=dev)
    pool = (torch.where(live, A, zero), torch.where(live, B, zero), torch.where(live, E, zero),
            torch.full((L,), N, dtype=torch.int64, device=dev))
    return pool, N


def _mid_seed_norm(state, segs2):
    """Normalize lane 0 of a solve's final pool for carrying (the inverse of
    :func:`_mid_seed_pool`); reads its live count on the host once."""
    lo, hi = segs2[0, 0], segs2[0, -1]
    length = torch.clamp(hi - lo, min=_TINY)
    return MidSeed((state.a[0] - lo) / length, (state.b[0] - lo) / length, state.err[0].clone(),
                   int(state.n[0]))


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
    a :class:`QuadGKJL` or a :class:`QuadratureFunction`. ``device`` holds
    the pools of integrands that carry no series (a FourierIntegrand's pools
    live on its series' device); ``plain_kernels`` runs the nest on the
    kernels' plain versions (:func:`nest_kernels`)."""

    solves_lanes = True

    def __init__(self, algs, inner_cap=512, inner_nbisect=2, split=False,
                 host_outer=False, host_nbisect=None, checkpoint=None,
                 leaf_nbisect=None, leaf_presplit=None, nest_presplit=None,
                 guide_rfloor="auto", guide_patience=6, guide_slack=1.0,
                 warm_start=False, warm_width=None, inner_seed_width=None,
                 device="cuda", plain_kernels=False):
        if warm_start:
            raise NotImplementedError(
                "warm_start=True seeds the host-side outer heap, which is not ported (ROADMAP A5, "
                "'Not to port'); the warm slice's on-device form is SweepSolver(warm=True)")
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
        # the guided tier's knobs are unused by the complex128 tier
        self.guide_rfloor = guide_rfloor
        self.guide_patience = guide_patience
        self.guide_slack = guide_slack
        # seed chunk widths of warm solves: the outermost level's, and the
        # level below it when it seeds from a carried partition
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
            if not isinstance(a, (QuadGKJL, QuadratureFunction)):
                raise NotImplementedError(
                    f"{type(a).__name__} levels are not ported yet: NestedQuad takes QuadGKJL and "
                    "QuadratureFunction levels (pole levels, ROADMAP A7)")
        from ..fourier import FourierIntegrand
        from ..models.observables import dos_trace

        kernels = nest_kernels(self.plain_kernels)
        if isinstance(f, FourierIntegrand):
            carrier = f.nest_carrier(split=bool(self.split))
            carrier.contract = kernels.contract
            device = f.s.device
            vs = carrier.valshape
            fused = (f.pf.f is dos_trace and len(vs) == 2 and vs[0] == vs[1] and vs[0] <= 3)
        else:
            carrier = PlainCarrier(f)
            device = self.device
            fused = False
        cacheval = {"dom": dom, "algs": algs, "carrier": carrier, "device": device,
                    "fused_dos": fused, "kernels": kernels, "stats": LoopStats()}
        if self.split != "guided" and isinstance(algs[-1], QuadGKJL):
            # the warm form needs an adaptive outermost level (and the mid
            # seed an adaptive level below it); the guided tier has none, as
            # in the reference
            cacheval["carry_mid"] = dom.ndim > 1 and isinstance(algs[-2], QuadGKJL)
            cacheval["warm_pool0"] = self._warm_pool0(dom, algs, device, cacheval["carry_mid"])
        return cacheval

    def _warm_pool0(self, dom, algs, device, carry_mid):
        """The cold seed (reference ``warm_pool0``): the outermost
        breakpoints in pool form with errors +inf, so the first solve's
        coarsening keeps them, and for nests the cold mid sentinel tn = 0."""
        ndim = dom.ndim
        cap0, _ = self._level_knobs(algs[ndim - 1], ndim, ndim)
        segs0 = dom.outer_segments().cpu().numpy()
        nseg0 = len(segs0) - 1
        a0, b0 = np.zeros(cap0), np.zeros(cap0)
        a0[:nseg0], b0[:nseg0] = segs0[:-1], segs0[1:]
        put = lambda x: torch.as_tensor(x, dtype=REAL, device=device)  # noqa: E731
        mid = None
        if carry_mid:
            capm, _ = self._level_knobs(algs[ndim - 2], ndim - 1, ndim)
            mid = MidSeed(put(np.zeros(capm)), put(np.zeros(capm)), put(np.zeros(capm)), 0)
        return WarmPool(put(a0), put(b0), put(np.full(cap0, np.inf)),
                        torch.full((1,), nseg0, dtype=torch.int64, device=device), mid)

    # --- the lane-batched solve --------------------------------------------
    def solve_lanes(self, cacheval, params, atol, rtol, maxiters=None):
        """Solve every lane of ``params`` (a :class:`LaneParams`)
        independently: returns (val (L, *V), err (L,), numevals (L,) float64,
        converged (L,) bool). ``atol`` is a number or one per lane (L,)."""
        dom, device = cacheval["dom"], cacheval["device"]
        L = 1 if params.x is None else params.x.shape[0]
        if params.x is not None:
            params = LaneParams(params.p, params.x.to(device=device, dtype=REAL), params.merge)
        carrier = cacheval["carrier"]
        if hasattr(carrier, "lanes"):
            carrier = carrier.lanes(L)
        atol_t = torch.as_tensor(atol, dtype=REAL, device=device).expand(L).contiguous()
        level = _Level(dom, carrier, (), params, atol_t)
        segs = dom.outer_segments(device).expand(L, -1).contiguous()
        out = self._solve_level(cacheval, level, segs, dom.ndim, float(rtol), maxiters)
        cacheval["stats"].read_device_trips()
        return out

    def _solve_level(self, cacheval, level, segs, d_rem, rtol, maxiters, init_pool=None,
                     seed_n=None, mid_seed=None, coarsen_seed=None, return_state=False):
        """Solve the lanes of one level (reference ``solve_level``). A warm
        start takes ``init_pool`` (with ``seed_n``, see
        :func:`~autobzcore_torch.ops.adaptive.gk_adaptive_lanes`); the pools
        of the level below seed from ``mid_seed`` when given. The outermost
        level's seed is coarsened unless ``coarsen_seed`` says otherwise."""
        algs, ndim = cacheval["algs"], cacheval["dom"].ndim
        alg = algs[d_rem - 1]
        if isinstance(alg, QuadratureFunction):
            if init_pool is not None or return_state:
                raise TypeError("warm-start pools need an adaptive (QuadGKJL) outermost level")
            return self._fixed_level(cacheval, level, segs, alg, d_rem, rtol, maxiters)
        cap, nbisect = self._level_knobs(alg, d_rem, ndim)
        if alg.norm is not tree_norm:
            raise NotImplementedError("custom norms are not ported yet: the pools use the 2-norm "
                                      "(ROADMAP A5)")
        kernels = cacheval["kernels"]
        xk, wk, wg = gk_rule(alg.order, segs.device)
        sync_every, solve = 1, None
        if d_rem > 1:
            rule = self._nonleaf_rule(cacheval, level, xk, wk, wg, d_rem, rtol, maxiters, mid_seed)
        else:
            lanes = None
            if cacheval["fused_dos"]:
                from ..models.observables import dos_lanes

                lanes = dos_lanes(level.params, segs.shape[0], segs.device)
            if lanes is not None:
                rule, solve = self._fused_dos_leaf(cacheval, level, lanes, xk, wk, wg, cap, nbisect)
                if segs.device.type == "cuda":
                    sync_every = LEAF_SYNC_EVERY
            else:
                rule = _leaf_rule(level, xk, wk, wg)
        return gk_adaptive_lanes(rule, segs, level.atol, cap=cap, nbisect=nbisect, rtol=rtol,
                                 maxiters=maxiters, presplit=self._presplit_for(d_rem),
                                 sync_every=sync_every, kernels=kernels,
                                 stats=cacheval["stats"], level=d_rem, init_pool=init_pool,
                                 seed_width=self.warm_width if d_rem == ndim else self.inner_seed_width,
                                 seed_coarsen=d_rem == ndim if coarsen_seed is None else coarsen_seed,
                                 seed_n=seed_n, return_state=return_state, solve=solve)

    def _fused_dos_leaf(self, cacheval, level, lanes, xk, wk, wg, cap, nbisect):
        """The innermost level of a ``dos_trace`` nest: the rule (K4) that
        starts its pools, and the fused solve that runs them to their ends
        in one launch (:func:`~autobzcore_torch.models.observables.gk_leaf_dos_solve`),
        or None where the nest runs its plain versions (the trip route) or
        the solve does not take the leaf's shape. The solve counts the most
        trips of any lane into the nest's :class:`LoopStats` on the device;
        the nest's entries read them when their solve is done."""
        from ..models.observables import gk_leaf_dos_solve, leaf_dos_rule, leaf_solve_takes

        om, eta = lanes
        car = level.carrier
        args = (car.c, car.cmap, car.offset[0], car.period[0], om, eta, xk, wk, wg)
        rule = leaf_dos_rule(*args, cacheval["kernels"].leaf_dos)
        W = om.shape[1] if om.ndim == 2 else 1
        m = math.isqrt(car.c.shape[-1])
        if self.plain_kernels or not leaf_solve_takes(om.device, cap, W, nbisect, xk.shape[0],
                                                      car.c.shape[1], m):
            return rule, None
        stats = cacheval["stats"]

        def solve(pool, nb):
            stats.device_trip(1, gk_leaf_dos_solve(pool, *args, nb))

        return rule, solve

    def _fixed_level(self, cacheval, level, segs, alg, d_rem, rtol, maxiters):
        """A fixed level (reference ``solve_level`` with a
        ``QuadratureFunction``): every lane's S * npt nodes, solved as the
        lanes of the level below (or, at the leaf, evaluated by the carrier),
        then K17's reduction; the counts are the inner solves' sums (S * npt
        at the leaf), the error 0 and the retcode True."""
        x, w = alg.rule(segs.device)
        nodes, half = fixed_rule_nodes(segs, x)
        L, S, P = nodes.shape
        if d_rem > 1:
            inner, segs2 = level.spawn(nodes.reshape(L, S * P))
            val, _, ne, _ = self._solve_level(cacheval, inner, segs2, d_rem - 1, rtol, maxiters)
            count = torch.sum(ne.reshape(L, S * P), dim=1)
        else:
            val = level.carrier.eval_batch(nodes.reshape(L, S * P), level.coords, level.params)
            if not val.is_complex():
                val = val.to(REAL)
            count = torch.full((L,), float(S * P), dtype=REAL, device=segs.device)
        fx = val.reshape((L, S, P) + tuple(val.shape[2 if d_rem == 1 else 1:])).contiguous()
        out = cacheval["kernels"].fixed_reduce(fx, w, half.contiguous())
        return (out, torch.zeros(L, dtype=REAL, device=segs.device), count,
                torch.ones(L, dtype=torch.bool, device=segs.device))

    def _nonleaf_rule(self, cacheval, level, xk, wk, wg, d_rem, rtol, maxiters, mid_seed=None):
        def rule(ca, cb, active, live):
            if live is None:
                live = active.nonzero().squeeze(1)
            I, P = ca.shape[1], xk.shape[0]
            nodes, half = gk_nodes(ca[live], cb[live], xk)
            inner, segs2 = level.take(live).spawn(nodes.reshape(live.numel(), I * P))
            # a carried partition seeds this level's inner pools, every one
            # with the same live count; it is not passed deeper
            seed = (None, None) if mid_seed is None else _mid_seed_pool(mid_seed, segs2)
            val, _, ne, _ = self._solve_level(cacheval, inner, segs2, d_rem - 1, rtol, maxiters,
                                              init_pool=seed[0], seed_n=seed[1])
            La = live.numel()
            fx = val.reshape((La, I, P) + tuple(val.shape[1:])).contiguous()
            return NodeChildren(fx, ne.reshape(La, I, P).contiguous(), half.contiguous(), live, wk, wg)

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

    # --- the warm form -----------------------------------------------------------
    def _top_level(self, cacheval, params, atol):
        """The outermost level of one solve and its breakpoints (1, S+1)."""
        dom, device = cacheval["dom"], cacheval["device"]
        if params.x is not None:
            if params.x.shape[0] != 1:
                raise ValueError("a warm solve takes one parameter")
            params = LaneParams(params.p, params.x.to(device=device, dtype=REAL), params.merge)
        carrier = cacheval["carrier"]
        if hasattr(carrier, "lanes"):
            carrier = carrier.lanes(1)
        level = _Level(dom, carrier, (), params, torch.full((1,), float(atol), dtype=REAL,
                                                            device=device))
        return level, dom.outer_segments(device).expand(1, -1).contiguous()

    def solve_warm(self, cacheval, params, atol, rtol, maxiters, pool):
        """One solve seeded from the carried :class:`WarmPool` (reference
        ``run_warm``): returns (val (1, *V), err (1,), numevals (1,),
        converged (1,), new_pool). The mid seed passes through unchanged;
        :meth:`harvest` refreshes it."""
        level, segs = self._top_level(cacheval, params, atol)
        init = (pool.a[None], pool.b[None], pool.e[None], pool.n.reshape(1))
        val, err, ne, conv, state = self._solve_level(
            cacheval, level, segs, cacheval["dom"].ndim, float(rtol), maxiters, init_pool=init,
            mid_seed=pool.mid if cacheval["carry_mid"] else None, return_state=True)
        cacheval["stats"].read_device_trips()
        new_pool = WarmPool(state.a[0], state.b[0], state.err[0], state.n[:1].clone(), pool.mid)
        return val, err, ne, conv, new_pool

    def harvest(self, cacheval, params, atol, rtol, maxiters, pool):
        """Refresh the carried mid seed (reference ``harvest_mid``): one solve
        of the level below the outermost at the midpoint of the worst live
        outer interval (the first, on ties), seeded from the mid seed and
        coarsened; its final pool, normalized, is the new mid seed. Returns
        (new_pool, numevals (1,))."""
        level, _ = self._top_level(cacheval, params, atol)
        cap = pool.a.shape[0]
        live = torch.arange(cap, device=pool.a.device) < pool.n
        widx = torch.argmax(torch.where(live, pool.e, -math.inf))
        xh = ((pool.a[widx] + pool.b[widx]) / 2).reshape(1, 1)
        inner, segs2 = level.spawn(xh)
        init, n0 = _mid_seed_pool(pool.mid, segs2)
        _, _, ne, _, state = self._solve_level(
            cacheval, inner, segs2, cacheval["dom"].ndim - 1, float(rtol), maxiters,
            init_pool=init, seed_n=n0, coarsen_seed=True, return_state=True)
        cacheval["stats"].read_device_trips()
        return pool._replace(mid=_mid_seed_norm(state, segs2)), ne

    def solve_fn_warm(self, cacheval):
        """Warm sweep form (reference ``solve_fn_warm``): ``(fn(p, atol, rtol,
        pool) -> (u, resid, converged, numevals, new_pool), pool0)``, ``p`` a
        one-lane :class:`LaneParams` and ``pool0`` the cold
        :class:`WarmPool`. None where the nest has no warm form (the guided
        tier)."""
        if "warm_pool0" not in cacheval:
            return None

        def fn(p, atol, rtol, pool):
            val, err, ne, conv, new_pool = self.solve_warm(cacheval, p, atol, rtol, _budget(None),
                                                           pool)
            return val, err, conv, ne, new_pool

        return fn, cacheval["warm_pool0"]

    def harvest_fn(self, cacheval):
        """Mid-seed refresh form (reference ``harvest_fn``): ``fn(p, atol,
        rtol, pool) -> (new_pool, numevals (1,))``; None where the nest
        carries no mid seed (1-D) or has no warm form."""
        if not cacheval.get("carry_mid"):
            return None

        def fn(p, atol, rtol, pool):
            return self.harvest(cacheval, p, atol, rtol, _budget(None), pool)

        return fn


def _leaf_rule(level, xk, wk, wg):
    """Innermost rule of a generic integrand: the 1-D series (K3) or the
    plain function at the live lanes' nodes and the user function; the
    pool's step (K5) reduces their values."""
    def rule(ca, cb, active, live):
        if live is None:
            live = active.nonzero().squeeze(1)
        I, P = ca.shape[1], xk.shape[0]
        nodes, half = gk_nodes(ca[live], cb[live], xk)
        sub = level.take(live)
        fx = sub.carrier.eval_batch(nodes.reshape(live.numel(), I * P), sub.coords, sub.params)
        fx = fx.reshape((live.numel(), I, P) + tuple(fx.shape[2:]))
        if not fx.is_complex():
            fx = fx.to(REAL)
        return NodeChildren(fx.contiguous(), None, half.contiguous(), live, wk, wg)

    return rule
