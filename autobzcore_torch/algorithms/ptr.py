"""Periodic trapezoidal rules over a lattice Basis (reference
``autobzcore_tpu/algorithms/ptr.py``).

The rule's points and weights are built once per cache: the full ``npt^d``
grid, or on a symmetric zone the host-computed orbit representatives and
their orbit sizes (:func:`~autobzcore_torch.ops.symptr.symptr_rule`). For a
:class:`FourierIntegrand` the series is evaluated once at the rule points
(kernel K1) and reused across solves. A module whose integrand has a kernel
sum registers it here (:func:`register_kernel_sum`; ``models.observables``
registers ``dos_trace``, ``spectral_function`` and the batched transport
integrand), and the rule then runs that sum, which takes a sweep's lane
vector of parameters in one launch. Any other integrand is evaluated over the points by ``torch.func.vmap``
(a ``batched`` one takes them all at once) and summed with weights.

``AutoSymPTRJL`` is the p-adaptive rule (reference ``autosymptr``): a host
ladder of fixed-npt rules, each rung's value tested against the oldest of
the last ``keepmost`` ones, one host read a rung, the rules cached per npt.
It has no ``solve_fn``: sweeps run it through ``sweep_solve``'s batched
ladder (``parallel/sweep.py``).
"""
from __future__ import annotations

import numpy as np
import torch

from .._device import REAL, as_device
from ..domains import Basis
from ..interfaces import IntegralSolution
from ..ops.symptr import symptr_rule
from ..utils.tree import tree_map, tree_norm, tree_sub, tree_weighted_sum
from ..wrappers import batch_eval_fn
from .base import IntegralAlgorithm, effective_tolerances


def frac_nodes(npt, d, device):
    """Full tensor grid of fractional coordinates, shape (npt^d, d), in C
    order of the grid index."""
    u = torch.arange(npt, dtype=REAL, device=device) / npt
    grids = torch.meshgrid(*([u] * d), indexing="ij")
    return torch.stack([g.reshape(-1) for g in grids], dim=-1)


def rule_points(npt, d, syms, device):
    """The PTR rule's points and weights: fractional coordinates (K, d) and
    float64 weights (K,) on ``device``, the full ``npt^d`` grid with unit
    weights when ``syms`` is None, else the orbit representatives and their
    orbit sizes."""
    if syms is None:
        frac = frac_nodes(npt, d, device)
        return frac, torch.ones(frac.shape[0], dtype=REAL, device=device)
    reps, w = symptr_rule(npt, d, syms)
    frac = torch.as_tensor(reps, device=device).to(REAL) / npt
    return frac, torch.as_tensor(w, dtype=REAL, device=device)


_KERNEL_SUMS = {}


def register_kernel_sum(fn, series_type, build):
    """Register the PTR rule's kernel sum of a FourierIntegrand over ``fn``
    whose series is a ``series_type``: ``build(f, frac, weights, npt,
    scale)`` returns ``(consts, run_c(consts, p))``, the rule's data once,
    then a solve at parameters ``p`` that may carry a lane vector."""
    _KERNEL_SUMS[fn] = (series_type, build)


def kernel_sum(f):
    """The registered kernel sum of a PTR rule over ``f``, or None."""
    from ..fourier import FourierIntegrand

    if not isinstance(f, FourierIntegrand):
        return None
    series_type, build = _KERNEL_SUMS.get(f.pf.f, (None, None))
    return build if isinstance(f.s, series_type or ()) else None


def takes_lane_vector(f):
    """True when a fixed rule's solve of ``f`` takes a sweep's lane vector of
    parameters at once: every integrand that broadcasts over it, and the
    kernel sums; a ``batched`` integrand, which takes one parameter for all
    its points, is solved a lane at a time."""
    return not getattr(f, "batched", False) or kernel_sum(f) is not None


def build_ptr_run(f, dom: Basis, npt: int, syms, device="cuda"):
    """Build a fixed-npt PTR sum for integrand ``f`` over ``dom``.

    Returns ``(run(p), numevals, run_c(consts, p), consts)``. The value is
    the scaled sum vol/(npt^d nsyms) * sum_i w_i f(x_i); the BZ layer maps
    it to the full zone. For a FourierIntegrand the rule lives on the
    series' device, otherwise on ``device``.
    """
    from ..fourier import FourierIntegrand

    d = dom.ndim
    if isinstance(f, FourierIntegrand):
        device = f.s.device
    device = as_device(device)
    frac, weights = rule_points(npt, d, syms, device)
    nsyms = 1 if syms is None else len(syms)
    scale = dom.volume / (npt**d * nsyms)
    numevals = frac.shape[0]
    B = torch.as_tensor(dom.B, dtype=REAL, device=device)

    build = kernel_sum(f)
    if build is not None:
        consts, run_c = build(f, frac, weights, npt, scale)
    elif isinstance(f, FourierIntegrand):
        svals = f.series_values_on_grid(npt, frac)
        user = f.user_batch_fn()
        consts = (frac @ B.T, weights, svals)

        def run_c(consts, p):
            xs, w, sv = consts
            return tree_map(lambda v: scale * v, tree_weighted_sum(w, user(xs, sv, p)))
    else:
        batch_f = batch_eval_fn(f, in_ndim=1)
        consts = (frac @ B.T, weights)

        def run_c(consts, p):
            nodes, w = consts
            return tree_map(lambda v: scale * v, tree_weighted_sum(w, batch_f(nodes, p)))

    def runner(p):
        return run_c(consts, p)

    return runner, numevals, run_c, consts


class MonkhorstPack(IntegralAlgorithm):
    """Fixed-npt periodic trapezoidal rule over a lattice ``Basis``; with
    ``syms`` the sum runs over host-computed weighted representatives.
    ``device`` (the card by default) places the rule of integrands that
    carry no series."""

    def __init__(self, npt=50, syms=None, device="cuda"):
        self.npt = npt
        self.syms = syms
        self.device = as_device(device)

    def init_cacheval(self, f, dom, p):
        run, numevals, run_c, consts = build_ptr_run(f, dom, self.npt, self.syms, self.device)
        return {"run": run, "numevals": numevals, "run_c": run_c, "consts": consts,
                "device": consts[0].device}

    def do_solve(self, f, dom, p, cacheval, abstol=None, reltol=None, maxiters=None):
        return IntegralSolution(cacheval["run"](p), None, True, cacheval["numevals"])

    def solve_fn(self, cacheval, lanes=False):
        """fn(p, atol, rtol) -> (u, resid, converged, numevals); ``lanes`` is
        accepted for the BZ layer's signature (``p`` may carry a lane axis)."""
        fn, consts = self.solve_fn_consts(cacheval, lanes)
        return lambda p, atol, rtol: fn(consts, p, atol, rtol)

    def solve_fn_consts(self, cacheval, lanes=False):
        """(fn(consts, p, atol, rtol) -> (u, resid, converged, numevals),
        consts); ``lanes`` is accepted for the BZ layer's signature."""
        run_c = cacheval["run_c"]
        ne = cacheval["numevals"]

        def fn(consts, p, atol, rtol):
            return run_c(consts, p), 0.0, True, ne

        return fn, cacheval["consts"]


class AutoSymPTRJL(IntegralAlgorithm):
    """p-adaptive PTR: refine npt until the change between rules meets the
    tolerance (reference ``AutoSymPTRJL``, ``autosymptr``).

    The ladder honours ``(a, n0, dn, nmin, nmax)``: ``npt0 = clip(round(n0 /
    a), nmin, nmax)``, then steps of ``dnpt = max(1, round(exp(dn) / a))`` up
    to ``nmax``, ``a`` being the integrand's localization ratio (period /
    feature width). The residual compares the newest rung with the oldest
    of the last ``keepmost`` ones (2: the successive difference). Each rung's
    rule is built once and cached in the cacheval, so re-solves at new
    parameters reuse it (on the card every cached rung keeps its series
    values, or a transport rule its velocity pack, alive).

    With ``bz`` set (the BZ layer's AutoPTR does this) every rung's value is
    symmetrized to the full zone before the test, and the returned value is
    already symmetrized (``symmetrized_output``). ``device`` (the card by
    default) places the rules of integrands that carry no series.
    """

    def __init__(self, norm=tree_norm, a=1.0, nmin=50, nmax=1000, n0=6.0, dn=np.log(10.0), keepmost=2,
                 syms=None, bz=None, device="cuda"):
        self.norm = norm
        self.a = a
        self.nmin = nmin
        self.nmax = nmax
        self.n0 = n0
        self.dn = dn
        self.keepmost = max(2, int(keepmost))
        self.syms = syms
        self.bz = bz
        self.device = as_device(device)

    @property
    def symmetrized_output(self):
        return self.bz is not None

    def npt_ladder(self):
        npt0 = int(np.clip(round(self.n0 / self.a), self.nmin, self.nmax))
        dnpt = max(1, int(round(np.exp(self.dn) / self.a)))
        ladder = [npt0]
        while ladder[-1] < self.nmax:
            ladder.append(min(ladder[-1] + dnpt, self.nmax))
        return ladder

    def _symmetrizer(self, f):
        if self.bz is None:
            return lambda v: v
        from ..brillouin import symmetrize

        return lambda v: symmetrize(f, self.bz, v)

    def init_cacheval(self, f, dom, p):
        return {"rules": {}, "f": f, "dom": dom}

    def do_solve(self, f, dom, p, cacheval, abstol=None, reltol=None, maxiters=None):
        atol, rtol = effective_tolerances(abstol, reltol)
        rules = cacheval["rules"]
        sym = self._symmetrizer(f)
        window = []  # the last `keepmost` symmetrized iterates
        total_evals = 0
        val = None
        err = None
        for npt in self.npt_ladder():
            if npt not in rules:
                rules[npt] = build_ptr_run(f, dom, npt, self.syms, self.device)[:2]
            run, ne = rules[npt]
            val = sym(run(p))
            total_evals += ne
            if window:
                err = self.norm(tree_sub(val, window[0]))
                tol = max(atol, rtol * float(self.norm(val)))
                if float(err) <= tol:  # one host read a rung
                    return IntegralSolution(val, err, True, total_evals)
            if maxiters is not None and total_evals >= maxiters:
                break
            window.append(val)
            if len(window) >= self.keepmost:
                window.pop(0)
        return IntegralSolution(val, err, False, total_evals)
