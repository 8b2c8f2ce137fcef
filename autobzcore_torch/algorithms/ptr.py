"""Fixed-npt periodic trapezoidal rule over a lattice Basis (reference
``autobzcore_tpu/algorithms/ptr.py``).

The rule's points and weights are built once per cache: the full ``npt^d``
grid, or on a symmetric zone the host-computed orbit representatives and
their orbit sizes (:func:`~autobzcore_torch.ops.symptr.symptr_rule`). For a
:class:`FourierIntegrand` the series is evaluated once at the rule points
(kernel K1) and reused across solves. A FourierIntegrand over this
package's ``dos_trace`` then sums through kernel K2; any other integrand is
evaluated over the points by ``torch.func.vmap`` and summed with weights.
The p-adaptive ``AutoSymPTRJL`` comes with a later slice (ROADMAP A4).
"""
from __future__ import annotations

import inspect

import torch

from .._device import REAL, as_device
from ..domains import Basis
from ..interfaces import IntegralSolution
from ..ops.symptr import symptr_rule
from ..utils.tree import tree_map, tree_weighted_sum
from ..wrappers import batch_eval_fn
from .base import IntegralAlgorithm


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


def _uses_dos_kernel(f):
    from ..fourier import FourierIntegrand
    from ..models.observables import dos_trace

    return isinstance(f, FourierIntegrand) and f.pf.f is dos_trace


def _dos_lanes(p, device):
    """(omega, eta, shape): the frequencies and broadenings of a
    ``dos_trace`` call with parameters ``p``, broadcast together and
    flattened into lanes, with the broadcast shape to restore."""
    from ..models.observables import dos_trace

    bound = inspect.signature(dos_trace).bind(None, *p.args, **p.kwargs)
    om, eta = bound.arguments["om"], bound.arguments.get("eta")
    if eta is None:
        raise TypeError("dos_trace needs eta")
    om = torch.as_tensor(om, dtype=REAL, device=device)
    eta = torch.as_tensor(eta, dtype=REAL, device=device)
    om, eta = torch.broadcast_tensors(om, eta)
    return om.reshape(-1).contiguous(), eta.reshape(-1).contiguous(), om.shape


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

    if _uses_dos_kernel(f):
        H = f.series_values_on_grid(npt, frac)
        m = H.shape[-1]
        H = H.reshape(-1, m, m)
        consts = (weights, H)

        def run_c(consts, p):
            w, H = consts
            om, eta, shape = _dos_lanes(p, H.device)
            # deferred import: the models package imports the BZ layer
            from ..models.observables import dos_trace_weighted_sum

            return dos_trace_weighted_sum(H, w, om, eta, scale).reshape(shape)
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
