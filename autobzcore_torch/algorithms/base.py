"""Algorithm extension contract (reference
``autobzcore_tpu/algorithms/base.py``): ``init_cacheval`` precomputes rule
data once, ``do_solve`` runs a solve at new parameters."""
from __future__ import annotations

import numpy as np


class IntegralAlgorithm:
    def init_cacheval(self, f, dom, p):
        raise NotImplementedError

    def do_solve(self, f, dom, p, cacheval, abstol=None, reltol=None, maxiters=None):
        raise NotImplementedError


def effective_tolerances(abstol, reltol, dtype=np.float64):
    """Both unset -> pure relative with sqrt(eps); otherwise unset ones are
    zero."""
    if abstol is None and reltol is None:
        return 0.0, float(np.sqrt(np.finfo(dtype).eps))
    return (0.0 if abstol is None else float(abstol),
            0.0 if reltol is None else float(reltol))


def segments_of(dom):
    """Breakpoints of a 1D domain: a raw tuple or array of endpoints (the
    ``IntegralProblem(f, a, b)`` form). ``PuncturedInterval`` is not ported
    yet (ROADMAP A1)."""
    if type(dom).__name__ == "PuncturedInterval":
        raise NotImplementedError("PuncturedInterval domains are not ported yet (ROADMAP A1)")
    segs = np.asarray(dom, dtype=np.float64)
    if segs.ndim != 1 or segs.shape[0] < 2:
        raise ValueError(f"a 1D domain needs at least two breakpoints, got {dom!r}")
    return segs
