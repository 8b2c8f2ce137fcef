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
