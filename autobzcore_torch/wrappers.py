"""Integrand wrapper protocol (reference ``autobzcore_tpu/wrappers.py``).

``batch_eval_fn`` turns a pointwise integrand into one over a batch of nodes
with ``torch.func.vmap``; a :class:`BatchIntegrand` is called on the batch
as it is.
"""
from __future__ import annotations

import torch
from torch.func import vmap


class InplaceIntegrand:
    """``f(y, x, p) -> y``: integrand filling a zero tensor shaped like
    ``result_prototype`` and returning it."""

    def __init__(self, f, result_prototype):
        self.f = f
        self.result_prototype = result_prototype

    def to_pure(self):
        proto = torch.as_tensor(self.result_prototype)

        def pure(x, p):
            return self.f(torch.zeros_like(proto), x, p)

        return pure


class BatchIntegrand:
    """``f(xs, p) -> ys`` evaluating many nodes at once; ``xs`` and ``ys``
    carry a leading batch axis."""

    def __init__(self, f, max_batch=None):
        self.f = f
        self.max_batch = max_batch


def batch_eval_fn(f, in_ndim=0):
    """``g(xs, p) -> ys`` evaluating ``f`` on a batch of nodes ``xs`` of shape
    ``(B,)`` (``in_ndim=0``) or ``(B, d)`` (``in_ndim=1``)."""
    if isinstance(f, BatchIntegrand):
        return f.f
    g = f.to_pure() if isinstance(f, InplaceIntegrand) else f
    return vmap(g, in_dims=(0, None))


def unwrap_integrand(f):
    """Plain pointwise callable for probe evaluations and fixed rules."""
    if isinstance(f, InplaceIntegrand):
        return f.to_pure()
    if isinstance(f, BatchIntegrand):
        def pointwise(x, p):
            return f.f(torch.as_tensor(x)[None], p)[0]

        return pointwise
    return f
