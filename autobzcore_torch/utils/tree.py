"""Tree arithmetic and norms for integral results.

Results are tensors or (nested) tuples, lists and dicts of tensors; these
helpers map over the leaves (reference ``autobzcore_tpu/utils/tree.py``).
"""
from __future__ import annotations

import operator

import torch


def tree_map(fn, *trees):
    """Apply ``fn`` leafwise over trees of identical structure."""
    t0 = trees[0]
    if isinstance(t0, (tuple, list)):
        return type(t0)(tree_map(fn, *xs) for xs in zip(*trees))
    if isinstance(t0, dict):
        return {k: tree_map(fn, *(t[k] for t in trees)) for k in t0}
    return fn(*trees)


def tree_leaves(tree):
    if isinstance(tree, (tuple, list)):
        return [leaf for x in tree for leaf in tree_leaves(x)]
    if isinstance(tree, dict):
        return [leaf for k in tree for leaf in tree_leaves(tree[k])]
    return [tree]


def tree_add(a, b):
    return tree_map(operator.add, a, b)


def tree_sub(a, b):
    return tree_map(operator.sub, a, b)


def tree_scale(s, a):
    return tree_map(lambda x: s * x, a)


def tree_weighted_sum(w, a, axis=0):
    """``sum_i w[i] * a[i]`` along ``axis`` with ``w`` broadcast over the
    trailing dimensions of each leaf."""

    def leaf(x):
        wshape = tuple(w.shape) + (1,) * (x.ndim - w.ndim)
        return torch.sum(w.reshape(wshape) * x, dim=axis)

    return tree_map(leaf, a)


def tree_norm(a):
    """2-norm over all flattened leaves (the reference's default ``norm``)."""
    leaves = tree_leaves(a)
    if not leaves:
        return torch.zeros((), dtype=torch.float64)
    sq = sum(torch.sum(torch.abs(torch.as_tensor(x)) ** 2) for x in leaves)
    return torch.sqrt(sq)


def tree_batched_norm(a, batch_ndim=1):
    """Per-batch-element 2-norm: leaves have shape (B, ...); returns (B,)."""
    sq = None
    for x in tree_leaves(a):
        term = torch.abs(x) ** 2
        if x.ndim > batch_ndim:
            term = torch.sum(term, dim=tuple(range(batch_ndim, x.ndim)))
        sq = term if sq is None else sq + term
    return torch.sqrt(sq)
