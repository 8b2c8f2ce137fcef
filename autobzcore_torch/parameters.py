"""Parameter containers and the ParameterIntegrand protocol (reference
``autobzcore_tpu/parameters.py``).

A PTR sweep hands its lanes to one solve as one tensor whose leading axis is
the lane axis. Adaptive solvers run one solve per lane instead; their lanes'
parameters travel as :class:`LaneParams`.
"""
from __future__ import annotations

from torch.func import vmap


class NullParameters:
    """Singleton representing absent parameters."""

    _instance = None

    def __new__(cls):
        if cls._instance is None:
            cls._instance = super().__new__(cls)
        return cls._instance

    def __repr__(self):
        return "NullParameters()"


class MixedParameters:
    """Container for positional ``args`` and keyword ``kwargs`` parameters:
    ``p[i]`` reads a positional argument, ``p.name`` a keyword."""

    def __init__(self, *args, **kwargs):
        object.__setattr__(self, "args", tuple(args))
        object.__setattr__(self, "kwargs", dict(kwargs))

    def __getitem__(self, i):
        return self.args[i]

    def __getattr__(self, name):
        try:
            return object.__getattribute__(self, "kwargs")[name]
        except KeyError:
            raise AttributeError(name) from None

    def __len__(self):
        return len(self.args)

    def __repr__(self):
        kw = ", ".join(f"{k}={v!r}" for k, v in self.kwargs.items())
        pos = ", ".join(repr(a) for a in self.args)
        return f"MixedParameters({', '.join(x for x in (pos, kw) if x)})"

    def __eq__(self, other):
        return (
            isinstance(other, MixedParameters)
            and self.args == other.args
            and self.kwargs == other.kwargs
        )


def merge_parameters(p, q):
    """Positional args append, keyword args overwrite (the reference's
    ``merge`` algebra)."""
    if isinstance(q, NullParameters):
        return p
    if isinstance(p, NullParameters):
        p = MixedParameters()
    if not isinstance(p, MixedParameters):
        p = MixedParameters(p)
    if isinstance(q, MixedParameters):
        return _mk(p.args + q.args, {**p.kwargs, **q.kwargs})
    if isinstance(q, dict):
        return _mk(p.args, {**p.kwargs, **q})
    if isinstance(q, tuple):
        return _mk(p.args + q, p.kwargs)
    return _mk(p.args + (q,), p.kwargs)


def _mk(args, kwargs):
    p = MixedParameters(*args)
    object.__setattr__(p, "kwargs", kwargs)
    return p


class ParameterIntegrand:
    """Partially applied integrand ``f(x, *args, **kwargs)``; called with
    ``(x, p)`` it merges the preset parameters with ``p``."""

    def __init__(self, f, *args, **kwargs):
        self.f = f
        self.p = MixedParameters(*args, **kwargs)

    def __call__(self, x, p=NullParameters()):
        q = merge_parameters(self.p, p)
        return self.f(x, *q.args, **q.kwargs)

    def with_parameters(self, p):
        """(bare integrand, merged parameters) for cache re-solves."""
        return ParameterIntegrand(self.f), merge_parameters(self.p, p)


class LaneParams:
    """Parameters of a batch of independent solves: ``p`` is shared by every
    lane, and ``x`` (L,) or None holds one value per lane, merged into ``p``
    as the next positional argument (``merge``, for ParameterIntegrand and
    FourierIntegrand problems) or standing alone as the lane's parameter."""

    def __init__(self, p, x=None, merge=True):
        self.p = p
        self.x = x
        self.merge = merge

    def take(self, idx):
        """The parameters of the lanes ``idx``."""
        return self if self.x is None else LaneParams(self.p, self.x[idx], self.merge)

    def at(self, xv):
        """One lane's parameter, for the value ``xv`` of ``x``."""
        return merge_parameters(self.p, xv) if self.merge else xv

    def merged(self):
        """The shared parameters with the whole lane vector merged in."""
        return self.p if self.x is None else self.at(MixedParameters(self.x) if self.merge else self.x)

    def batch_params(self, lanes):
        """The parameter a batched integrand gets for points of the lanes
        ``lanes`` (N,): the shared ``p`` when no lane is swept, else the (N,)
        tensor of the points' lane values (merged into ``p`` where the lanes
        merge), which is what ``map_points`` hands ``g`` point by point."""
        return self.p if self.x is None else self.at(self.x[lanes])

    def map_points(self, g, args, lanes):
        """``g(*point_args, q)`` over points, vectorized: ``args`` are tensors
        with a leading point axis and ``lanes`` (N,) names each point's lane,
        whose parameter ``q`` the point gets."""
        if self.x is None:
            return vmap(lambda *a: g(*a, self.p))(*args)
        return vmap(lambda *a: g(*a[:-1], self.at(a[-1])))(*args, self.x[lanes])
