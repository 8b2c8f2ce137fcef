"""Fourier/Wannier series and the Fourier integrand (reference
``autobzcore_tpu/fourier.py``).

- :class:`FourierSeries`: dense coefficient tensor on a device, with periods
  and offsets; evaluation at points goes through kernel K1
  (:func:`autobzcore_torch.ops.fourier_eval.fourier_points`).
- :class:`FourierValue`: the ``(x, s)`` pair handed to user kernels.
- :class:`FourierIntegrand`: a user kernel bundled with a series, whose
  series values a PTR rule computes once at its points and reuses across
  solves.
"""
from __future__ import annotations

import numpy as np
import torch
from torch.func import vmap

from ._device import COMPLEX, REAL, as_device
from .ops.fourier_eval import evaluate_points
from .parameters import NullParameters, ParameterIntegrand, merge_parameters


def _tuple_d(v, d, cast):
    if np.ndim(v) == 0:
        return (cast(v),) * d
    t = tuple(cast(x) for x in v)
    if len(t) != d:
        raise ValueError("per-dimension data must have length d")
    return t


class FourierSeries:
    """d-dimensional trigonometric interpolant of (possibly matrix-valued)
    coefficients: ``s(x) = sum_n c[n] exp(2 pi i (n + offset) . x / period)``.

    ``c`` has shape ``(n_1, ..., n_d, *valshape)``; pass ``ndim=d`` when the
    values are arrays (e.g. ``(n1, n2, n3, m, m)`` Wannier Hamiltonians).
    ``offset[j]`` is the frequency of ``c[0, ..., 0]`` along dim j (default:
    centered, ``-(n_j - 1) // 2``). The coefficients live on ``device``.
    """

    def __init__(self, c, period=1.0, offset=None, ndim=None, dtype=COMPLEX, device="cpu"):
        if dtype != COMPLEX:
            raise ValueError("the port evaluates series in complex128 only")
        if not isinstance(c, torch.Tensor):
            c = np.asarray(c)
        self.c = torch.as_tensor(c, dtype=dtype, device=as_device(device)).contiguous()
        d = ndim if ndim is not None else self.c.ndim
        self.sndim = int(d)
        self.period = _tuple_d(period, d, float)
        if offset is None:
            offset = tuple(-((self.c.shape[j] - 1) // 2) for j in range(d))
        self.offset = _tuple_d(offset, d, int)
        self.dtype = dtype

    @property
    def ndim(self):
        return self.sndim

    @property
    def device(self):
        return self.c.device

    @property
    def valshape(self):
        return tuple(self.c.shape[self.sndim:])

    def eval_points(self, X):
        """Values at the points ``X`` (K, d) -> (K, *valshape)."""
        return evaluate_points(self.c, self.sndim, X, self.offset, self.period, None, self.dtype)

    def __call__(self, x):
        x = torch.atleast_1d(torch.as_tensor(x, dtype=REAL, device=self.device))
        return self.eval_points(x[None, :])[0]


class FourierValue:
    """Point ``x`` and evaluated series ``s`` handed to user kernels."""

    def __init__(self, x, s):
        self.x = x
        self.s = s

    def __repr__(self):
        return f"FourierValue(x={self.x!r}, s={self.s!r})"


class FourierIntegrand:
    """``FourierIntegrand(f, s, *args, **kwargs)``: integrand evaluating
    ``f(FourierValue(x, s(x)), *args, **kwargs)``; ``rep=`` declares the
    symmetry representation of its value."""

    def __init__(self, f, s, *args, **kwargs):
        self.rep = kwargs.pop("rep", None)
        self.pf = f if isinstance(f, ParameterIntegrand) else ParameterIntegrand(f, *args, **kwargs)
        if not isinstance(s, FourierSeries):
            raise TypeError("FourierIntegrand requires a FourierSeries")
        self.s = s

    @property
    def p(self):
        return self.pf.p

    @property
    def f(self):
        return self.pf

    def with_parameters(self, p):
        bare = FourierIntegrand(ParameterIntegrand(self.pf.f), self.s)
        bare.rep = self.rep
        return bare, merge_parameters(self.p, p)

    def __call__(self, x, p=NullParameters()):
        x = torch.atleast_1d(torch.as_tensor(x, dtype=REAL, device=self.s.device))
        return self.pf(FourierValue(x, self.s(x)), p)

    # --- PTR rule support --------------------------------------------------
    def series_values_on_grid(self, npt, frac=None):
        """Series values at the PTR rule's points, through kernel K1: the
        whole ``npt^d`` fractional grid when ``frac`` is None (the full
        zone), else the fractional points ``frac`` (K, d), e.g. the symmetry
        representatives of an irreducible zone. Returns (K, *valshape) on
        the series' device."""
        d = self.s.sndim
        if frac is None:
            from .algorithms.ptr import frac_nodes

            frac = frac_nodes(npt, d, self.s.device)
        period = torch.as_tensor(self.s.period, dtype=REAL, device=frac.device)
        return self.s.eval_points((frac * period).contiguous())

    def user_batch_fn(self):
        """``g(xs (K, d), svals (K, ...), p)``: the user kernel vmapped over
        the points and their series values."""
        pf = self.pf

        def one(x, s, q):
            return pf(FourierValue(x, s), q)

        return vmap(one, in_dims=(0, 0, None))
