"""Iterated integration limits of the symmetry-reduced zones (reference
``autobzcore_tpu/limits.py``).

``load_bz`` records them on the zone; the nested solver iterates them,
fixing the last variable first. Where the reference fixes one traced scalar
per vmapped solve, the port fixes a tensor of per-lane values at once:
``fix(x)`` with ``x`` of shape (N,) gives the limits of N lanes, and their
``outer_segments()`` are (N, S+1) breakpoints, or (S+1,) shared by every
lane. Neither kind's ``fix`` reads per-lane state of its own, so the limits
of a subset of lanes are the same object.
"""
from __future__ import annotations

import numpy as np
import torch

from ._device import REAL


class IteratedLimits:
    pass


class CubicLimits(IteratedLimits):
    """Axis-aligned box as iterated limits."""

    def __init__(self, a, b):
        self.a = tuple(float(x) for x in np.atleast_1d(np.asarray(a, dtype=np.float64)))
        self.b = tuple(float(x) for x in np.atleast_1d(np.asarray(b, dtype=np.float64)))
        if len(self.a) != len(self.b):
            raise ValueError("CubicLimits endpoints must have equal length")

    @property
    def ndim(self):
        return len(self.a)

    def outer_segments(self, device=None):
        return torch.tensor([self.a[-1], self.b[-1]], dtype=REAL, device=device)

    def fix(self, x):
        return CubicLimits(self.a[:-1], self.b[:-1])

    def interior_point(self):
        return np.array([(ai + bi) / 2 for ai, bi in zip(self.a, self.b)])

    def __eq__(self, other):
        return isinstance(other, CubicLimits) and self.a == other.a and self.b == other.b

    def __repr__(self):
        return f"CubicLimits({self.a}, {self.b})"


class TetrahedralLimits(IteratedLimits):
    """Wedge ``0 <= x_1 <= ... <= x_d <= s``; fixing ``x_d = t`` leaves the
    (d-1)-wedge with upper corner ``t``. ``s`` is a number, or a tensor of
    per-lane corners once an outer variable is fixed."""

    def __init__(self, s, ndim=None):
        if isinstance(s, torch.Tensor):
            if ndim is None:
                raise ValueError("TetrahedralLimits(s, ndim) requires ndim for tensor s")
            self.s = s
            self._ndim = int(ndim)
            return
        if np.ndim(s) == 1 or isinstance(s, (tuple, list)):
            s_arr = np.asarray(s, dtype=np.float64)
            if not np.allclose(s_arr, s_arr[0]):
                raise ValueError("TetrahedralLimits currently requires equal corner coordinates")
            ndim = len(s_arr)
            s = s_arr[0]
        if ndim is None:
            raise ValueError("TetrahedralLimits(s, ndim) requires ndim for scalar s")
        self.s = float(s)
        self._ndim = int(ndim)

    @property
    def ndim(self):
        return self._ndim

    def outer_segments(self, device=None):
        s = torch.as_tensor(self.s, dtype=REAL, device=device)
        return torch.stack([torch.zeros_like(s), s], dim=-1)

    def fix(self, x):
        return TetrahedralLimits(x, self._ndim - 1)

    def interior_point(self):
        s = float(self.s) if np.ndim(self.s) == 0 and not isinstance(self.s, torch.Tensor) else 0.5
        # nested midpoints of the wedge
        return np.array([s * (i + 1) / (self._ndim + 1) for i in range(self._ndim)])

    def __eq__(self, other):
        return (isinstance(other, TetrahedralLimits) and self._ndim == other._ndim
                and np.isclose(self.s, other.s))

    def __repr__(self):
        return f"TetrahedralLimits({self.s}, ndim={self._ndim})"
