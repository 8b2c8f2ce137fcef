"""Iterated integration limits of the symmetry-reduced zones (reference
``autobzcore_tpu/limits.py``).

``load_bz`` records them on the zone. The PTR rule does not read them; the
nested adaptive solvers that iterate them (``fix``, ``interior_point``)
arrive with the IAI slice (ROADMAP A5).
"""
from __future__ import annotations

import numpy as np


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

    def __eq__(self, other):
        return isinstance(other, CubicLimits) and self.a == other.a and self.b == other.b

    def __repr__(self):
        return f"CubicLimits({self.a}, {self.b})"


class TetrahedralLimits(IteratedLimits):
    """Wedge ``0 <= x_1 <= ... <= x_d <= s``; fixing ``x_d = t`` leaves the
    (d-1)-wedge with upper corner ``t``."""

    def __init__(self, s, ndim=None):
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

    def __eq__(self, other):
        return (isinstance(other, TetrahedralLimits) and self._ndim == other._ndim
                and np.isclose(self.s, other.s))

    def __repr__(self):
        return f"TetrahedralLimits({self.s}, ndim={self._ndim})"
