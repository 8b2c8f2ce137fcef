"""Integration domains (reference ``autobzcore_tpu/domains.py``).

Domains are host-side data: their endpoints shape the rule, so they stay
numpy arrays rather than tensors.
"""
from __future__ import annotations

import numpy as np


class Domain:
    pass


class HyperCube(Domain):
    """Axis-aligned box spanned by vertices ``a``, ``b``."""

    def __init__(self, a, b):
        self.a = np.atleast_1d(np.asarray(a, dtype=np.float64))
        self.b = np.atleast_1d(np.asarray(b, dtype=np.float64))
        if self.a.shape != self.b.shape:
            raise ValueError("HyperCube endpoints must have the same length")

    @property
    def endpoints(self):
        return (self.a, self.b)

    @property
    def ndim(self):
        return self.a.shape[0]

    def __repr__(self):
        return f"HyperCube({self.a}, {self.b})"


class Basis(Domain):
    """Lattice basis domain: the parallelepiped spanned by the columns of
    ``B`` (periodic trapezoidal rules sample fractional coordinates in
    ``[0,1)^d`` and map them through ``B``)."""

    def __init__(self, B):
        B = np.asarray(B, dtype=np.float64)
        if B.ndim == 0:
            B = B.reshape(1, 1)
        elif B.ndim == 1:
            B = np.diag(B)
        if B.shape[0] != B.shape[1]:
            raise ValueError("Basis matrix must be square")
        self.B = B

    @property
    def ndim(self):
        return self.B.shape[0]

    @property
    def volume(self):
        return abs(np.linalg.det(self.B))

    def __repr__(self):
        return f"Basis({self.B})"
