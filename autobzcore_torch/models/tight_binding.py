"""Tight-binding model builders (reference
``autobzcore_tpu/models/tight_binding.py``) and the flagship synthetic
3-band series. Coefficients are built with numpy and placed on ``device``.
"""
from __future__ import annotations

import numpy as np

from ..fourier import FourierSeries


def integer_lattice(n, coeff=None):
    """Nearest-neighbor hopping coefficients on Z^n: C[+-e_i] = 1/(2n)
    (scalar-valued), centered offsets."""
    coeff = 1.0 / (2 * n) if coeff is None else coeff
    C = np.zeros((3,) * n)
    for i in range(n):
        for j in (0, 2):
            idx = tuple(j if k == i else 1 for k in range(n))
            C[idx] = coeff
    return C


def tb_integer(n, t=1.0, period=1.0, device="cuda"):
    """n-dim integer-lattice tight-binding Hamiltonian as a 1x1 series:
    H(k) = 2t sum_i cos(2 pi k_i)."""
    C = integer_lattice(n, coeff=t)[..., None, None]
    return FourierSeries(C, period=period, offset=(-1,) * n, ndim=n, device=device)


def tb_graphene(t=1.0, period=1.0, device="cuda"):
    """Graphene 2-band tight-binding model on the 2D hexagonal lattice in
    fractional coordinates."""
    C = np.zeros((5, 5, 2, 2), dtype=np.complex128)  # offsets -2..2
    o = 2
    for (i, j, a, b) in ((1, 1, 0, 1), (1, -2, 0, 1), (-2, 1, 0, 1),
                         (-1, -1, 1, 0), (-1, 2, 1, 0), (2, -1, 1, 0)):
        C[i + o, j + o, a, b] = t
    return FourierSeries(C, period=period, offset=(-2, -2), ndim=2, device=device)


def synthetic_wannier(nbands, nr=5, ndim=3, decay=1.0, seed=0, period=1.0, device="cuda"):
    """Random Hermitian-symmetric Wannier-like model: ``nbands`` bands with
    exponentially decaying real-space hoppings on an ``nr^ndim`` R-box."""
    rng = np.random.default_rng(seed)
    shape = (nr,) * ndim
    o = -((nr - 1) // 2)
    C = rng.normal(size=shape + (nbands, nbands)) + 1j * rng.normal(size=shape + (nbands, nbands))
    grids = np.meshgrid(*[np.arange(nr) + o] * ndim, indexing="ij")
    dist = np.sqrt(sum(g.astype(float) ** 2 for g in grids))
    C *= np.exp(-decay * dist)[..., None, None] / np.sqrt(nbands)
    # hermitian symmetry c(-R) = c(R)^dagger by explicit -R pairing; planes
    # whose -R lies outside the box have no partner and are zeroed
    Ch = np.zeros_like(C)
    for i in np.indices(shape).reshape(ndim, -1).T:
        p = -(i + o) - o  # index of -R
        if np.all((p >= 0) & (p < nr)):
            Ch[tuple(i)] = (C[tuple(i)] + C[tuple(p)].conj().T) / 2
    return FourierSeries(Ch, period=period, offset=(o,) * ndim, ndim=ndim, device=device)


def flagship_series(device="cuda"):
    """The flagship's synthetic 3-band Hermitian series: 5x5x5 real
    coefficients from ``numpy.random.default_rng(0)`` with a radial decay,
    symmetrized so that H(k) is Hermitian. It has the footprint of the SrVO3
    Wannier model and no point symmetry, so it is integrated on the full
    zone. The same seed and construction as the JAX package's synthetic
    flagship fallback, so both packages see identical coefficients."""
    rng = np.random.default_rng(0)
    C = rng.normal(size=(5, 5, 5, 3, 3)) * np.exp(
        -np.linalg.norm(np.mgrid[-2:3, -2:3, -2:3], axis=0)
    )[..., None, None]
    C = (C + np.flip(C, axis=(0, 1, 2)).conj().swapaxes(-1, -2)) / 2
    return FourierSeries(C, period=1.0, offset=(-2, -2, -2), ndim=3, device=device)
