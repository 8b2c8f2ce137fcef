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


def tb_haldane(t1=1.0, t2=0.2, phi=np.pi / 2, M=0.0, period=1.0, device="cuda"):
    """Haldane model on the honeycomb lattice in fractional coordinates, the
    canonical Chern insulator (Haldane, PRL 61, 2015 (1988)); topological for
    ``|M| < 3 sqrt(3) |t2 sin phi|``. Blocks: ``H_AB(u) = t1 (1 + e^{-2 pi i
    u1} + e^{-2 pi i u2})``; ``H_AA = M + 2 t2 sum_i cos(2 pi b_i . u +
    phi)`` and ``H_BB = -M + 2 t2 sum_i cos(2 pi b_i . u - phi)`` over
    ``b = (1, 0), (-1, 1), (0, -1)``."""
    C = np.zeros((3, 3, 2, 2), dtype=np.complex128)  # offsets -1..1
    o = 1

    def add(i, j, a, b, val):
        C[i + o, j + o, a, b] += val

    # nearest-neighbor A->B (and the hermitian transpose entries)
    for (i, j) in ((0, 0), (-1, 0), (0, -1)):
        add(i, j, 0, 1, t1)
        add(-i, -j, 1, 0, t1)
    add(0, 0, 0, 0, M)
    add(0, 0, 1, 1, -M)
    # NNN with the Haldane phase: +phi on A, -phi on B
    for (i, j) in ((1, 0), (-1, 1), (0, -1)):
        add(i, j, 0, 0, t2 * np.exp(1j * phi))
        add(-i, -j, 0, 0, t2 * np.exp(-1j * phi))
        add(i, j, 1, 1, t2 * np.exp(-1j * phi))
        add(-i, -j, 1, 1, t2 * np.exp(1j * phi))
    return FourierSeries(C, period=period, offset=(-1, -1), ndim=2, device=device)


def tb_kane_mele_sz(t1=1.0, lam_so=0.1, M=0.0, period=1.0, device="cuda"):
    """S_z-conserving Kane-Mele model (quantum spin Hall; Kane & Mele, PRL
    95, 226801 (2005)) as a 4-band block-diagonal series: spin-up = Haldane
    with ``phi = +pi/2, t2 = lam_so``, spin-down its time reverse (``phi =
    -pi/2``). Basis order (A-up, B-up, A-dn, B-dn); ``O = diag(1, 1, -1,
    -1)/2`` is the spin operator. Spin Chern number ``(C_up - C_dn)/2 = -1``
    in the topological phase (``|M| < 3 sqrt(3) lam_so``)."""
    up = tb_haldane(t1=t1, t2=lam_so, phi=np.pi / 2, M=M, device="cpu").c.numpy()
    dn = tb_haldane(t1=t1, t2=lam_so, phi=-np.pi / 2, M=M, device="cpu").c.numpy()
    C = np.zeros(up.shape[:2] + (4, 4), dtype=np.complex128)
    C[..., :2, :2] = up
    C[..., 2:, 2:] = dn
    return FourierSeries(C, period=period, offset=(-1, -1), ndim=2, device=device)


def tb_kane_mele(t1=1.0, lam_so=0.1, lam_r=0.0, M=0.0, period=1.0, device="cuda"):
    """Full Kane-Mele model with the Rashba term (PRL 95, 226801 (2005)),
    basis (A-up, B-up, A-dn, B-dn). ``lam_r`` breaks S_z conservation, so
    the spin Hall response dequantizes while the Z2 invariant stays 1 until
    the gap closes; ``lam_r=0`` is :func:`tb_kane_mele_sz` exactly. NN bond
    unit vectors (Cartesian, for the ``s x d`` Rashba form): ``(0, 1)`` for
    R = (0, 0), ``(-s3/2, -1/2)`` for R = (-1, 0), ``(s3/2, -1/2)`` for
    R = (0, -1), s3 = sqrt(3)."""
    C = np.zeros((3, 3, 4, 4), dtype=np.complex128)
    o = 1
    sx = np.array([[0, 1], [1, 0]], dtype=np.complex128)
    sy = np.array([[0, -1j], [1j, 0]])

    def add(i, j, blk):  # blk 4x4 in (A-up, B-up, A-dn, B-dn), with its hermitian pair
        C[i + o, j + o] += blk
        C[-i + o, -j + o] += blk.conj().T

    def ab_spin(spin_mat):  # a 2x2 spin matrix on the A->B sublattice hop
        blk = np.zeros((4, 4), dtype=np.complex128)
        for s1 in range(2):
            for s2 in range(2):
                blk[2 * s1 + 0, 2 * s2 + 1] = spin_mat[s1, s2]
        return blk

    s3 = np.sqrt(3.0)
    bonds = (((0, 0), (0.0, 1.0)), ((-1, 0), (-s3 / 2, -0.5)), ((0, -1), (s3 / 2, -0.5)))
    for (i, j), (dx, dy) in bonds:
        add(i, j, ab_spin(t1 * np.eye(2) + 1j * lam_r * (sx * dy - sy * dx)))
    # on-site mass +M on A, -M on B; half here, since add() adds the hermitian pair at R = 0
    add(0, 0, np.diag([M, -M, M, -M]).astype(np.complex128) / 2)
    # NNN spin-orbit: +phi for up, -phi for down with phi = pi/2 -> i lam_so
    for (i, j) in ((1, 0), (-1, 1), (0, -1)):
        blk = np.zeros((4, 4), dtype=np.complex128)
        for sl in (0, 1):  # A-A and B-B, opposite signs
            sgn = 1.0 if sl == 0 else -1.0
            blk[0 + sl, 0 + sl] += 1j * sgn * lam_so
            blk[2 + sl, 2 + sl] += -1j * sgn * lam_so
        add(i, j, blk)
    return FourierSeries(C, period=period, offset=(-1, -1), ndim=2, device=device)


def tb_weyl(m=2.0, period=1.0, device="cuda"):
    """Minimal two-band Weyl semimetal on the cubic lattice: ``H = sin(2 pi
    k1) sx + sin(2 pi k2) sy + (m - sum_i cos(2 pi k_i)) sz``. For ``1 < m <
    3`` one pair of Weyl nodes sits on the k3 axis at ``cos(2 pi k3) = m -
    2``; the k3-slice Chern number is -1 between the nodes and 0 outside."""
    C = np.zeros((3, 3, 3, 2, 2), dtype=np.complex128)
    o = 1
    sx = np.array([[0, 1], [1, 0]], dtype=np.complex128)
    sy = np.array([[0, -1j], [1j, 0]])
    sz = np.array([[1, 0], [0, -1]], dtype=np.complex128)
    # sin(2 pi k1) sx = (e^{i} - e^{-i})/(2i): C[+e1] = sx/(2i), C[-e1] = -sx/(2i)
    C[o + 1, o, o] += sx / 2j
    C[o - 1, o, o] += -sx / 2j
    C[o, o + 1, o] += sy / 2j
    C[o, o - 1, o] += -sy / 2j
    C[o, o, o] += m * sz
    for ax in range(3):
        for s in (+1, -1):
            idx = [o, o, o]
            idx[ax] += s
            C[tuple(idx)] += -sz / 2
    return FourierSeries(C, period=period, offset=(-1, -1, -1), ndim=3, device=device)
