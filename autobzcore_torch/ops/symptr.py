"""Symmetry reduction of periodic-trapezoidal-rule grids (host side).

Native equivalent of ``AutoSymPTR.symptr_rule`` (observed surface: reference
``src/fourier.jl:271`` — reduce an ``npt^d`` fractional-coordinate grid under a
point group to weighted representatives).  Rule construction is irregular
integer work and runs on host numpy; the resulting representative index/weight
arrays are copied to the device once, when the rule is built.

Point-group operations must map the grid to itself, i.e. be integer matrices in
the lattice (fractional) basis — true for all crystallographic point groups in
that basis, and validated here.
"""
from __future__ import annotations

import numpy as np


def ptr_points(npt: int, dtype=np.float64):
    """Equispaced periodic nodes 0, 1/npt, ..., (npt-1)/npt on [0,1)."""
    return np.arange(npt, dtype=dtype) / npt


def as_integer_syms(syms):
    """Validate and convert symmetry matrices to integer form."""
    S = np.asarray(syms)
    Si = np.rint(S).astype(np.int64)
    if not np.allclose(S, Si, atol=1e-8):
        raise ValueError(
            "symmetry operations must be integer matrices in the lattice basis "
            "to act on a PTR grid"
        )
    return Si


def symptr_rule(npt: int, d: int, syms, chunk: int = 1 << 20):
    """Reduce the ``npt^d`` grid under the group ``syms`` ((S, d, d) matrices).

    Returns ``(reps, weights)``: representative grid indices (K, d) int32 and
    orbit sizes (K,) float64, with ``sum(weights) == npt**d``.  Representatives
    are the orbit members with minimal C-order linear index.

    The canonicalization inner loop runs in the native C++ kernel
    (``native/symptr.cpp``, OpenMP) when available, else chunked numpy.
    """
    reps, counts, _ = _symptr_reduce(npt, d, syms, chunk, want_map=False)
    return reps, counts


def symptr_orbit_map(npt: int, d: int, syms, chunk: int = 1 << 20):
    """Like :func:`symptr_rule` but additionally returns ``full2rep``: for
    every grid point (C-order linear index) the position of its orbit
    representative in ``reps`` — the scatter map that reconstructs full-grid
    per-point data from representative-only evaluations."""
    return _symptr_reduce(npt, d, syms, chunk, want_map=True)


def _is_full_cubic_group(syms_int, d):
    """True iff ``syms_int`` is exactly the 2^d d! signed-permutation group."""
    import math

    if len(syms_int) != (2**d) * math.factorial(d):
        return False
    want = {m.astype(np.int64).tobytes() for m in as_integer_syms(cube_automorphism_syms(d))}
    got = {m.astype(np.int64).tobytes() for m in syms_int.astype(np.int64)}
    return want == got


def _cubic_rule_direct(npt, d):
    """Closed-form symmetry reduction for the full cube automorphism group:
    representatives are sorted tuples 0 <= v_1 <= ... <= v_d <= npt//2 and
    orbit sizes follow from stabilizer counting — O(K) with K ~ npt^d / |G|,
    no N x |G| canonicalization sweep.

    Derivation: sign flips map c -> (npt - c) mod npt, so each coordinate
    canonicalizes to min(c, npt - c) in [0, npt//2]; permutations sort the
    tuple.  |orbit| = |G| / |stab| with |stab| = prod(multiplicity!) *
    2^{#self-symmetric coords} (c in {0, npt/2} iff negation fixes it).
    """
    m = npt // 2
    selfsym = {0, m} if npt % 2 == 0 else {0}
    if d == 1:
        reps = np.arange(m + 1, dtype=np.int32)[:, None]
        w = np.where(np.isin(reps[:, 0], list(selfsym)), 1.0, 2.0)
        return reps, w
    ms = m if npt % 2 == 0 else -1  # second self-symmetric value (or none)
    if d == 2:
        b, c = np.triu_indices(m + 1)
        b = b.astype(np.int32)
        c = c.astype(np.int32)
        reps = np.stack([b, c], axis=1)
        perm = 2 - (b == c).astype(np.int32)
        nself = ((b == 0) | (b == ms)).astype(np.int32) + ((c == 0) | (c == ms))
    elif d == 3:
        B, C = np.triu_indices(m + 1)
        B = B.astype(np.int32)
        C = C.astype(np.int32)
        counts = (B + 1).astype(np.int64)
        idx = np.repeat(np.arange(len(B), dtype=np.int64), counts)
        starts = np.cumsum(counts) - counts
        a = (np.arange(counts.sum(), dtype=np.int64) - starts[idx]).astype(np.int32)
        b = B[idx]
        c = C[idx]
        reps = np.stack([a, b, c], axis=1)
        eab = (a == b).astype(np.int32)
        ebc = (b == c).astype(np.int32)
        perm = 6 - 3 * eab - 3 * ebc + (eab & ebc)
        nself = (
            ((a == 0) | (a == ms)).astype(np.int32)
            + ((b == 0) | (b == ms))
            + ((c == 0) | (c == ms))
        )
    else:
        raise ValueError("direct cubic reduction implemented for d <= 3")
    w = (perm << (d - nself)).astype(np.float64)
    return reps, w


def _symptr_reduce(npt, d, syms, chunk, want_map):
    syms_int = as_integer_syms(syms)
    if not want_map and d <= 3 and _is_full_cubic_group(syms_int, d):
        reps, w = _cubic_rule_direct(npt, d)
        return reps, w, None
    strides = npt ** np.arange(d - 1, -1, -1, dtype=np.int64)
    total = npt**d
    best = _canonicalize_native(npt, d, syms_int)
    if best is None:
        best = _canonicalize_numpy(npt, d, syms_int, strides, total, chunk)
    # O(N) orbit-size counting (bincount) instead of sort-based unique
    counts_all = np.bincount(best, minlength=total)
    reps_lin = np.nonzero(counts_all)[0]
    counts = counts_all[reps_lin]
    reps = np.empty((reps_lin.shape[0], d), dtype=np.int32)
    rem = reps_lin.copy()
    for j in range(d):
        reps[:, j] = rem // strides[j]
        rem = rem % strides[j]
    full2rep = None
    if want_map:
        full2rep = np.searchsorted(reps_lin, best).astype(np.int32)
    return reps, counts.astype(np.float64), full2rep


def _canonicalize_native(npt, d, syms_int):
    if d > 8:
        return None
    try:
        from ..native.build import load_symptr_lib
    except ImportError:
        return None
    lib = load_symptr_lib()
    if lib is None:
        return None
    import ctypes

    total = npt**d
    best = np.empty(total, dtype=np.int64)
    syms_c = np.ascontiguousarray(syms_int, dtype=np.int64)
    lib.symptr_canonicalize(
        npt, d, syms_c.shape[0],
        syms_c.ctypes.data_as(ctypes.POINTER(ctypes.c_int64)),
        best.ctypes.data_as(ctypes.POINTER(ctypes.c_int64)),
    )
    return best


def _canonicalize_numpy(npt, d, syms_int, strides, total, chunk):
    best = np.empty(total, dtype=np.int64)
    for start in range(0, total, chunk):
        stop = min(start + chunk, total)
        lin = np.arange(start, stop, dtype=np.int64)
        idx = np.empty((stop - start, d), dtype=np.int64)
        rem = lin.copy()
        for j in range(d):
            idx[:, j] = rem // strides[j]
            rem = rem % strides[j]
        b = lin.copy()
        for S in syms_int:
            mapped = (idx @ S.T) % npt
            np.minimum(b, mapped @ strides, out=b)
        best[start:stop] = b
    return best


def inversion_syms(d: int):
    """The 2^d sign-flip matrices (reference ``src/brillouin.jl:248-250``)."""
    out = []
    for bits in range(2**d):
        diag = [(-1 if (bits >> i) & 1 else 1) for i in range(d)]
        out.append(np.diag(diag))
    return np.array(out)


def cube_automorphism_syms(d: int):
    """All signed permutation matrices: 2^d * d! cube automorphisms
    (reference ``src/brillouin.jl:286-293``)."""
    from itertools import permutations

    flips = inversion_syms(d)
    perms = []
    eye = np.eye(d, dtype=np.int64)
    for perm in permutations(range(d)):
        P = eye[list(perm)]
        for F in flips:
            perms.append(F @ P)
    return np.array(perms)
