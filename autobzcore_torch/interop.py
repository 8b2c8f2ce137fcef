"""Conversions from the JAX package's data, handed over as numpy arrays, to
the port's objects, so that one model feeds both packages (the parity tests
use them). Nothing here imports JAX."""
from __future__ import annotations

import numpy as np

from .brillouin import SymmetricBZ, lattice_bz_limits
from .fourier import FourierSeries
from .limits import CubicLimits, TetrahedralLimits
from .ops.symptr import as_integer_syms, cube_automorphism_syms, inversion_syms


def series_from_arrays(c, offset, period, ndim, device="cuda"):
    """A :class:`FourierSeries` from coefficients ``c`` (n_1..n_d, *val),
    offsets, periods and the spatial dimension ``ndim``."""
    return FourierSeries(np.asarray(c), period=period, offset=offset, ndim=ndim, device=device)


def _same_group(syms, group):
    key = lambda S: sorted(m.tobytes() for m in as_integer_syms(S))  # noqa: E731
    return len(syms) == len(group) and key(syms) == key(group)


def pool_from_arrays(pool, device="cuda"):
    """A :class:`~autobzcore_torch.algorithms.nested.WarmPool` from the JAX
    package's warm pool tuple ``(a, b, err, n[, (ta, tb, te, tn)])`` as numpy
    arrays and numbers."""
    import torch

    from .algorithms.nested import MidSeed, WarmPool

    put = lambda x: torch.as_tensor(np.array(x, dtype=np.float64), device=device)  # noqa: E731
    mid = None
    if len(pool) > 4:
        ta, tb, te, tn = pool[4]
        mid = MidSeed(put(ta), put(tb), put(te), int(tn))
    n = torch.full((1,), int(pool[3]), dtype=torch.int64, device=device)
    return WarmPool(put(pool[0]), put(pool[1]), put(pool[2]), n, mid)


def pool_to_arrays(pool):
    """The inverse of :func:`pool_from_arrays`: the JAX package's pool tuple
    layout as numpy arrays and ints."""
    out = tuple(t.detach().cpu().numpy() for t in (pool.a, pool.b, pool.e)) + (int(pool.n[0]),)
    if pool.mid is not None:
        m = pool.mid
        out += ((m.ta.detach().cpu().numpy(), m.tb.detach().cpu().numpy(),
                 m.te.detach().cpu().numpy(), int(m.tn)),)
    return out


def bz_from_arrays(A, B, syms=None):
    """A :class:`SymmetricBZ` from lattice ``A``, reciprocal lattice ``B``
    and symmetry matrices ``syms`` (None for the full zone). The limits
    follow the group, as ``load_bz`` sets them: the half cube for the
    inversion group, the tetrahedral wedge for the cube group."""
    A = np.asarray(A, dtype=np.float64)
    d = A.shape[0]
    if syms is None:
        return SymmetricBZ(A, B, lattice_bz_limits(d), None)
    syms = np.asarray(syms)
    if _same_group(syms, inversion_syms(d)):
        lims = CubicLimits(np.zeros(d), np.full(d, 0.5))
    elif _same_group(syms, cube_automorphism_syms(d)):
        lims = TetrahedralLimits(0.5, d)
    else:
        raise ValueError("bz_from_arrays knows the limits of the inversion and cube groups only")
    return SymmetricBZ(A, B, lims, syms)
