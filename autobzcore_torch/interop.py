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


def box_pool_from_arrays(state, npts, atol, rtol=0.0, maxiters=None, device="cuda"):
    """A one-lane :class:`~autobzcore_torch.ops.genz_malik.GMPool` from the
    JAX package's box-pool state ``(pool_c, pool_h, pool_val, pool_err, n,
    pool_sd, evals)`` of one ``gm_adaptive`` solve (numpy arrays and
    numbers), with the rule's ``npts`` nodes per box and the solve's
    tolerances. Its totals, loop test and first picks are left to
    :func:`~autobzcore_torch.ops.genz_malik.gm_pool_begin`."""
    import torch

    from .ops.adaptive import _as_eval_budget
    from .ops.genz_malik import GMPool

    c, h, val, err, n, sd, evals = state

    def put(x, dt=torch.float64):
        return torch.as_tensor(np.asarray(x), dtype=dt, device=device)[None]

    val = np.asarray(val)
    return GMPool(c=put(c), h=put(h), err=put(err), sd=put(sd, torch.int32),
                  val=put(val, torch.complex128 if np.iscomplexobj(val) else torch.float64),
                  n=put(int(n), torch.int64), evals=put(float(evals)), atol=put(float(atol)),
                  rtol=float(rtol), max_evals=_as_eval_budget(maxiters), npts=int(npts),
                  active=put(True, torch.bool))


def box_pool_to_arrays(pool, lane=0):
    """The inverse of :func:`box_pool_from_arrays` for one lane: the JAX
    package's state layout as numpy arrays and numbers."""
    get = lambda t: t[lane].detach().cpu().numpy()  # noqa: E731
    return (get(pool.c), get(pool.h), get(pool.val), get(pool.err), int(pool.n[lane]),
            get(pool.sd), float(pool.evals[lane]))


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


def pack_from_arrays(e, Wmat, scale, Savg, weights, ndim, npt, device="cuda"):
    """A :class:`~autobzcore_torch.models.observables.SpectralPack` from the
    JAX package's pack fields as numpy arrays and numbers (``Savg`` None or
    ``(S^-T stack, S^-1 stack, |G|)``), with ``e`` and ``Wmat`` as float64
    tensors on ``device``."""
    import torch

    from .models.observables import SpectralPack

    put = lambda x: torch.as_tensor(np.array(x, dtype=np.float64), device=device)  # noqa: E731
    if Savg is not None:
        Savg = (np.asarray(Savg[0], dtype=np.float64), np.asarray(Savg[1], dtype=np.float64), int(Savg[2]))
    return SpectralPack(put(e), put(Wmat), float(scale), Savg, np.asarray(weights, dtype=np.float64),
                        int(ndim), int(npt))


def pack_to_arrays(pack):
    """The inverse of :func:`pack_from_arrays`: ``(e, Wmat, scale, Savg,
    weights, ndim, npt)`` as numpy arrays and numbers, the JAX package's
    ``SpectralPack`` field order."""
    Savg = pack.Savg
    if Savg is not None:
        Savg = (np.asarray(Savg[0]), np.asarray(Savg[1]), int(Savg[2]))
    return (pack.e.detach().cpu().numpy(), pack.Wmat.detach().cpu().numpy(), float(pack.scale), Savg,
            np.asarray(pack.weights), int(pack.ndim), int(pack.npt))


def berry_pack_from_arrays(e, Om, Mm, vd, ndim, npt, device="cuda"):
    """A :class:`~autobzcore_torch.models.berry.BerryPack` from the JAX
    package's ``BerryPack`` fields as numpy arrays and numbers, with the
    fields as float64 tensors on ``device``."""
    import torch

    from .models.berry import BerryPack

    put = lambda x: torch.as_tensor(np.array(x, dtype=np.float64), device=device)  # noqa: E731
    return BerryPack(put(e), put(Om), put(Mm), put(vd), int(ndim), int(npt))


def berry_pack_to_arrays(pack):
    """The inverse of :func:`berry_pack_from_arrays`: ``(e, Om, Mm, vd, ndim,
    npt)`` as numpy arrays and numbers, the JAX package's field order."""
    fields = tuple(t.detach().cpu().numpy() for t in (pack.e, pack.Om, pack.Mm, pack.vd))
    return fields + (int(pack.ndim), int(pack.npt))


def sigma_from_arrays(omegas, values_re, values_im, device="cuda"):
    """A :class:`~autobzcore_torch.models.selfenergy.SigmaInterpolant` from
    the JAX package's ``SigmaInterpolant`` fields ``omegas``, ``values_re``
    and ``values_im`` (numpy), with its values as float64 tensors on
    ``device``."""
    from .models.selfenergy import SigmaInterpolant

    values = np.asarray(values_re, dtype=np.float64) + 1j * np.asarray(values_im, dtype=np.float64)
    return SigmaInterpolant(np.asarray(omegas, dtype=np.float64), values, device=device)
