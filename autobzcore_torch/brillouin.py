"""Brillouin-zone layer: domain semantics, symmetry, BZ algorithms
(reference ``autobzcore_tpu/brillouin.py``).

The BZ algorithms

1. map the problem to a standard domain in fractional coordinates,
2. rescale ``abstol`` by ``det(B) * nsyms``,
3. symmetrize the irreducible-zone result to the full zone, and
4. re-solve on the full zone, with a warning, when the integrand's symmetry
   representation is unknown and its result is not a scalar.

The PTR rule and the cold IAI are ported; ``AutoPTR``, ``TAI``, ``PTR_IAI``
and ``AutoPTR_IAI`` come with later slices (ROADMAP A4, A5, A7), and ``IBZ``
with the geometry slice (ROADMAP A8).
"""
from __future__ import annotations

import warnings

import numpy as np
import torch

from .algorithms.base import IntegralAlgorithm
from .algorithms.gk import AuxQuadGKJL
from .algorithms.nested import NestedQuad
from .algorithms.ptr import MonkhorstPack
from .domains import Basis
from .interfaces import IntegralSolution
from ._device import as_device
from .limits import CubicLimits, TetrahedralLimits
from .ops.symptr import cube_automorphism_syms, inversion_syms
from .utils.tree import tree_leaves, tree_map


def canonical_reciprocal_basis(A):
    """B = 2 pi inv(A)^T."""
    A = np.asarray(A, dtype=np.float64)
    return 2 * np.pi * np.linalg.inv(A).T


def check_bases_canonical(A, B, atol):
    if np.linalg.norm(np.asarray(A).T @ np.asarray(B) - 2 * np.pi * np.eye(len(A))) >= atol:
        raise ValueError(f"Real and reciprocal Bravais lattice bases non-orthogonal to tolerance {atol}")


def lattice_bz_limits(d):
    """Unitless canonical BZ: the fractional unit cube."""
    return CubicLimits(np.zeros(d), np.ones(d))


class SymmetricBZ:
    """BZ reduced by point-group symmetries, with integration limits and
    symmetries in the lattice (fractional) basis."""

    def __init__(self, A, B, lims, syms=None):
        self.A = np.asarray(A, dtype=np.float64)
        self.B = np.asarray(B, dtype=np.float64)
        if self.A.shape != self.B.shape or self.A.shape[0] != self.A.shape[1]:
            raise ValueError("A and B must be identically-sized square matrices")
        self.lims = lims
        self.syms = None if syms is None else np.asarray(syms)

    @property
    def ndim(self):
        return self.A.shape[0]

    @property
    def nsyms(self):
        return 1 if self.syms is None else len(self.syms)

    @property
    def is_full(self):
        return self.syms is None

    def full(self):
        """The same zone without symmetry reduction."""
        return SymmetricBZ(self.A, self.B, lattice_bz_limits(self.ndim), None)

    def __repr__(self):
        kind = "trivial" if self.is_full else f"{self.nsyms}"
        return f"{self.ndim}-dimensional Brillouin zone with {kind} symmetries"


def nsyms(bz: SymmetricBZ):
    """Number of symmetry operations of the reduced zone (1 for full BZ)."""
    return bz.nsyms


# --- symmetry representation traits -----------------------------------------
class AbstractSymRep:
    """Base of symmetry-representation traits."""


class UnknownRep(AbstractSymRep):
    """Transformation under the group unknown: non-scalar results trigger
    the full-BZ recompute."""


class TrivialRep(AbstractSymRep):
    """Integrand invariant under the group: IBZ results map to the full zone
    by multiplying with ``nsyms``."""


class LatticeRep(AbstractSymRep):
    """Rank-2 tensor representation in the lattice basis: an IBZ integral
    ``x`` maps to the full zone as ``sum_S S^{-T} x S^{-1}``."""

    def symmetrize(self, bz, x):
        Sinv = np.linalg.inv(np.asarray(bz.syms, dtype=np.float64))

        def leaf(v):
            si = torch.as_tensor(Sinv, dtype=v.dtype, device=v.device)
            return torch.einsum("sab,...bc,scd->s...ad", si.transpose(1, 2), v, si).sum(0)

        return tree_map(leaf, x)


def sym_rep(f):
    """UnknownRep unless the integrand declares a ``rep`` attribute."""
    rep = getattr(f, "rep", None)
    return rep if rep is not None else UnknownRep()


def _ndim(x):
    return x.ndim if hasattr(x, "ndim") else np.ndim(x)


def _is_trivial_result(x):
    """Numbers and 0-d tensors transform trivially."""
    return all(_ndim(leaf) == 0 for leaf in tree_leaves(x))


def symmetrize(f, bz: SymmetricBZ, x):
    """Map an IBZ integral to the full BZ."""
    if bz.is_full:
        return x
    rep = f if isinstance(f, AbstractSymRep) else sym_rep(f)
    if isinstance(rep, TrivialRep) or _is_trivial_result(x):
        return tree_map(lambda v: bz.nsyms * v, x)
    if isinstance(rep, UnknownRep):
        return x  # caller handles the warn-and-recompute fallback
    return rep.symmetrize(bz, x)


# --- BZ constructors ----------------------------------------------------------
class AbstractBZ:
    pass


class FBZ(AbstractBZ):
    """Full/first Brillouin zone."""


class InversionSymIBZ(AbstractBZ):
    """2^d sign-flip symmetries; expects orthogonal lattice vectors."""


class CubicSymIBZ(AbstractBZ):
    """2^d d! cube automorphisms; expects orthogonal lattice vectors."""


def load_bz(kind, A=None, B=None, *, atol=None, dim=3):
    """Load a Brillouin zone. ``A``: real-space lattice vectors in columns
    (or an int dimension for the identity lattice), or the path of a
    Wannier90 ``.wout`` file; ``B`` defaults to ``2 pi inv(A)^T``."""
    if isinstance(A, str):
        from .io.wannier90 import read_wout

        out = read_wout(A)
        # .wout files print 6 decimals
        return load_bz(kind, out["lattice"], out["recip_lattice"], atol=1e-5 if atol is None else atol)
    if A is None:
        A = np.eye(dim)
    if isinstance(A, (int, np.integer)) and not isinstance(A, bool):
        A = np.eye(int(A))
    A = np.asarray(A, dtype=np.float64)
    if A.ndim == 0:
        A = A.reshape(1, 1)
    d = A.shape[0]
    if B is None:
        B = canonical_reciprocal_basis(A)
    B = np.asarray(B, dtype=np.float64)
    if B.ndim == 0:
        B = B.reshape(1, 1)
    check_bases_canonical(A, B, atol if atol is not None else np.sqrt(np.finfo(np.float64).eps))

    if isinstance(kind, FBZ):
        return SymmetricBZ(A, B, lattice_bz_limits(d), None)
    if isinstance(kind, InversionSymIBZ):
        if not _is_orthogonal(A):
            warnings.warn("Non-orthogonal lattice vectors detected with InversionSymIBZ. Unexpected behavior may occur")
        return SymmetricBZ(A, B, CubicLimits(np.zeros(d), np.full(d, 0.5)), inversion_syms(d))
    if isinstance(kind, CubicSymIBZ):
        if not _is_orthogonal(A):
            warnings.warn("Non-orthogonal lattice vectors detected with CubicSymIBZ. Unexpected behavior may occur")
        return SymmetricBZ(A, B, TetrahedralLimits(0.5, d), cube_automorphism_syms(d))
    if type(kind).__name__ == "IBZ":
        raise NotImplementedError("crystal-symmetry IBZ is not ported yet (ROADMAP A8)")
    raise TypeError(f"unknown BZ kind {kind!r}")


def _is_orthogonal(A):
    M = A.T @ A
    return np.allclose(M, np.diag(np.diag(M)))


# --- BZ integration algorithms ------------------------------------------------
class AutoBZAlgorithm(IntegralAlgorithm):
    """Wrap a standard algorithm over the fractional-coordinate zone with
    tolerance rescaling and symmetrization."""

    def bz_to_standard(self, bz: SymmetricBZ):
        raise NotImplementedError

    def init_cacheval(self, f, bz, p):
        s = getattr(f, "s", None)
        if s is not None and getattr(s, "sndim", bz.ndim) != bz.ndim:
            raise ValueError(
                f"FourierIntegrand series is {s.sndim}-dimensional but the BZ is "
                f"{bz.ndim}-dimensional; pass ndim= to FourierSeries when the "
                "coefficients are matrix-valued (trailing value axes)"
            )
        bz_, dom, alg = self.bz_to_standard(bz)
        return {
            "bz_": bz_, "dom": dom, "alg": alg, "f": f,
            "inner": alg.init_cacheval(f, dom, p),
            "full": None,  # lazily built FBZ fallback for UnknownRep results
        }

    def solve_fn(self, cacheval, lanes=False):
        """fn(p, atol, rtol) -> (u, resid, converged, numevals).

        Symmetrization is fixed here (no warn-and-recompute), so the
        integrand's symmetry rep must be Trivial, declared, or the result
        scalar. With ``lanes`` the parameter carries a leading lane axis (a
        sweep chunk), which the result carries too and which the scalar
        test does not count; for algorithms that solve lanes independently
        (``solves_lanes``) the parameter is a
        :class:`~autobzcore_torch.parameters.LaneParams` instead."""
        return self._wrap_inner(cacheval, cacheval["alg"].solve_fn(cacheval["inner"], lanes), lanes)

    def solve_fn_consts(self, cacheval, lanes=False):
        """(fn(consts, p, atol, rtol), consts): the rule data passed as an
        argument, as the sweeps call it."""
        fn2, consts = cacheval["alg"].solve_fn_consts(cacheval["inner"])

        def fn(consts, p, atol, rtol):
            inner = lambda q, a, r: fn2(consts, q, a, r)  # noqa: E731
            return self._wrap_inner(cacheval, inner, lanes)(p, atol, rtol)

        return fn, consts

    def _wrap_inner(self, cacheval, inner, lanes=False):
        bz_ = cacheval["bz_"]
        f = cacheval["f"]
        j = abs(np.linalg.det(bz_.B))
        ns = bz_.nsyms
        rep = sym_rep(f)
        lane_ndim = 1 if lanes else 0
        if bz_.is_full or isinstance(rep, (TrivialRep, UnknownRep)):
            factor = j * ns
            check_unknown = not bz_.is_full and isinstance(rep, UnknownRep)

            def fn(p, atol, rtol):
                u, e, conv, ne = inner(p, None if atol is None else atol / (j * ns), rtol)
                if check_unknown and any(_ndim(leaf) > lane_ndim for leaf in tree_leaves(u)):
                    raise ValueError(
                        "solve over a symmetric BZ with an array-valued integrand "
                        "whose symmetry representation is unknown: the full-BZ "
                        "recompute fallback cannot run inside a sweep. Declare "
                        "the integrand's `rep` (e.g. TrivialRep() or LatticeRep()) "
                        "or load the full BZ."
                    )
                return (tree_map(lambda v: factor * v, u), tree_map(lambda v: factor * v, e),
                        conv, ne)

            return fn

        def fn(p, atol, rtol):
            u, e, conv, ne = inner(p, None if atol is None else atol / (j * ns), rtol)
            u = tree_map(lambda v: j * v, rep.symmetrize(bz_, u))
            e = tree_map(lambda v: j * v, rep.symmetrize(bz_, e))
            return u, e, conv, ne

        return fn

    def do_solve(self, f, bz, p, cacheval, abstol=None, reltol=None, maxiters=None):
        bz_ = cacheval["bz_"]
        dom = cacheval["dom"]
        alg = cacheval["alg"]
        j = abs(np.linalg.det(bz_.B))
        atol = None if abstol is None else abstol / (j * bz_.nsyms)
        sol = alg.do_solve(f, dom, p, cacheval["inner"], abstol=atol, reltol=reltol, maxiters=maxiters)

        if not bz_.is_full and isinstance(sym_rep(f), UnknownRep) and not _is_trivial_result(sol.u):
            warnings.warn(
                "A symmetric BZ was used with an integrand whose symmetry "
                "representation is unknown. For correctness, the calculation "
                "will be repeated on the full BZ. Extend the integrand's `rep` "
                "attribute to use symmetry."
            )
            if cacheval["full"] is None:
                fbz = bz_.full()
                cacheval["full"] = (fbz, self.init_cacheval(f, fbz, p))
            fbz, fcache = cacheval["full"]
            return self.do_solve(f, fbz, p, fcache, abstol=abstol, reltol=reltol, maxiters=maxiters)

        val = tree_map(lambda v: j * v, symmetrize(f, bz_, sol.u))
        resid = sol.resid
        if resid is not None:
            resid = tree_map(lambda v: j * v, symmetrize(f, bz_, resid))
        return IntegralSolution(val, resid, sol.retcode, sol.numevals)


class PTR(AutoBZAlgorithm):
    """Fixed-npt periodic trapezoidal rule. The rule lives on the series'
    device for a FourierIntegrand, on ``device`` (the card by default)
    otherwise."""

    def __init__(self, npt=50, device="cuda"):
        self.npt = npt
        self.device = as_device(device)

    def bz_to_standard(self, bz):
        return bz, Basis(np.eye(bz.ndim)), MonkhorstPack(npt=self.npt, syms=bz.syms, device=self.device)


class IAI(AutoBZAlgorithm):
    """Iterated adaptive integration over the zone's limits, most efficient
    for localized integrands (reference ``IAI``, cold start).

    ``algs`` (default ``AuxQuadGKJL(nbisect=1)`` at every level, pure
    worst-first refinement) and ``inner_cap``/``inner_nbisect`` set each
    level's pool; ``leaf_nbisect``, ``leaf_presplit`` and ``nest_presplit``
    are the reference's depth and anti-aliasing knobs. ``precision`` is
    accepted: "split" and "guided" were the reference's emulated-f64 tiers
    on a TPU and run as the native complex128 tier here, which is what they
    certify. ``host_outer`` is accepted and the outer level runs on the
    device. ``warm_start`` (the IAI warm slice) and ``checkpoint`` (the
    host-side heap) raise. ``device`` (the card by default) places the
    pools of integrands without a series; ``plain_kernels`` runs the nest on
    the kernels' plain versions."""

    solves_lanes = True

    def __init__(self, algs=None, inner_cap=512, inner_nbisect=2, precision="complex",
                 host_outer=False, host_nbisect=None, checkpoint=None,
                 leaf_nbisect=None, leaf_presplit=None, nest_presplit=None,
                 guide_rfloor="auto", guide_patience=6, guide_slack=1.0,
                 warm_start=False, warm_width=None, inner_seed_width=None,
                 device="cuda", plain_kernels=False):
        if precision not in ("complex", "split", "guided"):
            raise ValueError("precision must be 'complex', 'split', or 'guided'")
        self.device = as_device(device)
        self.algs = algs if algs is not None else AuxQuadGKJL(nbisect=1)
        self.precision = precision
        if host_nbisect is None:
            host_nbisect = 1 if precision == "guided" else 4
        self.knobs = dict(inner_cap=inner_cap, inner_nbisect=inner_nbisect,
                          split=precision != "complex", host_outer=host_outer,
                          host_nbisect=host_nbisect, checkpoint=checkpoint,
                          leaf_nbisect=leaf_nbisect, leaf_presplit=leaf_presplit,
                          nest_presplit=nest_presplit, guide_rfloor=guide_rfloor,
                          guide_patience=guide_patience, guide_slack=guide_slack,
                          warm_start=warm_start, warm_width=warm_width,
                          inner_seed_width=inner_seed_width, plain_kernels=plain_kernels)
        self.bz_to_standard(None)  # refuse the unported knobs now, not at the first solve

    def bz_to_standard(self, bz):
        lims = None if bz is None else bz.lims
        return bz, lims, NestedQuad(self.algs, device=self.device, **self.knobs)
