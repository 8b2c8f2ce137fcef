"""Parameter sweeps (reference ``autobzcore_tpu/parallel/sweep.py``).

Two forms, by algorithm:

- **Fixed rules (PTR).** Where the reference vmaps one solve per parameter,
  the port hands a whole chunk of parameters to ONE solve as a lane vector:
  a ``(W,)`` frequency tensor reaches the PTR rule, which broadcasts over it
  the way the reference's frequency-block solves do (``dos_trace`` returns
  one value per lane, and kernel K2 sums all lanes in one launch).
  Integrands swept this way must broadcast over a leading parameter axis. A
  fixed rule converges every lane, and ``numevals`` counts the rule's points
  once per real (non-pad) lane.
- **Adaptive solvers (IAI, NestedQuad, QuadGKJL; ``solves_lanes``).** Each
  parameter is one independent solve. A chunk's solves run as lanes of one
  batched pool, each lane with its own pools, convergence and count, so each
  value, residual, retcode and ``numevals`` equal the solve alone (the
  reference's ``scan`` sequences them, its plain sweep vmaps them; cold
  solves give the same per-lane results either way). Pad lanes are not
  solved.

- **Warm sweeps (``warm=True``, IAI and NestedQuad).** The reference's
  sequential chain: parameters in sorted order, each solve seeded from the
  previous one's final pool, chunks seeded from the nearest carried pool or
  library entry, one mid-seed harvest per chunk. One parameter runs at a
  time (its inner levels still run as lanes), pads included, as the
  reference's scan solves them.

- **Omega blocks (``block=W``, with ``scan=True``).** W adjacent parameters
  solve as ONE adaptive nest: the lane's parameter is a (W,) vector, the
  integrand broadcasts over it (``dos_trace`` does), the error is the
  2-norm over the W channels and one refinement trajectory serves the
  block. The last real block of a sweep is padded with the last real value,
  as the reference pads; pure-pad blocks are not solved cold and are solved
  (and not counted) in a warm chain, as the reference's scan does. A block's
  certificate and count are indivisible: its lanes inherit the retcode,
  ``lane_numevals`` holds the even split, and ``block_certificates`` the
  exact per-block (converged, numevals) in solve order (sorted order when
  warm).

Either way ``numevals`` sums the real lanes (real blocks) and ``retcode`` is
their AND, so a sweep's totals equal the reference's exactly. ``group`` only
shapes the reference's lockstep batches, so it is checked as there and
changes nothing.

Not ported yet: ``mesh`` sharding (ROADMAP A10) and the AutoPTR ladder
(ROADMAP A4).
"""
from __future__ import annotations

import numpy as np
import torch

from ..algorithms.base import effective_tolerances
from ..interfaces import IntegralProblem, _takes_mixed_parameters, init
from ..parameters import LaneParams, MixedParameters, merge_parameters
from ..utils.tree import tree_leaves, tree_map


def _solve_fn_with_consts(prob, alg, cache):
    """(fn(consts, p, atol, rtol), consts) for lane-vector parameters, with
    integrand-preset parameters merged in."""
    fnc, consts = alg.solve_fn_consts(cache.cacheval, lanes=True)
    if _takes_mixed_parameters(prob.f):
        preset = cache.p

        def fn2(consts, p, atol, rtol):
            return fnc(consts, merge_parameters(preset, p), atol, rtol)

        return fn2, consts
    return fnc, consts


def _check_sweep_knobs(mesh=None, scan=False, chunk=1, warm=False, block=1, group=1):
    """The reference's ValueErrors for knob combinations it refuses, then
    NotImplementedError for the knobs not ported."""
    if mesh is not None:
        raise NotImplementedError("mesh-sharded sweeps are not ported yet (ROADMAP A10)")
    g, blk = int(group), int(block)
    if g > 1 and not scan:
        raise ValueError("group > 1 requires scan=True")
    if blk > 1:
        if not scan or g != 1:
            raise ValueError("block > 1 requires scan=True, group=1, and no mesh")
        if chunk % blk:
            raise ValueError(f"chunk {chunk} must divide into blocks of {blk}")
    if warm and (not scan or g != 1):
        raise ValueError("warm=True requires scan=True and group=1 "
                         "(the pool carry is a sequential chain per device)")
    if scan and chunk % g:
        raise ValueError(f"chunk {chunk} must divide into groups of {g}")


def _find(cacheval, key):
    """The entry ``key`` of a cacheval, looking through BZ wrappers'
    ``"inner"`` entries; None where there is none."""
    while isinstance(cacheval, dict):
        if key in cacheval:
            return cacheval[key]
        cacheval = cacheval.get("inner")
    return None


def _lane_values(ps):
    """The lane values of sweep parameters ``ps`` (an array or tensor, or a
    MixedParameters holding one) as float64: (n,) one number per lane, or
    (n, W) an omega block of W per lane."""
    if isinstance(ps, MixedParameters):
        if len(ps.args) != 1 or ps.kwargs:
            raise NotImplementedError("independent-lane sweeps take one swept value per lane "
                                      "(ROADMAP A5)")
        ps = ps.args[0]
    x = ps if isinstance(ps, torch.Tensor) else torch.as_tensor(np.asarray(ps, dtype=np.float64))
    if x.ndim not in (1, 2):
        raise NotImplementedError("independent-lane sweeps take one swept number, or one block "
                                  "of them, per lane (ROADMAP A5)")
    return x.to(torch.float64)


def _not_broadcasting(blk, shape):
    """The reference's error for an integrand that does not broadcast over
    an omega block (``parallel/sweep.py:593-602``)."""
    return ValueError(
        f"block={blk} requires the integrand to broadcast over the omega-block vector: each block "
        f"solve must return one output channel per block member (shape ({blk}, ...)), but the solve "
        f"output has per-solve shape {tuple(shape)}. Reducing integrands (e.g. "
        "models.observables.dos_eig, which sums over all axes) cannot run blocked.")


def _deblock(u, nblocks, blk):
    """Block solves' outputs (nblocks, blk, ...) as per-lane rows (nblocks *
    blk, ...)."""
    def leaf(v):
        if v.ndim < 2 or v.shape[1] != blk:
            raise _not_broadcasting(blk, v.shape[1:])
        return v.reshape((nblocks * blk,) + tuple(v.shape[2:]))

    return tree_map(leaf, u)


def sweep_solve(prob: IntegralProblem, alg, ps, abstol=None, reltol=None, mesh=None):
    """Solve ``prob`` at every parameter of ``ps`` (a tensor or array, or a
    MixedParameters of them, with the sweep axis leading) in one solve.

    Returns ``(us, resids, converged, numevals)`` with the sweep axis
    leading."""
    _check_sweep_knobs(mesh=mesh)
    cache = init(prob, alg)
    atol, rtol = effective_tolerances(abstol, reltol)
    if getattr(alg, "solves_lanes", False):
        fn = alg.solve_fn(cache.cacheval, lanes=True)
        params = LaneParams(cache.p, _lane_values(ps), _takes_mixed_parameters(prob.f))
        u, resid, conv, ne = fn(params, atol, rtol)
        return u, resid.cpu().numpy(), conv.cpu().numpy(), ne.cpu().numpy().astype(np.int64)
    fn2, consts = _solve_fn_with_consts(prob, alg, cache)
    n = int(np.shape(tree_leaves(ps.args + tuple(ps.kwargs.values()))[0]
                     if isinstance(ps, MixedParameters) else ps)[0])
    u, resid, conv, ne = fn2(consts, ps, atol, rtol)
    return (u, np.full(n, float(resid)), np.full(n, bool(conv)), np.full(n, int(ne)))


class SweepSolver:
    """Reusable parameter sweep in fixed-size chunks.

    Parameters are single numbers; for FourierIntegrand/ParameterIntegrand
    problems each is merged as the next positional argument. For a fixed
    rule, inputs are padded to a multiple of ``chunk`` with the last value
    and each chunk is one solve over a ``(chunk,)`` lane vector; for an
    adaptive solver each chunk's real parameters are independent solves run
    as lanes of one batched pool (``scan`` is accepted either way: cold
    solves give the same per-lane results in sequence or in lockstep).

    After each call ``self.retcode`` is True iff every real parameter's solve
    converged, and ``self.numevals`` has accumulated the integrand
    evaluations of the real lanes (pad lanes are not counted). For nested
    solvers ``self.stats`` holds the trips of each level and the host syncs
    (:class:`~autobzcore_torch.ops.adaptive.LoopStats`), and for adaptive
    solvers ``self.lane_numevals`` the last call's count of each parameter.

    ``warm=True`` (with ``scan=True``) runs the reference's warm chain: the
    parameters of a call in stable sorted order, the carried pool threading
    from solve to solve and from call to call, each chunk seeded by the
    nearest of the carried pool and the ``warm_lib`` library entries
    (strictly nearer wins; the cold pool before any), one mid-seed harvest
    per chunk at its last sorted parameter, whose evaluations count in
    ``numevals``. Each chunk appends its real solves' evaluations to
    ``self.chunk_evals`` and ``(x_first, x_last, seed distance)`` to
    ``self.chunk_meta``.

    ``block=W`` (with ``scan=True``, ``W`` dividing ``chunk``) solves W
    adjacent parameters per nest (see the module docstring); after each call
    ``self.block_certificates`` holds the real blocks' (converged (B,) bool,
    numevals (B,) int64) in solve order.
    """

    def __init__(self, prob, alg, abstol=None, reltol=None, chunk=256, mesh=None,
                 scan=False, group=1, warm=False, warm_lib=12, block=1):
        _check_sweep_knobs(mesh=mesh, scan=scan, chunk=int(chunk), warm=warm, block=block,
                           group=group)
        cache = init(prob, alg)
        self.numevals = 0
        self.chunk_evals = []
        self.chunk_meta = []
        self.retcode = None  # set by __call__
        self.lane_numevals = None
        self.block_certificates = None
        self.block = int(block)
        self.chunk = int(chunk)
        self.scan = bool(scan)
        self._atol, self._rtol = effective_tolerances(abstol, reltol)
        self._lanes = getattr(alg, "solves_lanes", False)
        self._p, self._merge = cache.p, _takes_mixed_parameters(prob.f)
        if self._lanes:
            self._fn = alg.solve_fn(cache.cacheval, lanes=True)
        else:
            self._fn, self._consts = _solve_fn_with_consts(prob, alg, cache)
        self._wrap = MixedParameters if _takes_mixed_parameters(prob.f) else (lambda x: x)
        self.device = _find(cache.cacheval, "device") or torch.device("cpu")
        self.stats = _find(cache.cacheval, "stats")
        self._warm = None
        if warm:
            sfw = getattr(alg, "solve_fn_warm", None)
            got = None if sfw is None else sfw(cache.cacheval)
            if got is None:
                raise ValueError(
                    f"{type(alg).__name__} has no warm-pool solve form (warm=True needs an "
                    "adaptive-outer NestedQuad/IAI with precision='complex'/'split', on-device)")
            hfn = getattr(alg, "harvest_fn", None)
            self._warm, self._pool0 = got
            self._harvest = None if hfn is None else hfn(cache.cacheval)
            self._pool = None
            self._pool_x = None
            self._pool_lib = []
            self._warm_lib = int(warm_lib)

    def __call__(self, xs):
        xs = np.asarray(xs.cpu() if isinstance(xs, torch.Tensor) else xs, dtype=np.float64)
        n = xs.shape[0]
        if n == 0:
            self.retcode = True
            return np.zeros((0,))
        c = self.chunk
        if self._warm is not None:
            return self._solve_warm(xs, n, c)
        if self._lanes:
            return self._solve_lanes(xs, n, c)
        npad = -(-n // c) * c
        # pad with the last real value, not 0.0, as the reference does
        xp = np.full(npad, xs[n - 1])
        xp[:n] = xs
        blk = self.block
        outs, convs, bconv, bne = [], [], [], []
        for i in range(0, npad, c):
            x = torch.as_tensor(xp[i:i + c], device=self.device)
            u, _, conv, ne = self._fn(self._consts, self._wrap(x), self._atol, self._rtol)
            if blk > 1:
                # one fixed-rule solve serves the chunk; each real block counts the rule once
                for v in tree_leaves(u):
                    if v.ndim < 1 or v.shape[0] != c:
                        raise _not_broadcasting(blk, v.shape)
                nreal = int(np.sum(i + np.arange(c // blk) * blk < n))
                bconv += [bool(conv)] * nreal
                bne += [int(ne)] * nreal
                self.numevals += int(ne) * nreal
            else:
                self.numevals += int(ne) * min(c, n - i)
            outs.append(u)
            convs.append(bool(conv))
        self.retcode = all(convs)
        if blk > 1:
            self.block_certificates = (np.array(bconv, dtype=bool), np.array(bne, dtype=np.int64))
        return tree_map(lambda *vs: torch.cat(vs)[:n].cpu().numpy(), *outs)

    def _solve_lanes(self, xs, n, c):
        blk = self.block
        outs, bconv, bne = [], [], []
        for i in range(0, n, c):
            real = xs[i:i + c]
            if blk == 1:
                x = torch.as_tensor(real, device=self.device)
            else:
                # the chunk's blocks that hold a real parameter, the last one
                # padded with the last real value (pure-pad blocks are not solved)
                nb = -(-real.shape[0] // blk)
                xb = np.full(nb * blk, xs[n - 1])
                xb[:real.shape[0]] = real
                x = torch.as_tensor(xb.reshape(nb, blk), device=self.device)
            u, _, conv, ne = self._fn(LaneParams(self._p, x, self._merge), self._atol, self._rtol)
            if blk > 1:
                u = tree_map(lambda v: v[:real.shape[0]], _deblock(u, x.shape[0], blk))
            outs.append(u)
            bconv.append(conv.cpu().numpy().astype(bool))
            bne.append(ne.cpu().numpy())
        conv_b, ne_b = np.concatenate(bconv), np.concatenate(bne)
        self._record(conv_b, ne_b, np.ones(conv_b.shape[0], dtype=bool), np.arange(n))
        return tree_map(lambda *vs: torch.cat(vs).cpu().numpy(), *outs)

    def _record(self, conv_b, ne_b, real_b, real_lanes):
        """Certificates of one call from the per-solve (per-block) arrays in
        solve order, the mask of solves that hold a real parameter and the
        solve-order lane positions of the caller's parameters: the retcode,
        ``numevals``, the per-lane counts (a block's count split evenly over
        its lanes) and, for blocks, ``block_certificates``."""
        blk = self.block
        self.retcode = bool(np.all(conv_b[real_b]))
        self.numevals += int(np.sum(ne_b[real_b]))
        lane_ne = np.repeat(ne_b / blk, blk) if blk > 1 else ne_b.astype(np.int64)
        self.lane_numevals = lane_ne[real_lanes]
        if blk > 1:
            self.block_certificates = (conv_b[real_b], ne_b[real_b].astype(np.int64))

    # --- the warm chain ------------------------------------------------------------
    def _select_seed(self, x0):
        """(pool, distance) for a chunk starting at ``x0``: the nearest of the
        carried pool and the library (host keys, no sync; the carried pool
        wins ties). When none is strictly nearer than inf (none yet, or a
        non-finite key), the carried pool if there is one, else the cold pool,
        and inf."""
        best, best_d = None, np.inf
        carried = [] if self._pool is None or self._pool_x is None else [(self._pool_x, self._pool)]
        for xk, pk in carried + self._pool_lib:
            d = abs(x0 - xk)
            if d < best_d:
                best, best_d = pk, d
        if best is None:
            return (self._pool if self._pool is not None else self._pool0), np.inf
        return best, best_d

    def _lib_insert(self, x, pool):
        """Add an (x, pool) snapshot; at capacity the entry nearest the
        newcomer gives way."""
        if self._warm_lib <= 0:
            return
        if len(self._pool_lib) < self._warm_lib:
            self._pool_lib.append((x, pool))
            return
        j = min(range(len(self._pool_lib)), key=lambda k: abs(self._pool_lib[k][0] - x))
        self._pool_lib[j] = (x, pool)

    def _solve_warm(self, xs, n, c):
        blk = self.block
        npad = -(-n // c) * c
        xp = np.full(npad, xs[n - 1])
        xp[:n] = xs
        perm = np.argsort(xp, kind="stable")
        is_real_s = perm < n
        xs_s = xp[perm]
        outs, convs, counts, hnes = [], [], [], []
        for i in range(0, npad, c):
            pool, seed_d = self._select_seed(float(xs_s[i]))
            for j in range(i, i + c, blk):
                # one parameter, or a block of blk adjacent sorted ones, per solve
                xv = xs_s[j] if blk == 1 else xs_s[j:j + blk]
                x = torch.tensor(np.reshape(xv, (1,) if blk == 1 else (1, blk)), dtype=torch.float64,
                                 device=self.device)
                u, _, conv, ne, pool = self._warm(LaneParams(self._p, x, self._merge), self._atol,
                                                  self._rtol, pool)
                outs.append(u if blk == 1 else _deblock(u, 1, blk))
                convs.append(conv)
                counts.append(ne)
            if self._harvest is not None:
                x = torch.tensor([xs_s[i + c - 1]], dtype=torch.float64, device=self.device)
                pool, h = self._harvest(LaneParams(self._p, x, self._merge), self._atol,
                                        self._rtol, pool)
                hnes.append(h)
            xl = float(xs_s[i + c - 1])
            self._lib_insert(xl, pool)
            self._pool, self._pool_x = pool, xl
            self.chunk_meta.append((float(xs_s[i]), xl, seed_d))
        ne_b = torch.cat(counts).cpu().numpy()
        conv_b = torch.cat(convs).cpu().numpy().astype(bool)
        # a solve is real when it holds a real parameter (pure-pad blocks are not)
        real_b = is_real_s.reshape(-1, blk).any(axis=1)
        nb = c // blk
        self.chunk_evals.extend(float(np.sum(ne_b[k:k + nb][real_b[k:k + nb]]))
                                for k in range(0, npad // blk, nb))
        self.numevals += int(float(np.sum([float(h.sum()) for h in hnes])) if hnes else 0)
        inv = np.empty_like(perm)
        inv[perm] = np.arange(npad)
        real = inv[:n]  # sorted positions of the caller's parameters
        self._record(conv_b, ne_b, real_b, real)
        return tree_map(lambda *vs: torch.cat(vs).cpu().numpy()[real], *outs)
