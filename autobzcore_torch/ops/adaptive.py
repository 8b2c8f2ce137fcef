"""Lane-batched adaptive Gauss-Kronrod interval pools (reference
``autobzcore_tpu/ops/adaptive.py``, kernel family B5).

The reference keeps one fixed-capacity interval pool per solve inside a
``lax.while_loop`` and gets its nest by ``vmap`` over inner solves: a batched
while loop steps while any lane is live and freezes finished lanes, so each
lane's result and count are those of its own loop. Here the same pools are
explicit tensors with one row per lane: ``a``, ``b``, ``err``, ``l1`` (L, cap),
``val`` (L, cap, *V), and per lane ``n``, ``evals``, the totals, the
tolerance and ``active``. A host loop steps every live lane; a finished lane
changes nothing and counts nothing.

Kernel K5 (``csrc/gk_pool.cu``) carries the pool step, each entry point
beside its plain PyTorch version:

- :func:`gk_pool_select`: the loop test of every live lane and, where it
  holds, its worst ``nbisect`` intervals (ties to the lower index, as
  ``lax.top_k``) bisected into child endpoints;
- :func:`gk_rule_reduce`: the rule's reduction of node values (and per-node
  counts) to ``val``, ``err``, ``l1`` and a count per lane, with dead
  (zero-width) intervals masked to exactly 0;
- :func:`gk_pool_update`: the two sequential scatters (left children over
  their parents, then right children to ``n..n+nbisect-1``, so the right
  child wins where a dead slot and a fresh slot collide), ``n += nbisect``,
  ``evals += count``, and the totals and tolerance recomputed over the whole
  pool.

Counters are float64 (``_count_dtype``), as in the reference.
:func:`gk_adaptive` keeps the reference's single-pool signature over one
lane. The warm start (``init_pool``, ``coarsen_pool``), the guided tier's
noise floor and stall detector, and ``fixed_rule_eval`` come with later
slices.
"""
from __future__ import annotations

import math
from dataclasses import dataclass, field
from types import SimpleNamespace

import torch

from .._device import COMPLEX, REAL, check_tensor
from .cuda_lib import check_launch, load_kernels
from .quad_rules import kronrod

def _count_dtype():
    """Evaluation counters are float64: nested counts sum inner-solve counts
    and may pass 2^31, where an int32 would wrap negative and pass the
    budget test for ever; float64 counts exactly to 2^53."""
    return REAL


def _as_eval_budget(maxiters):
    """Evaluation budget as a float (2^62 when unset)."""
    if maxiters is None:
        return float(2**62)
    return float(min(2**62, int(maxiters)))


def _err_norm(v, batch_ndim):
    """Per-batch-element 2-norm of a tensor value over its non-batch axes."""
    if type(v).__name__ == "AuxValue":
        raise NotImplementedError("AuxValue results are not ported yet (ROADMAP A1)")
    sq = torch.abs(v) ** 2
    dims = tuple(range(batch_ndim, v.ndim))
    if dims:
        sq = torch.sum(sq, dim=dims)
    return torch.sqrt(sq)


def gk_rule(order, device):
    """(xk, wk, wg) of the (2 order + 1)-point Kronrod rule as float64
    tensors on ``device``."""
    return tuple(torch.as_tensor(t, dtype=REAL, device=device) for t in kronrod(order))


def gk_nodes(ca, cb, xk):
    """Kronrod nodes of the intervals (ca, cb) (L, I): (L, I, npts), and the
    half widths (L, I)."""
    half = (cb - ca) / 2
    return ((ca + cb) / 2)[..., None] + half[..., None] * xk, half


# --- K5: rule reduction ---------------------------------------------------------
def gk_rule_reduce_plain(fx, counts, half, wk, wg):
    """Plain PyTorch version of K5's rule reduction (the reduction of the
    reference's ``gk_rule_eval``): node values fx (L, I, npts, *V), per-node
    counts (L, I, npts) or None (then each node counts 1), half widths
    (L, I). Returns val (L, I, *V), err (L, I), l1 (L, I), count (L,)."""
    L, I, P = fx.shape[:3]
    vdims = fx.ndim - 3
    wshape = (1, 1, P) + (1,) * vdims
    hshape = (L, I) + (1,) * vdims
    vk = torch.sum(wk.reshape(wshape) * fx, dim=2) * half.reshape(hshape)
    vg = torch.sum(wg.reshape(wshape) * fx, dim=2) * half.reshape(hshape)
    vl = torch.sum(wk.reshape(wshape) * torch.abs(fx), dim=2) * half.reshape(hshape)
    err = _err_norm(vk - vg, 2)
    l1 = _err_norm(vl, 2)
    # zero-width intervals are dead pool slots whose nodes all collapse onto
    # one point, which may lie outside the integrand's domain: their values
    # must not reach the pool (half = 0 zeroes finite values only)
    dead = half == 0
    vk = torch.where(dead.reshape(hshape), torch.zeros((), dtype=vk.dtype, device=vk.device), vk)
    err = torch.where(dead, torch.zeros((), dtype=REAL, device=err.device), err)
    l1 = torch.where(dead, torch.zeros((), dtype=REAL, device=l1.device), l1)
    if counts is None:
        count = torch.full((L,), float(I * P), dtype=REAL, device=fx.device)
    else:
        count = torch.sum(counts.to(REAL).reshape(L, -1), dim=1)
    return vk, err, l1, count


def gk_rule_reduce(fx, counts, half, wk, wg):
    """Reduce node values to the rule's ``val``, ``err``, ``l1`` and a count
    per lane (see :func:`gk_rule_reduce_plain`). Values are float64 or
    complex128.

    CPU tensors take the plain version; CUDA tensors launch K5's reduction,
    and anything the kernel does not take raises."""
    if fx.ndim < 3:
        raise ValueError(f"fx must be (L, I, npts, *V), got {tuple(fx.shape)}")
    L, I, P = fx.shape[:3]
    if fx.dtype not in (REAL, COMPLEX):
        raise ValueError(f"fx has dtype {fx.dtype}, expected float64 or complex128")
    check_tensor(fx, "fx")
    check_tensor(half, "half", device=fx.device, dtype=REAL, ndim=2, shape=(L, I))
    check_tensor(wk, "wk", device=fx.device, dtype=REAL, ndim=1, shape=(P,))
    check_tensor(wg, "wg", device=fx.device, dtype=REAL, ndim=1, shape=(P,))
    if counts is not None:
        check_tensor(counts, "counts", device=fx.device, dtype=REAL, ndim=3, shape=(L, I, P))
    if fx.device.type == "cpu":
        return gk_rule_reduce_plain(fx, counts, half, wk, wg)
    if fx.device.type != "cuda":
        raise ValueError(f"gk_rule_reduce runs on cpu or cuda tensors, got {fx.device}")
    vshape = tuple(fx.shape[3:])
    V = math.prod(vshape)
    val = torch.empty((L, I) + vshape, dtype=fx.dtype, device=fx.device)
    err = torch.empty((L, I), dtype=REAL, device=fx.device)
    l1 = torch.empty((L, I), dtype=REAL, device=fx.device)
    count = torch.empty((L,), dtype=REAL, device=fx.device)
    if L == 0:
        return val, err, l1, count
    lib = load_kernels()
    stream = torch.cuda.current_stream(fx.device).cuda_stream
    rc = lib.gk_rule_reduce_launch(
        fx.data_ptr(), 0 if counts is None else counts.data_ptr(), half.data_ptr(),
        wk.data_ptr(), wg.data_ptr(), val.data_ptr(), err.data_ptr(), l1.data_ptr(),
        count.data_ptr(), L, I, P, V, int(fx.dtype == COMPLEX), stream)
    check_launch(rc, "gk_rule_reduce")
    gk_rule_reduce.launches += 1
    return val, err, l1, count


gk_rule_reduce.launches = 0


def gk_rule_eval(batch_f, p, aa, bb, xk, wk, wg, node_builder=lambda x: x, stats=False):
    """The reference's single-pool ``gk_rule_eval``: evaluate the rule on the
    intervals (aa, bb) (K,) with one batched integrand call over the nodes.
    With ``stats``, ``batch_f`` returns (values, per-node counts) and the
    counts are summed. Returns (val (K, *V), err (K,), l1 (K,), count)."""
    nodes, half = gk_nodes(aa[None], bb[None], xk)
    K, P = aa.shape[0], xk.shape[0]
    out = batch_f(node_builder(nodes.reshape(-1)), p)
    fx, per_node = out if stats else (out, None)
    fx = fx.reshape((1, K, P) + tuple(fx.shape[1:]))
    counts = None if per_node is None else per_node.to(REAL).reshape(1, K, P)
    val, err, l1, count = gk_rule_reduce(fx.contiguous(), counts, half.contiguous(), wk, wg)
    return val[0], err[0], l1[0], count[0]


# --- the pool -------------------------------------------------------------------
@dataclass
class GKPool:
    """Interval pools of L lanes, one row per lane (the reference's
    ``(pool_a, pool_b, pool_val, pool_err, pool_l1, n, evals)`` state of one
    solve), with each lane's totals, tolerance and live flag."""

    a: torch.Tensor  # (L, cap) float64
    b: torch.Tensor
    err: torch.Tensor
    l1: torch.Tensor
    val: torch.Tensor  # (L, cap, *V) float64 or complex128
    n: torch.Tensor  # (L,) int64 live slots
    evals: torch.Tensor  # (L,) float64
    atol: torch.Tensor  # (L,) float64
    rtol: float
    max_evals: float
    tot_val: torch.Tensor = None  # (L, *V)
    tot_err: torch.Tensor = None  # (L,)
    tol: torch.Tensor = None  # (L,)
    active: torch.Tensor = None  # (L,) bool

    @property
    def cap(self):
        return self.a.shape[1]

    @property
    def nlanes(self):
        return self.a.shape[0]

    def real_val(self):
        """The value pool as float64 (complex values as (re, im) pairs)."""
        return torch.view_as_real(self.val) if self.val.is_complex() else self.val


def _flat(t, lead):
    return t.reshape(tuple(t.shape[:lead]) + (-1,))


def gk_pool_totals_plain(pool):
    """Totals over the whole pool and the lanes' tolerances, in place."""
    pool.tot_val = torch.sum(pool.val, dim=1)
    pool.tot_err = torch.sum(pool.err, dim=1)
    norm = torch.sqrt(torch.sum(torch.abs(_flat(pool.tot_val, 1)) ** 2, dim=1))
    pool.tol = torch.maximum(pool.atol, pool.rtol * norm)


def gk_pool_totals(pool):
    """Recompute every lane's ``tot_val``, ``tot_err`` and ``tol =
    max(atol, rtol * |tot_val|)`` over its whole pool (K5 on CUDA)."""
    if pool.a.device.type == "cpu":
        return gk_pool_totals_plain(pool)
    _pool_call(pool, "totals", None, None, None, None, None, None, None, 0, update=False)
    return None


def gk_pool_select_plain(pool, nbisect):
    """Plain PyTorch version of K5's select. Updates ``pool.active`` with the
    loop test and returns (idx (L, nbisect) int64, ca, cb (L, 2 nbisect)):
    the worst intervals of each lane, ties to the lower index, and their
    children (left halves first). Lanes that stop get zero-width children."""
    pool.active = (pool.active & (pool.tot_err > pool.tol) & (pool.n + nbisect <= pool.cap)
                   & (pool.evals < pool.max_evals))
    # a stable descending sort keeps tied errors in index order, as top_k
    idx = torch.sort(pool.err, dim=1, descending=True, stable=True).indices[:, :nbisect].contiguous()
    aa, bb = pool.a.gather(1, idx), pool.b.gather(1, idx)
    mm = (aa + bb) / 2
    ca, cb = torch.cat([aa, mm], dim=1), torch.cat([mm, bb], dim=1)
    live = pool.active[:, None]
    zero = torch.zeros((), dtype=REAL, device=ca.device)
    return idx, torch.where(live, ca, zero), torch.where(live, cb, zero)


def gk_pool_select(pool, nbisect):
    """The loop test and worst-interval selection of every live lane (see
    :func:`gk_pool_select_plain`). CPU pools take the plain version; CUDA
    pools launch K5's select."""
    if pool.a.device.type == "cpu":
        return gk_pool_select_plain(pool, nbisect)
    L = pool.nlanes
    idx = torch.empty((L, nbisect), dtype=torch.int64, device=pool.a.device)
    ca = torch.empty((L, 2 * nbisect), dtype=REAL, device=pool.a.device)
    cb = torch.empty_like(ca)
    _pool_call(pool, "select", idx, ca, cb, None, None, None, None, nbisect, update=False)
    return idx, ca, cb


def gk_pool_update_plain(pool, nbisect, idx, ca, cb, cval, cerr, cl1, count):
    """Plain PyTorch version of K5's update, in place on the live lanes:
    left children over their parents, then right children to the fresh slots
    ``n..n+nbisect-1`` (two sequential scatters: where ``n < nbisect`` a
    picked dead slot collides with a fresh slot and the right child must
    win), ``n += nbisect``, ``evals += count``, then the totals."""
    live = pool.active.nonzero().squeeze(1)
    if live.numel():
        rows = live[:, None]
        left = idx[live]
        fresh = pool.n[live, None] + torch.arange(nbisect, device=live.device)
        for arr, c in ((pool.a, ca), (pool.b, cb), (pool.err, cerr), (pool.l1, cl1), (pool.val, cval)):
            c = c[live]
            arr[rows, left] = c[:, :nbisect]
            arr[rows, fresh] = c[:, nbisect:]
        pool.n[live] += nbisect
        pool.evals[live] += count[live]
    gk_pool_totals_plain(pool)


def gk_pool_update(pool, nbisect, idx, ca, cb, cval, cerr, cl1, count):
    """Write a trip's children into the live lanes' pools (see
    :func:`gk_pool_update_plain`). CPU pools take the plain version; CUDA
    pools launch K5's update."""
    L = pool.nlanes
    check_tensor(idx, "idx", device=pool.a.device, dtype=torch.int64, shape=(L, nbisect), ndim=2)
    for name, t in (("ca", ca), ("cb", cb), ("cerr", cerr), ("cl1", cl1)):
        check_tensor(t, name, device=pool.a.device, dtype=REAL, shape=(L, 2 * nbisect), ndim=2)
    check_tensor(cval, "cval", device=pool.a.device, dtype=pool.val.dtype,
                 shape=(L, 2 * nbisect) + tuple(pool.val.shape[2:]), ndim=pool.val.ndim)
    check_tensor(count, "count", device=pool.a.device, dtype=REAL, shape=(L,), ndim=1)
    if pool.a.device.type == "cpu":
        return gk_pool_update_plain(pool, nbisect, idx, ca, cb, cval, cerr, cl1, count)
    _pool_call(pool, "update", idx, ca, cb, cval, cerr, cl1, count, nbisect, update=True)
    return None


def _pool_call(pool, entry, idx, ca, cb, cval, cerr, cl1, count, nbisect, update):
    """Launch one of K5's pool entry points on a CUDA pool."""
    if pool.a.device.type != "cuda":
        raise ValueError(f"gk_pool runs on cpu or cuda tensors, got {pool.a.device}")
    L, cap = pool.a.shape
    _check_pool(pool)
    if L == 0:
        return
    if cap > _POOL_MAX_CAP:
        raise ValueError(f"the CUDA pool takes cap <= {_POOL_MAX_CAP}, got {cap}")
    val = pool.real_val()
    V = math.prod(val.shape[2:])
    if pool.tot_val is None:
        pool.tot_val = torch.empty((L,) + tuple(pool.val.shape[2:]), dtype=pool.val.dtype,
                                   device=pool.val.device)
        pool.tot_err = torch.empty((L,), dtype=REAL, device=pool.a.device)
        pool.tol = torch.empty((L,), dtype=REAL, device=pool.a.device)
    tot_val = torch.view_as_real(pool.tot_val) if pool.tot_val.is_complex() else pool.tot_val
    cval_r = None if cval is None else (torch.view_as_real(cval) if cval.is_complex() else cval)
    lib = load_kernels()
    stream = torch.cuda.current_stream(pool.a.device).cuda_stream
    ptr = lambda t: 0 if t is None else t.data_ptr()  # noqa: E731
    if entry == "select":
        rc = lib.gk_pool_select_launch(
            pool.a.data_ptr(), pool.b.data_ptr(), pool.err.data_ptr(), pool.n.data_ptr(),
            pool.evals.data_ptr(), pool.tot_err.data_ptr(), pool.tol.data_ptr(),
            pool.active.data_ptr(), idx.data_ptr(), ca.data_ptr(), cb.data_ptr(),
            L, cap, nbisect, float(pool.max_evals), stream)
    else:
        rc = lib.gk_pool_update_launch(
            pool.a.data_ptr(), pool.b.data_ptr(), pool.err.data_ptr(), pool.l1.data_ptr(),
            val.data_ptr(), pool.n.data_ptr(), pool.evals.data_ptr(), tot_val.data_ptr(),
            pool.tot_err.data_ptr(), pool.tol.data_ptr(), pool.atol.data_ptr(),
            pool.active.data_ptr(), ptr(idx), ptr(ca), ptr(cb), ptr(cval_r), ptr(cerr),
            ptr(cl1), ptr(count), L, cap, V, nbisect, float(pool.rtol), int(update), stream)
    check_launch(rc, f"gk_pool_{entry}")
    gk_pool_launches[entry] += 1


def _check_pool(pool):
    """Raise unless the pool's tensors have the shapes, dtypes and layout the
    pool kernels read and write through raw pointers."""
    L, cap = pool.a.shape
    dev = pool.a.device
    for name in ("a", "b", "err", "l1"):
        check_tensor(getattr(pool, name), name, device=dev, dtype=REAL, ndim=2, shape=(L, cap))
    check_tensor(pool.val, "val", device=dev, shape=(L, cap))
    if pool.val.dtype not in (REAL, COMPLEX):
        raise ValueError(f"val has dtype {pool.val.dtype}, expected float64 or complex128")
    check_tensor(pool.n, "n", device=dev, dtype=torch.int64, ndim=1, shape=(L,))
    for name in ("evals", "atol"):
        check_tensor(getattr(pool, name), name, device=dev, dtype=REAL, ndim=1, shape=(L,))
    check_tensor(pool.active, "active", device=dev, dtype=torch.bool, ndim=1, shape=(L,))
    for name in ("tot_err", "tol"):
        t = getattr(pool, name)
        if t is not None:
            check_tensor(t, name, device=dev, dtype=REAL, ndim=1, shape=(L,))
    if pool.tot_val is not None:
        check_tensor(pool.tot_val, "tot_val", device=dev, dtype=pool.val.dtype,
                     shape=(L,) + tuple(pool.val.shape[2:]))


_POOL_MAX_CAP = 1 << 16  # the pool kernels keep a lane's reduction in one block
gk_pool_launches = {"select": 0, "update": 0, "totals": 0}


def pool_kernels(plain=False):
    """The pool step's functions: K5's wrappers, or with ``plain`` their
    plain versions, which run on any device (to hold a whole solve on the
    card against the kernels)."""
    if plain:
        return SimpleNamespace(select=gk_pool_select_plain, update=gk_pool_update_plain,
                               totals=gk_pool_totals_plain, rule_reduce=gk_rule_reduce_plain)
    return SimpleNamespace(select=gk_pool_select, update=gk_pool_update, totals=gk_pool_totals,
                           rule_reduce=gk_rule_reduce)


@dataclass
class LoopStats:
    """Trips of each nest level (index 0 = innermost) and host syncs."""

    trips: dict = field(default_factory=dict)
    syncs: int = 0

    def trip(self, level):
        self.trips[level] = self.trips.get(level, 0) + 1


def gk_adaptive_lanes(rule, segs, atol, *, cap, nbisect, rtol=0.0, maxiters=None, presplit=1,
                      sync_every=1, kernels=None, stats=None, level=0):
    """Adaptive GK integration of L independent lanes (the reference's
    ``gk_adaptive`` under ``vmap``, cold start).

    ``rule(ca, cb, active, live)`` evaluates the rule on the intervals
    (ca, cb) (L, I) of the lanes that ``active`` (L,) marks, and returns
    (val (L, I, *V), err (L, I), l1 (L, I), count (L,)); ``live`` holds the
    indices of the active lanes when the loop has them at hand (else None).
    ``segs`` (L, S+1) are each lane's breakpoints, ``atol`` (L,) its absolute
    tolerance. ``presplit=P`` starts from P uniform pieces per segment,
    clamped to leave refinement room.

    The host tests whether any lane is live every ``sync_every`` trips (with
    1, it also hands ``rule`` the live lanes); trips past the last live lane
    change nothing. Returns (tot_val (L, *V), tot_err (L,), evals (L,),
    converged (L,) bool)."""
    kernels = kernels or pool_kernels()
    L, S1 = segs.shape
    nseg = S1 - 1
    P = max(1, min(int(presplit), (cap - 2 * nbisect) // max(nseg, 1)))
    a0, b0 = segs[:, :-1], segs[:, 1:]
    if P > 1:
        t = torch.arange(P + 1, dtype=REAL, device=segs.device) / P
        allpts = a0[..., None] + (b0 - a0)[..., None] * t
        a0 = allpts[..., :-1].reshape(L, -1)
        b0 = allpts[..., 1:].reshape(L, -1)
        nseg *= P
    a0, b0 = a0.contiguous(), b0.contiguous()
    everyone = torch.ones(L, dtype=torch.bool, device=segs.device)
    val0, err0, l10, count0 = rule(a0, b0, everyone, torch.arange(L, device=segs.device))

    def pad(v):
        out = torch.zeros((L, cap) + tuple(v.shape[2:]), dtype=v.dtype, device=v.device)
        out[:, :nseg] = v
        return out

    pool = GKPool(a=pad(a0), b=pad(b0), err=pad(err0), l1=pad(l10), val=pad(val0),
                  n=torch.full((L,), nseg, dtype=torch.int64, device=segs.device),
                  evals=count0.to(_count_dtype()).clone(), atol=atol.contiguous(),
                  rtol=float(rtol), max_evals=_as_eval_budget(maxiters), active=everyone.clone())
    kernels.totals(pool)
    trips = 0
    while True:
        idx, ca, cb = kernels.select(pool, nbisect)
        live = None
        if trips % sync_every == 0:
            if stats is not None:
                stats.syncs += 1
            if sync_every == 1:
                live = pool.active.nonzero().squeeze(1)
                if live.numel() == 0:
                    break
            elif not bool(pool.active.any()):
                break
        cval, cerr, cl1, count = rule(ca, cb, pool.active, live)
        kernels.update(pool, nbisect, idx, ca, cb, cval.contiguous(), cerr.contiguous(),
                       cl1.contiguous(), count.contiguous())
        trips += 1
        if stats is not None:
            stats.trip(level)
    return pool.tot_val, pool.tot_err, pool.evals, pool.tot_err <= pool.tol


def _gk_tolerances(abstol, reltol):
    """(atol, rtol): both unset is pure relative at sqrt(eps), otherwise an
    unset one is zero (the reference's rule)."""
    if abstol is None and reltol is None:
        return 0.0, math.sqrt(torch.finfo(REAL).eps)
    return (0.0 if abstol is None else float(abstol), 0.0 if reltol is None else float(reltol))


def gk_adaptive(batch_f, p, segs, *, order=7, cap=256, nbisect=4, abstol=None, reltol=None,
                maxiters=None, node_builder=lambda x: x, norm=None, stats=False, noise_rfloor=0.0,
                stall_patience=0, init_pool=None, seed_width=None, seed_coarsen=True, presplit=1,
                _return_state=False):
    """Adaptive GK integration of ``batch_f(xs, p)`` over the breakpoints
    ``segs`` (S+1,): the reference's single-pool ``gk_adaptive``, cold start,
    as one lane of :func:`gk_adaptive_lanes`. Returns (val, err, numevals,
    converged). The warm start (``init_pool``, ``seed_width``, the returned
    state) is the IAI warm slice, and ``noise_rfloor``/``stall_patience`` the
    guided tier; both raise, as does a custom ``norm`` (the pools use the
    2-norm)."""
    if init_pool is not None or seed_width is not None or _return_state:
        raise NotImplementedError("warm-started pools are not ported yet (ROADMAP A5, IAI warm slice)")
    if noise_rfloor or stall_patience:
        raise NotImplementedError("the noise floor and stall detector belong to the guided tier, "
                                  "which is not ported (ROADMAP A5)")
    if norm is not None:
        raise NotImplementedError("custom norms are not ported yet: the pools use the 2-norm (ROADMAP A5)")
    segs = torch.as_tensor(segs, dtype=REAL)
    xk, wk, wg = gk_rule(order, segs.device)
    atol, rtol = _gk_tolerances(abstol, reltol)

    def rule(ca, cb, active, live):
        out = gk_rule_eval(batch_f, p, ca[0], cb[0], xk, wk, wg, node_builder, stats)
        return tuple(o[None] for o in out)

    val, err, evals, conv = gk_adaptive_lanes(
        rule, segs[None].contiguous(), torch.full((1,), atol, dtype=REAL, device=segs.device),
        cap=cap, nbisect=nbisect, rtol=rtol, maxiters=maxiters, presplit=presplit)
    return val[0], err[0], evals[0], conv[0]


def scatter_lanes(L, live, *outs):
    """Full-lane (L, ...) tensors, zero outside the lanes ``live``, from the
    outputs of those lanes."""
    full = []
    for o in outs:
        f = torch.zeros((L,) + tuple(o.shape[1:]), dtype=o.dtype, device=o.device)
        f[live] = o
        full.append(f)
    return full
