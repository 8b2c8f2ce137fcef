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

The warm start seeds a pool from an inherited partition instead of the
domain's breakpoints (reference ``gk_adaptive(init_pool=...)``):

- :func:`coarsen_pool` (kernel K6, ``csrc/gk_coarsen.cu``): sort each lane's
  pool by left endpoint, merge dyadic sibling pairs that are stale or that
  cap pressure gives up, and compact the survivors to the front;
- :func:`gk_pool_seed` (K5's seed entry): write one chunk of re-evaluated
  seed intervals to contiguous slots, ``n = n0``, ``evals += count``, and the
  totals and tolerance.

Fixed rules (kernel family B5 fixed): :func:`fixed_rule_reduce` (kernel
K17, ``csrc/fixed_rule.cu``) reduces node values (L, S, npt, *V) over the
nodes, times each segment's half width, then over the segments, and
:func:`fixed_rule_eval` keeps the reference's single-rule signature over it
(``QuadratureFunction`` and fixed nest levels).

Counters are float64 (``_count_dtype``), as in the reference.
:func:`gk_adaptive` keeps the reference's single-pool signature over one
lane. The guided tier's noise floor and stall detector come with a later
slice.
"""
from __future__ import annotations

import math
from dataclasses import dataclass, field
from types import SimpleNamespace

import numpy as np
import torch

from .._device import COMPLEX, REAL, check_tensor
from .cuda_lib import check_launch, load_kernels, stream_handle
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
    stream = stream_handle(fx.device)
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


# --- K17: fixed rules --------------------------------------------------------------
def fixed_rule_reduce_plain(fx, w, half):
    """Plain PyTorch version of K17: ``sum_s (sum_j w_j fx[:, s, j]) half[:,
    s]`` for node values fx (L, S, npt, *V), weights w (npt,) and half widths
    half (L, S), the reference's two-level order; returns (L, *V)."""
    vdims = fx.ndim - 3
    wshape = (1, 1, -1) + (1,) * vdims
    hshape = tuple(half.shape) + (1,) * vdims
    return torch.sum(torch.sum(w.reshape(wshape) * fx, dim=2) * half.reshape(hshape), dim=1)


def fixed_rule_reduce(fx, w, half):
    """The fixed rule's reduction (see :func:`fixed_rule_reduce_plain`) of
    float64 or complex128 node values; the weights and half widths are
    float64 (the reference casts them to the values' real dtype).

    CPU tensors take the plain version; CUDA tensors launch K17, and anything
    the kernel does not take raises."""
    if fx.ndim < 3:
        raise ValueError(f"fx must be (L, S, npt, *V), got {tuple(fx.shape)}")
    if fx.dtype not in (REAL, COMPLEX):
        raise ValueError(f"fx has dtype {fx.dtype}, expected float64 or complex128")
    L, S, P = fx.shape[:3]
    check_tensor(fx, "fx")
    check_tensor(w, "w", device=fx.device, dtype=REAL, ndim=1, shape=(P,))
    check_tensor(half, "half", device=fx.device, dtype=REAL, ndim=2, shape=(L, S))
    if fx.device.type == "cpu":
        return fixed_rule_reduce_plain(fx, w, half)
    if fx.device.type != "cuda":
        raise ValueError(f"fixed_rule_reduce runs on cpu or cuda tensors, got {fx.device}")
    vshape = tuple(fx.shape[3:])
    out = torch.empty((L,) + vshape, dtype=fx.dtype, device=fx.device)
    if L == 0 or S == 0 or P == 0 or out.numel() == 0:
        return out.zero_()
    fr = torch.view_as_real(fx) if fx.is_complex() else fx
    C = math.prod(fr.shape[3:])
    lib = load_kernels()
    stream = stream_handle(fx.device)
    rc = lib.fixed_rule_reduce_launch(fr.data_ptr(), w.data_ptr(), half.data_ptr(), out.data_ptr(),
                                      L, S, P, C, stream)
    check_launch(rc, "fixed_rule_reduce")
    fixed_rule_reduce.launches += 1
    return out


fixed_rule_reduce.launches = 0


def fixed_rule_nodes(segs, x):
    """The nodes (L, S, npt) of the rule ``x`` (npt,) on [-1, 1] over the
    segments of each lane's breakpoints ``segs`` (L, S+1), and the half
    widths (L, S)."""
    aa, bb = segs[:, :-1], segs[:, 1:]
    mid = (aa + bb) / 2
    half = (bb - aa) / 2
    return mid[..., None] + half[..., None] * x, half


def fixed_rule_eval(batch_f, p, segs, x, w, node_builder=lambda x: x, stats=False):
    """Apply a fixed rule (nodes ``x``, weights ``w`` on [-1, 1]) to each
    segment of ``segs`` (S+1,) and sum, with one batched integrand call
    ``batch_f(nodes, p)`` (the reference's ``fixed_rule_eval``). With
    ``stats``, ``batch_f`` returns (values, per-node counts) and the count
    is their sum, else S * npt. Returns (value, count)."""
    segs = torch.as_tensor(segs, dtype=REAL)
    x = torch.as_tensor(np.asarray(x), dtype=REAL, device=segs.device)
    w = torch.as_tensor(np.asarray(w), dtype=REAL, device=segs.device)
    nodes, half = fixed_rule_nodes(segs[None], x)
    S, P = half.shape[1], x.shape[0]
    out = batch_f(node_builder(nodes.reshape(-1)), p)
    fx, per_node = out if stats else (out, None)
    count = (torch.sum(per_node.to(_count_dtype())) if stats
             else torch.tensor(float(S * P), dtype=_count_dtype(), device=segs.device))
    if not fx.is_complex():
        fx = fx.to(REAL)
    fx = fx.reshape((1, S, P) + tuple(fx.shape[1:])).contiguous()
    return fixed_rule_reduce(fx, w, half.contiguous())[0], count


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


def _pool_call(pool, entry, idx, ca, cb, cval, cerr, cl1, count, nbisect, update, seed=None):
    """Launch one of K5's pool entry points on a CUDA pool (``nbisect`` is
    the chunk width C for the seed entry, ``seed`` its (start, n0,
    seeding))."""
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
    stream = stream_handle(pool.a.device)
    ptr = lambda t: 0 if t is None else t.data_ptr()  # noqa: E731
    if entry == "select":
        rc = lib.gk_pool_select_launch(
            pool.a.data_ptr(), pool.b.data_ptr(), pool.err.data_ptr(), pool.n.data_ptr(),
            pool.evals.data_ptr(), pool.tot_err.data_ptr(), pool.tol.data_ptr(),
            pool.active.data_ptr(), idx.data_ptr(), ca.data_ptr(), cb.data_ptr(),
            L, cap, nbisect, float(pool.max_evals), stream)
    elif entry == "seed":
        start, n0, seeding = seed
        rc = lib.gk_pool_seed_launch(
            pool.a.data_ptr(), pool.b.data_ptr(), pool.err.data_ptr(), pool.l1.data_ptr(),
            val.data_ptr(), pool.n.data_ptr(), pool.evals.data_ptr(), tot_val.data_ptr(),
            pool.tot_err.data_ptr(), pool.tol.data_ptr(), pool.atol.data_ptr(), seeding.data_ptr(),
            n0.data_ptr(), ca.data_ptr(), cb.data_ptr(), cval_r.data_ptr(), cerr.data_ptr(),
            cl1.data_ptr(), count.data_ptr(), L, cap, V, nbisect, int(start), float(pool.rtol),
            stream)
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
gk_pool_launches = {"select": 0, "update": 0, "totals": 0, "seed": 0}


# --- the warm start: K6 (coarsening) and K5's seed entry ------------------------------
def coarsen_pool_plain(a, b, e, n, segs, tol, merge_factor=1e-3, target_mult=2.0):
    """Plain PyTorch version of K6: the reference's ``coarsen_pool`` over L
    lanes, operation for operation. ``a, b, e`` (L, cap) are pools with
    ``n`` (L,) live slots, unsorted, dead slots zero-width; ``segs`` (L, S+1)
    or (S+1,) the original breakpoints and ``tol`` (L,) the absolute
    tolerance each pool certifies against. Returns (a2, b2 (L, cap), n2 (L,)
    int64): survivors in left-endpoint order at the front, zeros behind."""
    L, cap = a.shape
    dev = a.device
    segs = segs.expand(L, -1) if segs.ndim == 1 else segs
    nseg = segs.shape[1] - 1
    inf = torch.tensor(math.inf, dtype=REAL, device=dev)
    zero = torch.zeros((), dtype=REAL, device=dev)
    live = torch.arange(cap, device=dev)[None, :] < n[:, None]
    # stable argsorts, as jnp.argsort: ties keep index order
    order = torch.sort(torch.where(live, a, inf), dim=1, stable=True).indices
    a_s, b_s, e_s = a.gather(1, order), b.gather(1, order), e.gather(1, order)
    w = b_s - a_s
    live_s = live.gather(1, order) & (w > 0)  # zero-width dead slots drop
    span = segs[:, -1] - segs[:, 0]
    seg_id = torch.clamp(torch.searchsorted(segs.contiguous(), a_s.contiguous(), right=True) - 1,
                         0, nseg - 1)
    s0 = segs.gather(1, seg_id)
    # dyadic left-child test: (a - s0) / w is an even integer (torch.round
    # rounds half to even, as jnp.round)
    k = (a_s - s0) / torch.where(w > 0, w, torch.ones((), dtype=REAL, device=dev))
    is_left = torch.abs(k - torch.round(k / 2) * 2) < 1e-6

    def shift(x, fill):
        return torch.cat([x[:, 1:], torch.full((L, 1), fill, dtype=x.dtype, device=dev)], dim=1)

    a_n, b_n, e_n = shift(a_s, 0.0), shift(b_s, 0.0), shift(e_s, 0.0)
    w_n = b_n - a_n
    live_n = shift(live_s, False)
    seg_n = shift(seg_id, -1)
    eps_w = 1e-9 * torch.maximum(w, w_n)
    siblings = (live_s & live_n & is_left & (w > 0) & (torch.abs(b_s - a_n) <= eps_w)
                & (torch.abs(w - w_n) <= eps_w) & (seg_id == seg_n))
    lsafe = torch.clamp(span, min=torch.finfo(REAL).tiny)[:, None]
    tol = tol[:, None]
    share = tol * (w + w_n) / lsafe
    cost = e_s + e_n
    merge_abs = siblings & (cost < merge_factor * share)
    # cap pressure: the cheapest sibling pairs merge until the pool fits
    # target_mult x its load-bearing count
    n_live = live_s.sum(dim=1)
    load = (live_s & (e_s > 0.1 * tol * w / lsafe)).sum(dim=1)
    target = torch.clamp((target_mult * load.to(REAL)).to(torch.int64), min=max(nseg + 1, 8))
    need = torch.clamp(n_live - target, 0, cap)
    csort = torch.sort(torch.where(siblings, cost, inf), dim=1).values
    kth = csort.gather(1, torch.clamp(need - 1, 0, cap - 1)[:, None])
    merge_cap = siblings & (need > 0)[:, None] & (cost <= kth) & torch.isfinite(kth)
    merge = merge_abs | merge_cap
    merged_right = torch.cat([torch.zeros((L, 1), dtype=torch.bool, device=dev), merge[:, :-1]], dim=1)
    keep = live_s & ~merged_right
    new_b = torch.where(merge, b_n, b_s)
    order2 = torch.sort((~keep).to(torch.uint8), dim=1, stable=True).indices  # kept first
    live2 = keep.gather(1, order2)
    a2 = torch.where(live2, a_s.gather(1, order2), zero)
    b2 = torch.where(live2, new_b.gather(1, order2), zero)
    return a2, b2, keep.sum(dim=1)


def coarsen_pool(a, b, e, n, segs, tol, merge_factor=1e-3, target_mult=2.0):
    """Error-guided sibling coarsening of L warm-start pools (see
    :func:`coarsen_pool_plain`). CPU pools take the plain version; CUDA
    pools launch K6, one thread block per lane (cap <= 2048)."""
    L, cap = a.shape
    dev = a.device
    if segs.ndim == 1:
        segs = segs.expand(L, -1)
    segs = segs.contiguous()
    for name, t in (("a", a), ("b", b), ("e", e)):
        check_tensor(t, name, device=dev, dtype=REAL, ndim=2, shape=(L, cap))
    check_tensor(n, "n", device=dev, dtype=torch.int64, ndim=1, shape=(L,))
    check_tensor(segs, "segs", device=dev, dtype=REAL, ndim=2)
    check_tensor(tol, "tol", device=dev, dtype=REAL, ndim=1, shape=(L,))
    if segs.shape[0] != L or segs.shape[1] < 2:
        raise ValueError(f"segs must be (L, S+1) with S >= 1, got {tuple(segs.shape)}")
    if dev.type == "cpu":
        return coarsen_pool_plain(a, b, e, n, segs, tol, merge_factor, target_mult)
    if dev.type != "cuda":
        raise ValueError(f"coarsen_pool runs on cpu or cuda tensors, got {dev}")
    if cap > COARSEN_MAX_CAP or segs.shape[1] > COARSEN_MAX_SEGS:
        raise ValueError(f"the CUDA coarsening takes cap <= {COARSEN_MAX_CAP} and at most "
                         f"{COARSEN_MAX_SEGS} breakpoints, got cap {cap}, {segs.shape[1]}")
    a2 = torch.empty_like(a)
    b2 = torch.empty_like(b)
    n2 = torch.empty_like(n)
    if L == 0:
        return a2, b2, n2
    lib = load_kernels()
    stream = stream_handle(dev)
    rc = lib.gk_coarsen_launch(
        a.contiguous().data_ptr(), b.contiguous().data_ptr(), e.contiguous().data_ptr(),
        n.contiguous().data_ptr(), segs.data_ptr(), tol.contiguous().data_ptr(), a2.data_ptr(),
        b2.data_ptr(), n2.data_ptr(), L, cap, segs.shape[1], float(merge_factor),
        float(target_mult), stream)
    check_launch(rc, "gk_coarsen")
    coarsen_pool.launches += 1
    return a2, b2, n2


coarsen_pool.launches = 0
COARSEN_MAX_CAP = 2048  # K6 keeps a lane's sort keys in shared memory
COARSEN_MAX_SEGS = 64


def gk_pool_seed_plain(pool, start, ca, cb, cval, cerr, cl1, count, n0, seeding):
    """Plain PyTorch version of K5's seed entry, in place: for the lanes that
    ``seeding`` (L,) marks, the chunk's intervals (ca, cb) (L, C), values,
    errors and l1 go to slots ``start..start+C-1``, ``n = n0`` and ``evals +=
    count`` (every slot of the chunk counts, dead or re-evaluated); then every
    lane's totals and tolerance."""
    live = seeding.nonzero().squeeze(1)
    if live.numel():
        C = ca.shape[1]
        rows = live[:, None]
        slots = start + torch.arange(C, device=live.device)
        for arr, c in ((pool.a, ca), (pool.b, cb), (pool.err, cerr), (pool.l1, cl1), (pool.val, cval)):
            arr[rows, slots] = c[live]
        pool.n[live] = n0[live]
        pool.evals[live] += count[live]
    gk_pool_totals_plain(pool)


def gk_pool_seed(pool, start, ca, cb, cval, cerr, cl1, count, n0, seeding):
    """Write one seed chunk into the seeding lanes' pools (see
    :func:`gk_pool_seed_plain`). CPU pools take the plain version; CUDA pools
    launch K5's seed entry."""
    L, cap = pool.a.shape
    dev = pool.a.device
    C = ca.shape[1] if ca.ndim == 2 else -1
    if not (0 <= start and start + C <= cap and C > 0):
        raise ValueError(f"seed chunk of {C} slots at {start} does not fit cap {cap}")
    for name, t in (("ca", ca), ("cb", cb), ("cerr", cerr), ("cl1", cl1)):
        check_tensor(t, name, device=dev, dtype=REAL, shape=(L, C), ndim=2)
    check_tensor(cval, "cval", device=dev, dtype=pool.val.dtype,
                 shape=(L, C) + tuple(pool.val.shape[2:]), ndim=pool.val.ndim)
    check_tensor(count, "count", device=dev, dtype=REAL, shape=(L,), ndim=1)
    check_tensor(n0, "n0", device=dev, dtype=torch.int64, shape=(L,), ndim=1)
    check_tensor(seeding, "seeding", device=dev, dtype=torch.bool, shape=(L,), ndim=1)
    if dev.type == "cpu":
        return gk_pool_seed_plain(pool, start, ca, cb, cval, cerr, cl1, count, n0, seeding)
    _pool_call(pool, "seed", None, ca, cb, cval, cerr, cl1, count, C, update=True,
               seed=(start, n0, seeding))
    return None


def pool_kernels(plain=False):
    """The pool step's functions: the wrappers of K5 and K6, or with
    ``plain`` their plain versions, which run on any device (to hold a whole
    solve on the card against the kernels)."""
    if plain:
        return SimpleNamespace(select=gk_pool_select_plain, update=gk_pool_update_plain,
                               totals=gk_pool_totals_plain, rule_reduce=gk_rule_reduce_plain,
                               coarsen=coarsen_pool_plain, seed=gk_pool_seed_plain)
    return SimpleNamespace(select=gk_pool_select, update=gk_pool_update, totals=gk_pool_totals,
                           rule_reduce=gk_rule_reduce, coarsen=coarsen_pool, seed=gk_pool_seed)


@dataclass
class LoopStats:
    """Refinement trips and seed trips of each nest level (index 1 =
    innermost), and host syncs. A fused leaf solve runs its lanes' trips on
    the device: :meth:`device_trip` keeps each launch's most trips of any
    lane there, and :meth:`read_device_trips` adds them into ``trips`` with
    one host read. The nest reads them once a solve is done, just before
    its results are read, so the read adds no wait of its own."""

    trips: dict = field(default_factory=dict)
    seed_trips: dict = field(default_factory=dict)
    syncs: int = 0
    pending: list = field(default_factory=list, repr=False)  # (level, 0-d int64 device tensor)

    def trip(self, level):
        self.trips[level] = self.trips.get(level, 0) + 1

    def seed_trip(self, level):
        self.seed_trips[level] = self.seed_trips.get(level, 0) + 1

    def device_trip(self, level, lane_trips):
        """Count one launch's trips at ``level``: the most of its lanes'
        ``lane_trips`` (L,), kept on the device until read."""
        if lane_trips.numel():
            self.pending.append((level, lane_trips.amax()))

    def read_device_trips(self):
        """Add the pending device counts into ``trips`` (one host read)."""
        for level in {lv for lv, _ in self.pending}:
            most = torch.stack([t for lv, t in self.pending if lv == level])
            self.trips[level] = self.trips.get(level, 0) + int(most.sum())
        self.pending.clear()
        return self.trips


def seed_chunk_width(seed_width, nbisect, cap):
    """The reference's seed chunk ``C = min(max(seed_width or 2 nbisect,
    2 nbisect, 2), cap)``."""
    return min(max(seed_width or 2 * nbisect, 2 * nbisect, 2), cap)


def _seeded_pool(rule, segs, atol, init_pool, *, cap, nbisect, rtol, maxiters, kernels, stats,
                 level, seed_width, seed_coarsen, seed_n):
    """The warm start (reference ``gk_adaptive`` with ``init_pool``): the
    inherited pools, coarsened when ``seed_coarsen``, re-evaluated in chunks
    of C intervals at ``start = min(k C, cap - C)``, every chunk's count
    added. ``seed_n`` is the host's count of the most live seed slots of any
    lane where the caller knows it (then the trip count needs no sync), else
    None."""
    a_in, b_in, e_in, n_in = init_pool
    L = segs.shape[0]
    dev = segs.device
    if a_in.shape != (L, cap):
        raise ValueError(f"init_pool must hold (L, cap) = {(L, cap)} pools, got {tuple(a_in.shape)}")
    if seed_coarsen:
        a_c, b_c, n0 = kernels.coarsen(a_in, b_in, e_in, n_in, segs, atol)
        seed_n = None
    else:
        a_c, b_c, n0 = a_in, b_in, n_in
    C = seed_chunk_width(seed_width, nbisect, cap)
    if seed_n is None:
        if stats is not None:
            stats.syncs += 1
        seed_n = int(n0.max())
    if seed_n <= 0:
        raise ValueError("a warm-start pool needs at least one live interval")
    everyone = torch.ones(L, dtype=torch.bool, device=dev)
    pool = None
    k = 0
    while k * C < seed_n:
        start = min(k * C, cap - C)
        seeding = k * C < n0  # a lane seeds while chunks of it remain
        live = seeding.nonzero().squeeze(1)
        if stats is not None:
            stats.syncs += 1
        ca = a_c[:, start:start + C].contiguous()
        cb = b_c[:, start:start + C].contiguous()
        cval, cerr, cl1, count = rule(ca, cb, seeding, live)
        if pool is None:
            val = torch.zeros((L, cap) + tuple(cval.shape[2:]), dtype=cval.dtype, device=dev)
            pool = GKPool(a=a_c.clone(), b=b_c.clone(), err=torch.zeros((L, cap), dtype=REAL, device=dev),
                          l1=torch.zeros((L, cap), dtype=REAL, device=dev), val=val,
                          n=torch.zeros(L, dtype=torch.int64, device=dev),
                          evals=torch.zeros(L, dtype=_count_dtype(), device=dev),
                          atol=atol.contiguous(), rtol=float(rtol),
                          max_evals=_as_eval_budget(maxiters), active=everyone.clone())
        kernels.seed(pool, start, ca, cb, cval.contiguous(), cerr.contiguous(), cl1.contiguous(),
                     count.contiguous(), n0.contiguous(), seeding)
        k += 1
        if stats is not None:
            stats.seed_trip(level)
    return pool


def gk_adaptive_lanes(rule, segs, atol, *, cap, nbisect, rtol=0.0, maxiters=None, presplit=1,
                      sync_every=1, kernels=None, stats=None, level=0, init_pool=None,
                      seed_width=None, seed_coarsen=True, seed_n=None, return_state=False, solve=None):
    """Adaptive GK integration of L independent lanes (the reference's
    ``gk_adaptive`` under ``vmap``).

    ``rule(ca, cb, active, live)`` evaluates the rule on the intervals
    (ca, cb) (L, I) of the lanes that ``active`` (L,) marks, and returns
    (val (L, I, *V), err (L, I), l1 (L, I), count (L,)); ``live`` holds the
    indices of the active lanes when the loop has them at hand (else None).
    ``segs`` (L, S+1) are each lane's breakpoints, ``atol`` (L,) its absolute
    tolerance. ``presplit=P`` starts from P uniform pieces per segment,
    clamped to leave refinement room.

    ``init_pool=(a, b, e, n)`` ((L, cap) each, ``n`` (L,) int64) warm-starts
    every lane from an inherited partition instead (``presplit`` is then
    ignored): coarsened by K6 when ``seed_coarsen``, re-evaluated in chunks of
    ``seed_chunk_width(seed_width, nbisect, cap)`` intervals, each chunk's
    full count added, before the loop runs (the seed phase ignores
    ``maxiters``); ``seed_n``, the most live seed slots of any lane where
    the caller knows it on the host, spares a sync (see :func:`_seeded_pool`).

    The host tests whether any lane is live every ``sync_every`` trips (with
    1, it also hands ``rule`` the live lanes); trips past the last live lane
    change nothing (:func:`refine_lanes`). ``solve(pool, nbisect)``, where
    given, takes the started pool to its end in place of that loop (the
    fused leaf solve of a nested DOS, one launch). Returns (tot_val (L,
    *V), tot_err (L,), evals (L,), converged (L,) bool), and with
    ``return_state`` the final :class:`GKPool` as well."""
    kernels = kernels or pool_kernels()
    L, S1 = segs.shape
    if init_pool is not None:
        pool = _seeded_pool(rule, segs, atol, init_pool, cap=cap, nbisect=nbisect, rtol=rtol,
                            maxiters=maxiters, kernels=kernels, stats=stats, level=level,
                            seed_width=seed_width, seed_coarsen=seed_coarsen, seed_n=seed_n)
    else:
        pool = _cold_pool(rule, segs, atol, cap=cap, nbisect=nbisect, rtol=rtol, maxiters=maxiters,
                          presplit=presplit, kernels=kernels)
    if solve is not None:
        solve(pool, nbisect)
    else:
        refine_lanes(pool, rule, kernels, nbisect, sync_every=sync_every, stats=stats, level=level)
    out = (pool.tot_val, pool.tot_err, pool.evals, pool.tot_err <= pool.tol)
    return out + (pool,) if return_state else out


def refine_lanes(pool, rule, kernels, nbisect, *, sync_every=1, stats=None, level=0, count_trips=False):
    """The refinement loop of :func:`gk_adaptive_lanes` on a started pool:
    each trip selects (``kernels.select``), evaluates the children
    (``rule``) and writes them back (``kernels.update``) until no lane is
    live; the host tests that every ``sync_every`` trips. With
    ``count_trips``, returns each lane's trips (L,) int64."""
    lane_trips = torch.zeros(pool.nlanes, dtype=torch.int64, device=pool.a.device) if count_trips else None
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
        if lane_trips is not None:
            lane_trips += pool.active
        cval, cerr, cl1, count = rule(ca, cb, pool.active, live)
        kernels.update(pool, nbisect, idx, ca, cb, cval.contiguous(), cerr.contiguous(),
                       cl1.contiguous(), count.contiguous())
        trips += 1
        if stats is not None:
            stats.trip(level)
    return lane_trips


def _cold_pool(rule, segs, atol, *, cap, nbisect, rtol, maxiters, presplit, kernels):
    """The cold start: the breakpoints' segments (P-presplit), evaluated in
    one trip."""
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
    return pool


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
    ``segs`` (S+1,): the reference's single-pool ``gk_adaptive`` as one lane
    of :func:`gk_adaptive_lanes`. Returns (val, err, numevals, converged).

    ``init_pool=(a, b, e, n)`` (cap-length arrays, ``n`` live slots)
    warm-starts the pool, coarsened when ``seed_coarsen`` and re-evaluated
    ``seed_width``-wide chunks at a time. ``_return_state`` adds the final
    state ``(a, b, val, err, l1, n, evals)``, indexed as the reference's.
    ``noise_rfloor``/``stall_patience`` belong to the guided tier and raise,
    as does a custom ``norm`` (the pools use the 2-norm)."""
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

    if init_pool is not None:
        a_in, b_in, e_in, n_in = (t if isinstance(t, torch.Tensor) else torch.tensor(np.asarray(t))
                                  for t in init_pool)
        init_pool = tuple(t.to(device=segs.device, dtype=REAL)[None].contiguous()
                          for t in (a_in, b_in, e_in)) + (
            n_in.to(device=segs.device, dtype=torch.int64).reshape(1),)
    out = gk_adaptive_lanes(
        rule, segs[None].contiguous(), torch.full((1,), atol, dtype=REAL, device=segs.device),
        cap=cap, nbisect=nbisect, rtol=rtol, maxiters=maxiters, presplit=presplit,
        init_pool=init_pool, seed_width=seed_width, seed_coarsen=seed_coarsen,
        return_state=_return_state)
    val, err, evals, conv = (o[0] for o in out[:4])
    if _return_state:
        pool = out[4]
        return val, err, evals, conv, (pool.a[0], pool.b[0], pool.val[0], pool.err[0], pool.l1[0],
                                       pool.n[0], pool.evals[0])
    return val, err, evals, conv


def scatter_lanes(L, live, *outs):
    """Full-lane (L, ...) tensors, zero outside the lanes ``live``, from the
    outputs of those lanes."""
    full = []
    for o in outs:
        f = torch.zeros((L,) + tuple(o.shape[1:]), dtype=o.dtype, device=o.device)
        f[live] = o
        full.append(f)
    return full
