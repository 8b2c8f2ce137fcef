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

Kernel K5 (``csrc/gk_pool.cu``) carries the pool, each entry point beside
its plain PyTorch version:

- :func:`gk_pool_start`: a cold pool from the rule's outputs on the
  breakpoints' segments (padded to cap, ``n``, ``evals``), or the pool as it
  stands, then its totals and tolerance and, with ``select``, the first loop
  test and picks;
- :func:`gk_pool_step`, one launch a trip after the rule: the children's
  reduction from their node values (:class:`NodeChildren`; or as the rule
  reduced them, :class:`ReducedChildren`), the two sequential scatters (left
  children over their parents, then right children to ``n..n+nbisect-1``,
  so the right child wins where a dead slot and a fresh slot collide),
  ``n += nbisect``, ``evals += count``, the totals and tolerance, and the
  next trip's loop test and worst ``nbisect`` intervals (ties to the lower
  index, as ``lax.top_k``) bisected into child endpoints;
- :func:`gk_rule_reduce`: the rule's reduction alone (node values and
  per-node counts to ``val``, ``err``, ``l1`` and a count per lane, dead
  intervals exactly 0). No solver here launches it: it serves the public
  :func:`gk_rule_eval` (a rule on one set of intervals, outside a pool)
  and the card tests, which hand the plain pool versions the step's
  reduction bits with it (the step reduces with the same code).

The warm start seeds a pool from an inherited partition instead of the
domain's breakpoints (reference ``gk_adaptive(init_pool=...)``):

- :func:`coarsen_pool` (kernel K6, ``csrc/gk_coarsen.cu``): sort each lane's
  pool by left endpoint, merge dyadic sibling pairs that are stale or that
  cap pressure gives up, and compact the survivors to the front;
- :func:`gk_pool_seed` (K5's seed entry): write one chunk of re-evaluated
  seed intervals to contiguous slots (the first chunk also starts the pool
  from the partition), ``n = n0``, ``evals += count``, the totals and
  tolerance, and with ``select`` the first picks.

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

import ctypes
import math
from dataclasses import dataclass, field
from types import SimpleNamespace
from typing import NamedTuple

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
    solve), with each lane's totals, tolerance and live flag, and once the
    loop has started (a start or seed with ``nbisect``) the next trip's picks
    and children."""

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
    idx: torch.Tensor = None  # (L, nbisect) int64: the next trip's picks
    ca: torch.Tensor = None  # (L, 2 nbisect): their children, left halves first
    cb: torch.Tensor = None
    ptrs: object = field(default=None, repr=False)  # the checked CUDA pool's pointers (K5)
    checked: bool = field(default=False, repr=False)  # its tensors have the kernels' layout

    @property
    def cap(self):
        return self.a.shape[1]

    @property
    def nlanes(self):
        return self.a.shape[0]

    def real_val(self):
        """The value pool as float64 (complex values as (re, im) pairs)."""
        return torch.view_as_real(self.val) if self.val.is_complex() else self.val

    def clone(self):
        """A copy with tensors of its own, in the same layout (its pointers
        taken anew)."""
        return GKPool(**{k: (v.clone() if isinstance(v, torch.Tensor) else v)
                         for k, v in vars(self).items() if k != "ptrs"})


class NodeChildren(NamedTuple):
    """A trip's children as the rule's node values: ``fx`` (La, K, npts, *V)
    float64 or complex128 at the Kronrod nodes of K intervals of each of the
    lanes ``live`` (La,) int64 (ascending), per-node ``counts`` (La, K,
    npts) float64 or None (each node counts 1), ``half`` widths (La, K) and
    the rule's weights ``wk``, ``wg`` (npts,). The pool's entries reduce
    them (:func:`gk_rule_reduce_plain`) on the way in."""

    fx: torch.Tensor
    counts: torch.Tensor | None
    half: torch.Tensor
    live: torch.Tensor
    wk: torch.Tensor
    wg: torch.Tensor


class ReducedChildren(NamedTuple):
    """A trip's children as a rule reduced them: ``val`` (R, K, *V), ``err``,
    ``l1`` (R, K) and ``count`` (R,), for the lanes ``live`` (R,) int64
    (ascending), or with ``live`` None for every lane (R = L; lanes the rule
    did not evaluate hold zeros)."""

    val: torch.Tensor
    err: torch.Tensor
    l1: torch.Tensor
    count: torch.Tensor
    live: torch.Tensor | None = None


def as_children(out):
    """A rule's output as children: :class:`NodeChildren` or
    :class:`ReducedChildren` as they are, a plain (val, err, l1, count)
    tuple as every lane's reduced children."""
    return out if isinstance(out, (NodeChildren, ReducedChildren)) else ReducedChildren(*out)


def reduced_children(ch, L):
    """Plain PyTorch version of what the pool's entries take in: the
    children ``ch`` as every lane's (val, err, l1, count) (L, ...), reduced
    by :func:`gk_rule_reduce_plain` where they are node values, zero on the
    lanes the rule did not evaluate."""
    if isinstance(ch, NodeChildren):
        out, live = gk_rule_reduce_plain(ch.fx, ch.counts, ch.half, ch.wk, ch.wg), ch.live
    else:
        out, live = tuple(ch[:4]), ch.live
    return out if live is None else scatter_lanes(L, live, *out)


def _child_values(ch):
    """(the value shape *V, dtype) of the children ``ch``."""
    v = ch.fx if isinstance(ch, NodeChildren) else ch.val
    return tuple(v.shape[3 if isinstance(ch, NodeChildren) else 2:]), v.dtype


def _flat(t, lead):
    return t.reshape(tuple(t.shape[:lead]) + (-1,))


def gk_pool_totals_plain(pool):
    """Totals over the whole pool and the lanes' tolerances, in place."""
    pool.tot_val = torch.sum(pool.val, dim=1)
    pool.tot_err = torch.sum(pool.err, dim=1)
    norm = torch.sqrt(torch.sum(torch.abs(_flat(pool.tot_val, 1)) ** 2, dim=1))
    pool.tol = torch.maximum(pool.atol, pool.rtol * norm)


def gk_pool_select_plain(pool, nbisect):
    """Plain PyTorch version of K5's select. Updates ``pool.active`` with the
    loop test and returns (idx (L, nbisect) int64, ca, cb (L, 2 nbisect)):
    the worst intervals of each lane, ties to the lower index, and their
    children (left halves first). Lanes that stop get zero picks and
    zero-width children."""
    pool.active = (pool.active & (pool.tot_err > pool.tol) & (pool.n + nbisect <= pool.cap)
                   & (pool.evals < pool.max_evals))
    # a stable descending sort keeps tied errors in index order, as top_k
    idx = torch.sort(pool.err, dim=1, descending=True, stable=True).indices[:, :nbisect].contiguous()
    aa, bb = pool.a.gather(1, idx), pool.b.gather(1, idx)
    mm = (aa + bb) / 2
    ca, cb = torch.cat([aa, mm], dim=1), torch.cat([mm, bb], dim=1)
    live = pool.active[:, None]
    zero = torch.zeros((), dtype=REAL, device=ca.device)
    idx = torch.where(live, idx, torch.zeros((), dtype=idx.dtype, device=idx.device))
    return idx, torch.where(live, ca, zero), torch.where(live, cb, zero)


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


def _select_into(pool, nbisect):
    pool.idx, pool.ca, pool.cb = gk_pool_select_plain(pool, nbisect)


def gk_pool_start_plain(pool, nbisect, a0=None, b0=None, children=None, select=True):
    """Plain PyTorch version of K5's start, in place: with ``children`` (the
    rule's on the intervals (a0, b0) (L, K), every lane in lane order) the
    cold pool, slots 0..K-1 from them and zeros to cap, ``n = K``, ``evals``
    their count, every lane live; without, the pool as it stands. Then the
    totals (:func:`gk_pool_totals_plain`) and, with ``select``, the first
    loop test and picks (:func:`gk_pool_select_plain`) into ``pool.idx``,
    ``pool.ca`` and ``pool.cb``."""
    if children is not None:
        L, K = a0.shape
        val0, err0, l10, count0 = reduced_children(children, L)
        for arr, v in ((pool.a, a0), (pool.b, b0), (pool.err, err0), (pool.l1, l10), (pool.val, val0)):
            arr.zero_()
            arr[:, :K] = v
        pool.n.fill_(K)
        pool.evals.copy_(count0)
        pool.active.fill_(True)
    gk_pool_totals_plain(pool)
    if select:
        _select_into(pool, nbisect)


def gk_pool_step_plain(pool, nbisect, children):
    """Plain PyTorch version of K5's step: the children (their node values
    reduced, :func:`reduced_children`) into the live lanes'
    pools with the pool's picks (:func:`gk_pool_update_plain`), then the next
    trip's loop test and picks (:func:`gk_pool_select_plain`)."""
    val, err, l1, count = reduced_children(children, pool.nlanes)
    gk_pool_update_plain(pool, nbisect, pool.idx, pool.ca, pool.cb, val, err, l1, count)
    _select_into(pool, nbisect)


def gk_pool_start(pool, nbisect, a0=None, b0=None, children=None, select=True):
    """Start a pool's loop (see :func:`gk_pool_start_plain`). CPU pools take
    the plain version; a CUDA pool is checked here, once for its solve, gets
    the buffers of its totals and of its picks and children, and launches
    K5's start."""
    L, cap = pool.a.shape
    form, kid, K, P, cplx = -1, _NO_KIDS, 0, 0, 0
    if children is not None:
        children = as_children(children)
        check_tensor(a0, "a0", device=pool.a.device, dtype=REAL, ndim=2)
        K = a0.shape[1]
        check_tensor(b0, "b0", device=pool.a.device, dtype=REAL, ndim=2, shape=(L, K))
        if a0.shape[0] != L or not 1 <= K <= cap:
            raise ValueError(f"a cold start takes (L, K) = ({L}, 1..{cap}) intervals, got {tuple(a0.shape)}")
        form, kid, P, cplx = _check_children(pool, children, L, K, lane_order=True)
    if pool.a.device.type == "cpu":
        return gk_pool_start_plain(pool, nbisect, a0, b0, children, select)
    _begin(pool, nbisect, picks=select)
    if select:
        pool.idx, pool.ca, pool.cb = pool.ptrs[2]
    if L == 0:
        return None
    rc = load_kernels().gk_pool_start_launch(
        pool.ptrs[0], 0 if a0 is None else a0.data_ptr(), 0 if b0 is None else b0.data_ptr(), form, *kid, L, cap,
        pool.ptrs[1], nbisect, float(pool.rtol), float(pool.max_evals), K, P, cplx, int(select),
        stream_handle(pool.a.device))
    check_launch(rc, "gk_pool_start")
    gk_pool_launches["start"] += 1
    return None


def gk_pool_step(pool, nbisect, children):
    """A trip's pool step after the rule (see :func:`gk_pool_step_plain`),
    in place. CPU pools take the plain version; a CUDA pool, started with
    ``nbisect`` (:func:`gk_pool_start`, or :func:`gk_pool_seed` with it),
    launches K5's step over the children's lanes, which overwrites its picks
    and children with the next trip's. The pool was checked at its start
    (again here where a field was rebound since); the children are checked
    here."""
    children = as_children(children)
    L, cap = pool.a.shape
    form, kid, P, cplx = _check_children(pool, children, L, 2 * nbisect)
    if pool.a.device.type == "cpu":
        return gk_pool_step_plain(pool, nbisect, children)
    if pool.idx is None or pool.idx.shape[1] != nbisect:
        raise ValueError("gk_pool_step needs a pool started with its picks for the same nbisect")
    if pool.ptrs is None or pool.ptrs[2][0] is None or _stale(pool):  # a copy, or a field rebound
        _begin(pool, nbisect)
    live = children.live
    R = L if live is None else live.shape[0]
    if R == 0:
        return None
    rc = load_kernels().gk_pool_step_launch(
        pool.ptrs[0], 0 if live is None else live.data_ptr(), *kid, L, R, cap, pool.ptrs[1], nbisect,
        float(pool.rtol), float(pool.max_evals), P, cplx, form, stream_handle(pool.a.device))
    check_launch(rc, "gk_pool_step")
    gk_pool_launches["step"] += 1
    return None


_NO_KIDS = (0,) * 8


def _fields(pool):
    """The pool's tensors whose pointers K5's entries take, in their order."""
    return (pool.a, pool.b, pool.err, pool.l1, pool.val, pool.n, pool.evals, pool.tot_val, pool.tot_err,
            pool.tol, pool.atol, pool.active)


def _stale(pool):
    """Whether a field of the pool, or a pick buffer it holds, is no longer
    the tensor whose pointer :func:`_begin` took (rebound since)."""
    held, bufs = pool.ptrs[3], pool.ptrs[2]
    return (any(t is not h for t, h in zip(_fields(pool), held))
            or any(t is not None and t is not h for t, h in zip((pool.idx, pool.ca, pool.cb), bufs)))


def _begin(pool, nbisect, picks=True):
    """Check a CUDA pool once for its solve and give it its totals' and
    (with ``picks``) picks' buffers and its pointers for K5 (``pool.ptrs``:
    the ctypes array of its 15 pointers, the doubles a slot's value, and the
    pick buffers, the pool's own where it has picks for this nbisect, which
    become its ``idx``, ``ca``, ``cb`` once an entry has made picks; without
    ``picks`` none, and null pointers the entry does not touch; and the
    fields they were taken from, which :func:`_stale` compares). A pool
    whose fields were rebound since is checked again."""
    if pool.a.device.type != "cuda":
        raise ValueError(f"gk_pool runs on cpu or cuda tensors, got {pool.a.device}")
    L, cap = pool.a.shape
    dev = pool.a.device
    if cap > _POOL_MAX_CAP:
        raise ValueError(f"the CUDA pool takes cap <= {_POOL_MAX_CAP}, got {cap}")
    if not 1 <= nbisect <= POOL_MAX_BISECT:
        raise ValueError(f"the CUDA pool takes nbisect in 1..{POOL_MAX_BISECT}, got {nbisect}")
    if pool.tot_val is None:
        pool.tot_val = torch.empty((L,) + tuple(pool.val.shape[2:]), dtype=pool.val.dtype, device=dev)
        pool.tot_err = torch.empty((L,), dtype=REAL, device=dev)
        pool.tol = torch.empty((L,), dtype=REAL, device=dev)
    if pool.ptrs is not None and _stale(pool):
        pool.checked = False
    bufs = (pool.idx, pool.ca, pool.cb)
    if not picks:
        bufs = (None,) * 3
    elif pool.idx is None or pool.idx.shape != (L, nbisect):
        ca = torch.empty((L, 2 * nbisect), dtype=REAL, device=dev)
        bufs = (torch.empty((L, nbisect), dtype=torch.int64, device=dev), ca, torch.empty_like(ca))
    if not pool.checked:
        _check_pool(pool)
        pool.checked = True
    if picks:
        for name, t in zip(("idx", "ca", "cb"), bufs):
            check_tensor(t, name, device=dev, dtype=torch.int64 if name == "idx" else REAL, ndim=2,
                         shape=(L, nbisect * (1 if name == "idx" else 2)))
    val = pool.real_val()
    tensors = (pool.a, pool.b, pool.err, pool.l1, val, pool.n, pool.evals, _real(pool.tot_val), pool.tot_err,
               pool.tol, pool.atol, pool.active) + bufs
    pool.ptrs = ((ctypes.c_void_p * len(tensors))(*(0 if t is None else t.data_ptr() for t in tensors)),
                 math.prod(val.shape[2:]), bufs, _fields(pool))


def _real(t):
    return torch.view_as_real(t) if t.is_complex() else t


def _check_children(pool, ch, L, K, lane_order=False):
    """Raise unless the children ``ch`` fit the pool (K of them a row; with
    ``lane_order`` every lane's, in lane order); returns (form, the 8
    pointers the kernel takes, npts, complex)."""
    dev, vshape, dtype = pool.a.device, tuple(pool.val.shape[2:]), pool.val.dtype
    if dtype not in (REAL, COMPLEX):
        raise ValueError(f"the pool's values have dtype {dtype}, expected float64 or complex128")
    live = ch.live
    R = L if live is None else live.shape[0]
    if live is not None:
        check_tensor(live, "live", device=dev, dtype=torch.int64, ndim=1)
        if R > L or (lane_order and R != L):
            raise ValueError(f"children of {R} lanes do not fit {L} lanes here")
    if isinstance(ch, NodeChildren):
        P = ch.fx.shape[2] if ch.fx.ndim >= 3 else -1
        check_tensor(ch.fx, "fx", device=dev, dtype=dtype, ndim=3 + len(vshape), shape=(R, K, P) + vshape)
        check_tensor(ch.half, "half", device=dev, dtype=REAL, ndim=2, shape=(R, K))
        for name in ("wk", "wg"):
            check_tensor(getattr(ch, name), name, device=dev, dtype=REAL, ndim=1, shape=(P,))
        if ch.counts is not None:
            check_tensor(ch.counts, "counts", device=dev, dtype=REAL, ndim=3, shape=(R, K, P))
        ptrs = (_real(ch.fx).data_ptr(), 0 if ch.counts is None else ch.counts.data_ptr(), ch.half.data_ptr(),
                ch.wk.data_ptr(), ch.wg.data_ptr(), 0, 0, 0)
        return 1, ptrs, P, int(dtype == COMPLEX)
    check_tensor(ch.val, "val", device=dev, dtype=dtype, ndim=2 + len(vshape), shape=(R, K) + vshape)
    for name in ("err", "l1"):
        check_tensor(getattr(ch, name), name, device=dev, dtype=REAL, ndim=2, shape=(R, K))
    check_tensor(ch.count, "count", device=dev, dtype=REAL, ndim=1, shape=(R,))
    return 0, (_real(ch.val).data_ptr(), 0, 0, 0, 0, ch.err.data_ptr(), ch.l1.data_ptr(), ch.count.data_ptr()), 0, 0


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


_POOL_MAX_CAP = 1 << 16  # the pool kernels keep a lane's picks in shared memory
POOL_MAX_BISECT = 64
# launches of K5 by entry: a solve's start (cold, or the pool as it stands),
# its seed chunks and its trips' steps
gk_pool_launches = {"start": 0, "seed": 0, "step": 0}


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


def gk_pool_seed_plain(pool, start, children, n0, seeding, nbisect, partition=None, select=False):
    """Plain PyTorch version of K5's seed entry, in place: with
    ``partition`` (a, b (L, cap), the first chunk of a solve) every lane
    starts from the partition with zero values, ``n = 0``, ``evals = 0`` and
    live; then for the lanes that ``seeding`` (L,) marks, the chunk's
    children (K a row, :func:`reduced_children`) go to slots
    ``start..start+K-1``, whose intervals the pool holds, ``n = n0`` and
    ``evals += count`` (every slot of the chunk counts, dead or
    re-evaluated); then every lane's totals and tolerance, and with
    ``select`` the first loop test and picks (:func:`gk_pool_select_plain`)
    for the pool's ``nbisect``."""
    L = pool.nlanes
    if partition is not None:
        pool.a.copy_(partition[0])
        pool.b.copy_(partition[1])
        for t in (pool.err, pool.l1, pool.val, pool.n, pool.evals):
            t.zero_()
        pool.active.fill_(True)
    cval, cerr, cl1, count = reduced_children(as_children(children), L)
    live = seeding.nonzero().squeeze(1)
    if live.numel():
        rows = live[:, None]
        slots = start + torch.arange(cval.shape[1], device=live.device)
        for arr, c in ((pool.err, cerr), (pool.l1, cl1), (pool.val, cval)):
            arr[rows, slots] = c[live]
        pool.n[live] = n0[live]
        pool.evals[live] += count[live]
    gk_pool_totals_plain(pool)
    if select:
        _select_into(pool, nbisect)


def gk_pool_seed(pool, start, children, n0, seeding, nbisect, partition=None, select=False):
    """Write one seed chunk into the seeding lanes' pools (see
    :func:`gk_pool_seed_plain`). CPU pools take the plain version; a CUDA
    pool is checked at its first chunk (``partition`` given) and launches
    K5's seed entry, which with ``select`` also makes the first picks."""
    children = as_children(children)
    L, cap = pool.a.shape
    dev = pool.a.device
    check_tensor(n0, "n0", device=dev, dtype=torch.int64, shape=(L,), ndim=1)
    check_tensor(seeding, "seeding", device=dev, dtype=torch.bool, shape=(L,), ndim=1)
    if partition is not None:
        for name, t in zip(("partition a", "partition b"), partition):
            check_tensor(t, name, device=dev, dtype=REAL, shape=(L, cap), ndim=2)
    K = (children.fx if isinstance(children, NodeChildren) else children.val).shape[1]
    if not (0 <= start and start + K <= cap and K > 0):
        raise ValueError(f"seed chunk of {K} slots at {start} does not fit cap {cap}")
    form, kid, P, cplx = _check_children(pool, children, L, K)
    if dev.type == "cpu":
        return gk_pool_seed_plain(pool, start, children, n0, seeding, nbisect, partition, select)
    if (partition is not None or pool.ptrs is None or pool.ptrs[2][0] is None
            or pool.ptrs[2][0].shape[1] != nbisect or _stale(pool)):
        _begin(pool, nbisect)
    if select:
        pool.idx, pool.ca, pool.cb = pool.ptrs[2]
    if L == 0:
        return None
    rows = None
    live = children.live
    if live is not None and live.shape[0] < L:
        rows = torch.full((L,), -1, dtype=torch.int64, device=dev)
        rows[live] = torch.arange(live.shape[0], device=dev)
    pa, pb = (0, 0) if partition is None else (partition[0].data_ptr(), partition[1].data_ptr())
    rc = load_kernels().gk_pool_seed_launch(
        pool.ptrs[0], pa, pb, n0.data_ptr(), seeding.data_ptr(), 0 if rows is None else rows.data_ptr(), form,
        *kid, L, cap, pool.ptrs[1], nbisect, float(pool.rtol), float(pool.max_evals), K, P, cplx,
        int(start), int(select), stream_handle(dev))
    check_launch(rc, "gk_pool_seed")
    gk_pool_launches["seed"] += 1
    return None


def pool_kernels(plain=False):
    """The pool's functions: the wrappers of K5 (``start``, ``seed``,
    ``step``) and K6 (``coarsen``), or with ``plain`` their plain versions,
    which run on any device (to hold a whole solve on the card against the
    kernels)."""
    if plain:
        return SimpleNamespace(start=gk_pool_start_plain, step=gk_pool_step_plain,
                               coarsen=coarsen_pool_plain, seed=gk_pool_seed_plain)
    return SimpleNamespace(start=gk_pool_start, step=gk_pool_step, coarsen=coarsen_pool, seed=gk_pool_seed)


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
                 level, seed_width, seed_coarsen, seed_n, select=True):
    """The warm start (reference ``gk_adaptive`` with ``init_pool``): the
    inherited pools, coarsened when ``seed_coarsen``, re-evaluated in chunks
    of C intervals at ``start = min(k C, cap - C)``, every chunk's count
    added; with ``select`` the last chunk's launch also makes the first
    picks. ``seed_n`` is the host's count of the most live seed slots of any
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
    a_c, b_c, n0 = a_c.contiguous(), b_c.contiguous(), n0.contiguous()
    C = seed_chunk_width(seed_width, nbisect, cap)
    if seed_n is None:
        if stats is not None:
            stats.syncs += 1
        seed_n = int(n0.max())
    if seed_n <= 0:
        raise ValueError("a warm-start pool needs at least one live interval")
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
        kids = as_children(rule(ca, cb, seeding, live))
        first = pool is None
        if first:
            vshape, dtype = _child_values(kids)
            pool = _empty_pool(L, cap, vshape, dtype, dev, atol, rtol, maxiters)
        kernels.seed(pool, start, kids, n0, seeding, nbisect, partition=(a_c, b_c) if first else None,
                     select=select and (k + 1) * C >= seed_n)
        k += 1
        if stats is not None:
            stats.seed_trip(level)
    return pool


def _empty_pool(L, cap, vshape, dtype, dev, atol, rtol, maxiters):
    """An unwritten pool of L lanes in the kernels' layout, for a start or
    seed entry to fill."""
    e = lambda *shape, dt=REAL: torch.empty(shape, dtype=dt, device=dev)  # noqa: E731
    return GKPool(a=e(L, cap), b=e(L, cap), err=e(L, cap), l1=e(L, cap), val=e(L, cap, *vshape, dt=dtype),
                  n=e(L, dt=torch.int64), evals=e(L, dt=_count_dtype()), atol=atol.contiguous(),
                  rtol=float(rtol), max_evals=_as_eval_budget(maxiters), active=e(L, dt=torch.bool),
                  checked=dtype in (REAL, COMPLEX) and atol.dtype == REAL and tuple(atol.shape) == (L,)
                  and atol.device == torch.device(dev))


def gk_adaptive_lanes(rule, segs, atol, *, cap, nbisect, rtol=0.0, maxiters=None, presplit=1,
                      sync_every=1, kernels=None, stats=None, level=0, init_pool=None,
                      seed_width=None, seed_coarsen=True, seed_n=None, return_state=False, solve=None):
    """Adaptive GK integration of L independent lanes (the reference's
    ``gk_adaptive`` under ``vmap``).

    ``rule(ca, cb, active, live)`` evaluates the rule on the intervals
    (ca, cb) (L, I) of the lanes that ``active`` (L,) marks, and returns
    their children: :class:`NodeChildren` (the node values of the lanes
    ``live``, which the pool reduces), or :class:`ReducedChildren` or a
    (val (L, I, *V), err (L, I), l1 (L, I), count (L,)) tuple; ``live``
    holds the indices of the active lanes when the loop has them at hand
    (else None). ``segs`` (L, S+1) are each lane's breakpoints, ``atol``
    (L,) its absolute tolerance. ``presplit=P`` starts from P uniform pieces
    per segment, clamped to leave refinement room.

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
    given, takes the started pool (its totals, no picks) to its end in place
    of that loop (the fused leaf solve of a nested DOS, one launch). Returns
    (tot_val (L, *V), tot_err (L,), evals (L,), converged (L,) bool), and
    with ``return_state`` the final :class:`GKPool` as well."""
    kernels = kernels or pool_kernels()
    L, S1 = segs.shape
    if init_pool is not None:
        pool = _seeded_pool(rule, segs, atol, init_pool, cap=cap, nbisect=nbisect, rtol=rtol,
                            maxiters=maxiters, kernels=kernels, stats=stats, level=level,
                            seed_width=seed_width, seed_coarsen=seed_coarsen, seed_n=seed_n,
                            select=solve is None)
    else:
        pool = _cold_pool(rule, segs, atol, cap=cap, nbisect=nbisect, rtol=rtol, maxiters=maxiters,
                          presplit=presplit, kernels=kernels, select=solve is None)
    if solve is not None:
        solve(pool, nbisect)
    else:
        refine_lanes(pool, rule, kernels, nbisect, sync_every=sync_every, stats=stats, level=level)
    out = (pool.tot_val, pool.tot_err, pool.evals, pool.tot_err <= pool.tol)
    return out + (pool,) if return_state else out


def refine_lanes(pool, rule, kernels, nbisect, *, sync_every=1, stats=None, level=0, count_trips=False):
    """The refinement loop of :func:`gk_adaptive_lanes` on a started pool:
    each trip evaluates the pool's children (``rule``) and steps
    (``kernels.step``: the update, the totals and the next picks) until no
    lane is live; the host tests that every ``sync_every`` trips. A pool
    started without its picks (the fused solve's form) gets them first
    (``kernels.start`` on the pool as it stands). With ``count_trips``,
    returns each lane's trips (L,) int64."""
    if pool.idx is None:
        kernels.start(pool, nbisect)
    lane_trips = torch.zeros(pool.nlanes, dtype=torch.int64, device=pool.a.device) if count_trips else None
    trips = 0
    while True:
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
        kernels.step(pool, nbisect, as_children(rule(pool.ca, pool.cb, pool.active, live)))
        trips += 1
        if stats is not None:
            stats.trip(level)
    return lane_trips


def _cold_pool(rule, segs, atol, *, cap, nbisect, rtol, maxiters, presplit, kernels, select=True):
    """The cold start: the breakpoints' segments (P-presplit), evaluated in
    one trip and written to a new pool by ``kernels.start`` (with
    ``select``, with the first picks)."""
    L, S1 = segs.shape
    nseg = S1 - 1
    P = max(1, min(int(presplit), (cap - 2 * nbisect) // max(nseg, 1)))
    a0, b0 = segs[:, :-1], segs[:, 1:]
    if P > 1:
        t = torch.arange(P + 1, dtype=REAL, device=segs.device) / P
        allpts = a0[..., None] + (b0 - a0)[..., None] * t
        a0 = allpts[..., :-1].reshape(L, -1)
        b0 = allpts[..., 1:].reshape(L, -1)
    a0, b0 = a0.contiguous(), b0.contiguous()
    everyone = torch.ones(L, dtype=torch.bool, device=segs.device)
    kids = as_children(rule(a0, b0, everyone, torch.arange(L, device=segs.device)))
    vshape, dtype = _child_values(kids)
    pool = _empty_pool(L, cap, vshape, dtype, segs.device, atol, rtol, maxiters)
    kernels.start(pool, nbisect, a0, b0, kids, select=select)
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

    lane0 = torch.zeros(1, dtype=torch.int64, device=segs.device)

    def rule(ca, cb, active, live):
        nodes, half = gk_nodes(ca[:1], cb[:1], xk)
        K, P = ca.shape[1], xk.shape[0]
        out = batch_f(node_builder(nodes.reshape(-1)), p)
        fx, per_node = out if stats else (out, None)
        counts = None if per_node is None else per_node.to(REAL).reshape(1, K, P).contiguous()
        return NodeChildren(fx.reshape((1, K, P) + tuple(fx.shape[1:])).contiguous(), counts,
                            half.contiguous(), lane0, wk, wg)

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
