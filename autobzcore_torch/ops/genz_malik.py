"""Lane-batched Genz-Malik box pools (reference
``autobzcore_tpu/ops/genz_malik.py``, kernel family B7).

The degree-7 Genz-Malik rule with its embedded degree-5 error estimate
(:func:`gm_rule`, host numpy, copied from the reference) runs on boxes; the
adaptive refinement keeps one fixed-capacity box pool per solve and bisects
the worst ``nbisect`` boxes a trip, each along the axis its rule's fourth
differences pick. As for the interval pools of :mod:`.adaptive`, the pools
of L independent solves are explicit tensors with one row per lane: centres
and halves ``c``, ``h`` (L, cap, d), ``err`` (L, cap), ``sd`` (L, cap) int32,
values ``val`` (L, cap, *V), and per lane ``n``, ``evals``, the totals, the
tolerance and ``active``. A host loop steps the live lanes; a finished lane
changes nothing and counts nothing, and is not evaluated.

Kernels, each beside its plain PyTorch version:

- :func:`gm_rule_reduce` (K14, ``csrc/gm_rule.cu``): the rule on boxes from
  their node values: ``val7``, ``err`` and ``splitdim``, dead (zero-volume)
  boxes masked to exactly 0. K15, the same rule fused with the DOS trace,
  is ``models.observables.gm_leaf_dos``;
- :func:`gm_pool_step` (K16, ``csrc/gm_pool.cu``), one launch a trip after
  the rule: the two sequential scatters, ``n += nbisect``, ``evals += 2
  nbisect P``, the totals and the loop test of the next trip into
  ``active``, then each live lane's worst ``nbisect`` boxes (ties to the
  lower slot, as ``lax.top_k``) split along their ``splitdim``: the next
  trip's children. :func:`gm_pool_begin` starts the loop (the totals, the
  test and the first children). Their plain route is
  :func:`gm_pool_totals_plain`, :func:`gm_pool_select_plain` and
  :func:`gm_pool_update_plain`.

The reference's loop facts hold trip for trip: the test ``tot_err >
max(atol, rtol |tot_val|)``, ``n + nbisect <= cap`` and ``evals <
max_evals`` comes before every trip; while fewer than ``nbisect`` boxes are
live, the picks include dead slots (centre 0, half 0), which are evaluated
at the origin, masked, and counted; left children go over their parents and
then right children to ``n..n+nbisect-1``, so the fresh slots win.
"""
from __future__ import annotations

import math
from dataclasses import dataclass
from functools import lru_cache
from itertools import product
from types import SimpleNamespace

import numpy as np
import torch

from .._device import COMPLEX, REAL, check_tensor
from .adaptive import _as_eval_budget, _count_dtype, _err_norm
from .cuda_lib import check_launch, load_kernels, stream_handle

# the fourth difference's weight (l2 / l3)^2, as the reference forms it
RATIO = float((np.sqrt(9.0 / 70.0) / np.sqrt(9.0 / 10.0)) ** 2)


@lru_cache(maxsize=None)
def gm_rule(d: int):
    """Points and weights of the degree-7(5) Genz-Malik rule on [-1,1]^d.

    Returns (pts (P,d), w7 (P,), w5 (P,), diff_idx) where diff_idx gives, for
    each dimension i, the indices of (center, +l2 e_i, -l2 e_i, +l3 e_i,
    -l3 e_i) used for the fourth-difference split heuristic.
    """
    if d < 2:
        raise ValueError("Genz-Malik requires d >= 2")
    l2 = np.sqrt(9.0 / 70.0)
    l3 = np.sqrt(9.0 / 10.0)
    l4 = l3
    l5 = np.sqrt(9.0 / 19.0)
    two_d = 2.0**d
    w1 = two_d * (12824.0 - 9120.0 * d + 400.0 * d * d) / 19683.0
    w2 = two_d * 980.0 / 6561.0
    w3 = two_d * (1820.0 - 400.0 * d) / 19683.0
    w4 = two_d * 200.0 / 19683.0
    w5 = 6859.0 / 19683.0
    w1e = two_d * (729.0 - 950.0 * d + 50.0 * d * d) / 729.0
    w2e = two_d * 245.0 / 486.0
    w3e = two_d * (265.0 - 100.0 * d) / 1458.0
    w4e = two_d * 25.0 / 729.0

    pts = [np.zeros(d)]
    wk = [w1]
    we = [w1e]
    idx2 = {}
    idx3 = {}
    for i in range(d):
        for s, lam, store in ((+1, l2, idx2), (-1, l2, idx2), (+1, l3, idx3), (-1, l3, idx3)):
            x = np.zeros(d)
            x[i] = s * lam
            store[(i, s)] = len(pts)
            pts.append(x)
            wk.append(w2 if lam == l2 else w3)
            we.append(w2e if lam == l2 else w3e)
    for i in range(d):
        for j in range(i + 1, d):
            for si, sj in product((+1, -1), repeat=2):
                x = np.zeros(d)
                x[i] = si * l4
                x[j] = sj * l4
                pts.append(x)
                wk.append(w4)
                we.append(w4e)
    for signs in product((+1, -1), repeat=d):
        pts.append(l5 * np.array(signs, dtype=np.float64))
        wk.append(w5)
        we.append(0.0)

    pts = np.array(pts)
    wk = np.array(wk) / 2.0**d  # normalize so rule ~ mean * volume later
    we = np.array(we) / 2.0**d
    diff_idx = np.array(
        [[0, idx2[(i, +1)], idx2[(i, -1)], idx3[(i, +1)], idx3[(i, -1)]] for i in range(d)],
        dtype=np.int32,
    )
    return pts, wk, we, diff_idx


def gm_rule_tensors(d, device):
    """:func:`gm_rule` as tensors on ``device``: pts (P, d), wk, we (P,)
    float64 and diff_idx (d, 5) int32."""
    pts, wk, we, diff_idx = gm_rule(d)
    put = lambda a: torch.as_tensor(a, dtype=REAL, device=device)  # noqa: E731
    return put(pts), put(wk), put(we), torch.as_tensor(diff_idx, device=device)


def gm_box_nodes(centers, halves, pts):
    """The rule's nodes of boxes (..., K, d): (..., K, P, d), and the boxes'
    volumes prod(2 h) (..., K)."""
    nodes = centers[..., None, :] + halves[..., None, :] * pts
    return nodes, torch.prod(2.0 * halves, dim=-1)


# --- K14: the rule on boxes ------------------------------------------------------------
def _sum_channels(t, B):
    """Sum over the trailing value axes of t (B, ...) in channel order."""
    t = t.reshape(B, -1) if t.ndim > 1 else t[:, None]
    acc = t[:, 0]
    for c in range(1, t.shape[1]):
        acc = acc + t[:, c]
    return acc


def gm_rule_reduce_plain(fx, vol, wk, we, diff_idx):
    """Plain PyTorch version of K14, the reduction of the reference's
    ``gm_box_eval`` with its operations: node values fx (B, P, *V), volumes
    (B,), the rule's weights and fourth-difference indices. Returns val7 (B,
    *V), err (B,) and splitdim (B,) int32; dead (zero-volume) boxes get val7
    and err exactly 0. The node sums run in node order and the channel sums
    in channel order, one rounded operation at a time, which K14 repeats bit
    for bit."""
    B, P = fx.shape[:2]
    vd = fx.ndim - 2
    vshape = (B,) + (1,) * vd
    s7 = torch.zeros((B,) + tuple(fx.shape[2:]), dtype=fx.dtype, device=fx.device)
    s5 = torch.zeros_like(s7)
    for p in range(P):
        s7 = s7 + wk[p] * fx[:, p]
        s5 = s5 + we[p] * fx[:, p]
    val7 = s7 * vol.reshape(vshape)
    err = torch.sqrt(_sum_channels(torch.abs(val7 - s5 * vol.reshape(vshape)) ** 2, B))
    # zero-volume boxes are dead pool slots whose nodes all sit at the
    # origin, where the integrand may be NaN: NaN * 0 is NaN, so select
    dead = vol == 0
    val7 = torch.where(dead.reshape(vshape), torch.zeros((), dtype=val7.dtype, device=fx.device), val7)
    err = torch.where(dead, torch.zeros((), dtype=REAL, device=fx.device), err)
    di = diff_idx.long()
    vc, vp2, vm2, vp3, vm3 = (fx[:, di[:, k]] for k in range(5))  # (B, d, *V)
    dd = (vp2 + vm2 - 2 * vc) - RATIO * (vp3 + vm3 - 2 * vc)
    d = di.shape[0]
    t = torch.abs(dd) ** 2
    t = torch.stack([_sum_channels(t[:, i], B) for i in range(d)], dim=1)
    # argmax: the first index on a tie, the first NaN where there is one
    return val7, err, torch.argmax(t, dim=1).to(torch.int32)


def gm_rule_reduce(fx, vol, wk, we, diff_idx):
    """The Genz-Malik rule on B boxes from their node values (see
    :func:`gm_rule_reduce_plain`): fx (B, P, *V) float64 or complex128.

    CPU tensors take the plain version; CUDA tensors launch K14, and anything
    the kernel does not take raises."""
    if fx.ndim < 2:
        raise ValueError(f"fx must be (B, P, *V), got {tuple(fx.shape)}")
    if fx.dtype not in (REAL, COMPLEX):
        raise ValueError(f"fx has dtype {fx.dtype}, expected float64 or complex128")
    B, P = fx.shape[:2]
    dev = fx.device
    check_tensor(fx, "fx")
    _check_rule(B, P, vol, wk, we, diff_idx, dev)
    if dev.type == "cpu":
        return gm_rule_reduce_plain(fx, vol, wk, we, diff_idx)
    if dev.type != "cuda":
        raise ValueError(f"gm_rule_reduce runs on cpu or cuda tensors, got {dev}")
    vshape = tuple(fx.shape[2:])
    V = math.prod(vshape)
    # sizes as ints, not tuples: torch.empty parses them faster
    val = torch.empty(B, *vshape, dtype=fx.dtype, device=dev)
    err = torch.empty(B, dtype=REAL, device=dev)
    sd = torch.empty(B, dtype=torch.int32, device=dev)
    if B == 0:
        return val, err, sd
    if V == 0:
        raise ValueError("gm_rule_reduce needs at least one value per node")
    lib = load_kernels()
    stream = stream_handle(dev)
    rc = lib.gm_rule_reduce_launch(
        fx.data_ptr(), vol.data_ptr(), wk.data_ptr(), we.data_ptr(), diff_idx.data_ptr(),
        val.data_ptr(), err.data_ptr(), sd.data_ptr(), B, P, V, int(fx.is_complex()),
        diff_idx.shape[0], RATIO, stream)
    check_launch(rc, "gm_rule_reduce")
    gm_rule_reduce.launches += 1
    return val, err, sd


gm_rule_reduce.launches = 0


def _check_rule(B, P, vol, wk, we, diff_idx, dev):
    check_tensor(vol, "vol", device=dev, dtype=REAL, ndim=1, shape=(B,))
    check_tensor(wk, "wk", device=dev, dtype=REAL, ndim=1, shape=(P,))
    check_tensor(we, "we", device=dev, dtype=REAL, ndim=1, shape=(P,))
    check_tensor(diff_idx, "diff_idx", device=dev, dtype=torch.int32, ndim=2, shape=(None, 5))


def gm_box_eval(batch_f, p, centers, halves, pts, wk, we, diff_idx, reduce=gm_rule_reduce):
    """The reference's ``gm_box_eval``: the rule on the boxes (centers,
    halves) (K, d) with one batched integrand call over their nodes.
    Returns (val7 (K, *V), err (K,), splitdim (K,) int32)."""
    K, d = centers.shape
    P = pts.shape[0]
    nodes, vol = gm_box_nodes(centers, halves, pts)
    fx = batch_f(nodes.reshape(K * P, d), p)
    if not fx.is_complex():
        fx = fx.to(REAL)
    fx = fx.reshape((K, P) + tuple(fx.shape[1:])).contiguous()
    return reduce(fx, vol.contiguous(), wk, we, diff_idx)


def gm_box_eval_plain(batch_f, p, centers, halves, pts, wk, we, diff_idx):
    """:func:`gm_box_eval` through the plain version of K14."""
    return gm_box_eval(batch_f, p, centers, halves, pts, wk, we, diff_idx, gm_rule_reduce_plain)


# --- the pool ----------------------------------------------------------------------------
@dataclass
class GMPool:
    """Box pools of L lanes, one row per lane (the reference's ``(pool_c,
    pool_h, pool_val, pool_err, n, pool_sd, evals)`` state of one solve),
    with each lane's totals, tolerance and live flag, and once the loop has
    started (:func:`gm_pool_begin`) the next trip's picks and children."""

    c: torch.Tensor  # (L, cap, d) float64
    h: torch.Tensor
    err: torch.Tensor  # (L, cap) float64
    sd: torch.Tensor  # (L, cap) int32
    val: torch.Tensor  # (L, cap, *V) float64 or complex128
    n: torch.Tensor  # (L,) int64 live slots
    evals: torch.Tensor  # (L,) float64
    atol: torch.Tensor  # (L,) float64
    rtol: float
    max_evals: float
    npts: int  # the rule's nodes per box
    active: torch.Tensor  # (L,) bool
    tot_val: torch.Tensor = None  # (L, *V)
    tot_err: torch.Tensor = None  # (L,)
    tol: torch.Tensor = None  # (L,)
    idx: torch.Tensor = None  # (L, nbisect) int64: the next trip's picks
    cc: torch.Tensor = None  # (L, 2 nbisect, d): their children, left ones first
    hh: torch.Tensor = None

    @property
    def cap(self):
        return self.c.shape[1]

    @property
    def ndim(self):
        return self.c.shape[2]

    def clone(self):
        return GMPool(**{k: (v.clone() if isinstance(v, torch.Tensor) else v)
                         for k, v in self.__dict__.items()})


def _real(t):
    return torch.view_as_real(t) if t.is_complex() else t


def gm_pool_totals_plain(pool, nbisect):
    """Every lane's totals over its whole pool, its tolerance ``max(atol,
    rtol |tot_val|)``, and the loop test narrowing ``active``, in place."""
    pool.tot_val = torch.sum(pool.val, dim=1)
    pool.tot_err = torch.sum(pool.err, dim=1)
    norm = _err_norm(pool.tot_val, 1)
    pool.tol = torch.maximum(pool.atol, pool.rtol * norm)
    pool.active = (pool.active & (pool.tot_err > pool.tol) & (pool.n + nbisect <= pool.cap)
                   & (pool.evals < pool.max_evals))


def gm_pool_select_plain(pool, nbisect):
    """Plain PyTorch version of K16's select: for every active lane, its
    worst ``nbisect`` boxes (a stable descending sort keeps tied errors in
    slot order, as ``lax.top_k``) and their children, each box halved along
    its splitdim with the reference's one-hot arithmetic, left children
    first. Returns (idx (L, nbisect) int64, cc, hh (L, 2 nbisect, d));
    inactive lanes get zeros."""
    d = pool.ndim
    idx = torch.sort(pool.err, dim=1, descending=True, stable=True).indices[:, :nbisect].contiguous()
    gi = idx[..., None].expand(-1, -1, d)
    cc, hh = pool.c.gather(1, gi), pool.h.gather(1, gi)
    sd = pool.sd.gather(1, idx).long()
    onehot = torch.nn.functional.one_hot(sd, d).to(REAL)
    new_h = hh * (1 - onehot / 2)
    off = hh * onehot / 2
    ca = torch.cat([cc - off, cc + off], dim=1)
    ha = torch.cat([new_h, new_h], dim=1)
    live = pool.active[:, None, None]
    zero = torch.zeros((), dtype=REAL, device=ca.device)
    idx = torch.where(pool.active[:, None], idx, torch.zeros((), dtype=idx.dtype, device=idx.device))
    return idx, torch.where(live, ca, zero), torch.where(live, ha, zero)


def gm_pool_update_plain(pool, nbisect, idx, cc, hh, cval, cerr, csd):
    """Plain PyTorch version of K16's update, in place on the active lanes:
    left children over their parents, then right children to the fresh
    slots ``n..n+nbisect-1`` (the fresh slots win where a picked dead slot
    collides with one), ``n += nbisect``, ``evals += 2 nbisect P``; then the
    totals and the loop test (:func:`gm_pool_totals_plain`)."""
    live = pool.active.nonzero().squeeze(1)
    if live.numel():
        rows = live[:, None]
        left = idx[live]
        fresh = pool.n[live, None] + torch.arange(nbisect, device=live.device)
        for arr, ch in ((pool.c, cc), (pool.h, hh), (pool.err, cerr), (pool.sd, csd),
                        (pool.val, cval)):
            ch = ch[live]
            arr[rows, left] = ch[:, :nbisect]
            arr[rows, fresh] = ch[:, nbisect:]
        pool.n[live] += nbisect
        pool.evals[live] += float(2 * nbisect * pool.npts)
    gm_pool_totals_plain(pool, nbisect)


def gm_pool_begin_plain(pool, nbisect):
    """Plain PyTorch version of K16's start of the loop: the totals and the
    loop test (:func:`gm_pool_totals_plain`), then the first trip's picks
    and children (:func:`gm_pool_select_plain`) into ``pool.idx``,
    ``pool.cc`` and ``pool.hh``."""
    gm_pool_totals_plain(pool, nbisect)
    pool.idx, pool.cc, pool.hh = gm_pool_select_plain(pool, nbisect)


def gm_pool_begin(pool, nbisect):
    """Start the loop (see :func:`gm_pool_begin_plain`). CPU pools take the
    plain version; a CUDA pool is checked here, once for its solve, gets
    the buffers of its totals and of its picks and children, and launches
    K16 as the start (totals and select)."""
    if pool.c.device.type == "cpu":
        return gm_pool_begin_plain(pool, nbisect)
    _check_pool(pool)
    pool.idx, pool.cc, pool.hh = _pick_buffers(pool, nbisect)
    _pool_launch(pool, "begin", nbisect, pool.idx, pool.cc, pool.hh)
    return None


def gm_pool_step_plain(pool, nbisect, cval, cerr, csd):
    """Plain PyTorch version of K16's step: :func:`gm_pool_update_plain`
    with the pool's picks and children and the rule's values, errors and
    splitdims of the children (cval (L, 2 nbisect, *V), cerr, csd (L, 2
    nbisect)), then :func:`gm_pool_select_plain` for the next trip's."""
    gm_pool_update_plain(pool, nbisect, pool.idx, pool.cc, pool.hh, cval, cerr, csd)
    pool.idx, pool.cc, pool.hh = gm_pool_select_plain(pool, nbisect)


def gm_pool_step(pool, nbisect, cval, cerr, csd):
    """A trip's pool step after the rule (see :func:`gm_pool_step_plain`),
    in place. CPU pools take the plain version; a CUDA pool, started by
    :func:`gm_pool_begin`, launches K16 as a step, which overwrites its
    picks and children with the next trip's."""
    if pool.c.device.type == "cpu":
        return gm_pool_step_plain(pool, nbisect, cval, cerr, csd)
    # the pool and its buffers were checked at gm_pool_begin; what changes
    # every trip is checked here: the rule's children, and that the buffers
    # are the begun ones for this nbisect
    if pool.idx is None or pool.idx.shape[1] != nbisect:
        raise ValueError("gm_pool_step needs a pool started by gm_pool_begin with the same nbisect")
    _check_children(pool, nbisect, cval, cerr, csd)
    _pool_launch(pool, "step", nbisect, pool.idx, pool.cc, pool.hh, cval, cerr, csd)
    return None


def _check_children(pool, nbisect, cval, cerr, csd):
    L, dev = pool.c.shape[0], pool.c.device
    check_tensor(cerr, "cerr", device=dev, dtype=REAL, ndim=2, shape=(L, 2 * nbisect))
    check_tensor(csd, "csd", device=dev, dtype=torch.int32, ndim=2, shape=(L, 2 * nbisect))
    check_tensor(cval, "cval", device=dev, dtype=pool.val.dtype,
                 shape=(L, 2 * nbisect) + tuple(pool.val.shape[2:]), ndim=pool.val.ndim)


def _check_pool(pool):
    """Raise unless the pool's tensors have the shapes, dtypes and layout the
    pool kernel reads and writes through raw pointers, and give it its
    totals' buffers where it has none."""
    L, cap, d = pool.c.shape
    dev = pool.c.device
    if dev.type != "cuda":
        raise ValueError(f"gm_pool runs on cpu or cuda tensors, got {dev}")
    for name in ("c", "h"):
        check_tensor(getattr(pool, name), name, device=dev, dtype=REAL, ndim=3, shape=(L, cap, d))
    check_tensor(pool.err, "err", device=dev, dtype=REAL, ndim=2, shape=(L, cap))
    check_tensor(pool.sd, "sd", device=dev, dtype=torch.int32, ndim=2, shape=(L, cap))
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
    else:
        pool.tot_val = torch.empty((L,) + tuple(pool.val.shape[2:]), dtype=pool.val.dtype, device=dev)
        pool.tot_err = torch.empty((L,), dtype=REAL, device=dev)
        pool.tol = torch.empty((L,), dtype=REAL, device=dev)


def _pick_buffers(pool, nbisect):
    L, d = pool.c.shape[0], pool.ndim
    dev = pool.c.device
    cc = torch.empty((L, 2 * nbisect, d), dtype=REAL, device=dev)
    return torch.empty((L, nbisect), dtype=torch.int64, device=dev), cc, torch.empty_like(cc)


def _pool_launch(pool, entry, nbisect, idx, cc, hh, cval=None, cerr=None, csd=None):
    """One launch of K16 on a checked CUDA pool: the start (``entry``
    "begin") or a trip's step ("step")."""
    L, cap, d = pool.c.shape
    if L == 0:
        return
    val = _real(pool.val)
    V = math.prod(val.shape[2:])
    ptr = lambda t: 0 if t is None else t.data_ptr()  # noqa: E731
    rc = load_kernels().gm_pool_launch(
        int(entry == "step"), pool.c.data_ptr(), pool.h.data_ptr(), pool.err.data_ptr(), pool.sd.data_ptr(),
        val.data_ptr(), pool.n.data_ptr(), pool.evals.data_ptr(), _real(pool.tot_val).data_ptr(),
        pool.tot_err.data_ptr(), pool.tol.data_ptr(), pool.atol.data_ptr(), pool.active.data_ptr(),
        idx.data_ptr(), cc.data_ptr(), hh.data_ptr(), ptr(None if cval is None else _real(cval)), ptr(cerr), ptr(csd),
        L, cap, d, V, nbisect, float(2 * nbisect * pool.npts), float(pool.rtol), float(pool.max_evals),
        stream_handle(pool.c.device))
    check_launch(rc, f"gm_pool_{entry}")
    gm_pool_launches[entry] += 1


# launches of K16 by entry: a solve's start ("begin") and its trips ("step")
gm_pool_launches = {"begin": 0, "step": 0}


def box_kernels(plain=False):
    """The box pool's functions: the wrappers of K14 and K16, or with
    ``plain`` their plain versions, which run on any device (to hold a whole
    solve on the card against the kernels)."""
    if plain:
        return SimpleNamespace(begin=gm_pool_begin_plain, step=gm_pool_step_plain,
                               rule_reduce=gm_rule_reduce_plain)
    return SimpleNamespace(begin=gm_pool_begin, step=gm_pool_step, rule_reduce=gm_rule_reduce)


# --- the loop ----------------------------------------------------------------------------
def gm_trip(pool, rule, nbisect, kernels, live=None):
    """One refinement trip of every active lane of a started pool (see
    :func:`gm_pool_begin`): the rule on the children (``rule(cc, hh, active,
    live)``, see :func:`gm_adaptive_lanes`), then the step, which also
    picks the next trip's children."""
    cval, cerr, csd = rule(pool.cc, pool.hh, pool.active, live)
    kernels.step(pool, nbisect, cval.contiguous(), cerr.contiguous(), csd.contiguous())


def gm_pool_start(rule, a, b, atol, *, cap, nbisect, npts, rtol=0.0, maxiters=None,
                  kernels=None):
    """The cold pools: each lane's box [a, b] (L, d) evaluated in slot 0
    (centre (a + b) / 2, half (b - a) / 2), ``evals = P``, then the totals,
    the first loop test and the first trip's children (``kernels.begin``)."""
    kernels = kernels or box_kernels()
    L, d = a.shape
    dev = a.device
    c0, h0 = (a + b) / 2, (b - a) / 2
    everyone = torch.ones(L, dtype=torch.bool, device=dev)
    val0, err0, sd0 = rule(c0[:, None].contiguous(), h0[:, None].contiguous(), everyone,
                           torch.arange(L, device=dev))

    def pad(v, dtype=None):
        out = torch.zeros((L, cap) + tuple(v.shape[2:]), dtype=dtype or v.dtype, device=dev)
        out[:, :1] = v
        return out

    pool = GMPool(c=pad(c0[:, None]), h=pad(h0[:, None]), err=pad(err0), sd=pad(sd0),
                  val=pad(val0), n=torch.ones(L, dtype=torch.int64, device=dev),
                  evals=torch.full((L,), float(npts), dtype=_count_dtype(), device=dev),
                  atol=torch.as_tensor(atol, dtype=REAL, device=dev).expand(L).contiguous(),
                  rtol=float(rtol), max_evals=_as_eval_budget(maxiters), npts=int(npts),
                  active=everyone)
    kernels.begin(pool, nbisect)
    return pool


def gm_adaptive_lanes(rule, a, b, atol, *, cap, nbisect, npts, rtol=0.0, maxiters=None,
                      kernels=None, stats=None, level=1, return_state=False):
    """Adaptive Genz-Malik cubature of L independent lanes (the reference's
    ``gm_adaptive`` once per lane).

    ``rule(cc, hh, active, live)`` evaluates the rule on the boxes (cc, hh)
    (L, K, d) of the lanes that ``active`` (L,) marks and returns (val (L, K,
    *V), err (L, K), splitdim (L, K) int32), zeros elsewhere; ``live`` holds
    the active lanes' indices. ``a``, ``b`` (L, d) are each lane's box,
    ``atol`` a number or (L,) tensor, ``npts`` the rule's nodes per box. A
    trip is the rule and one pool step; the host reads the live lanes once
    a trip (one sync, counted in ``stats``).
    Returns (tot_val (L, *V), tot_err (L,), evals (L,), converged (L,) bool),
    and with ``return_state`` the final :class:`GMPool` as well."""
    kernels = kernels or box_kernels()
    pool = gm_pool_start(rule, a, b, atol, cap=cap, nbisect=nbisect, npts=npts, rtol=rtol,
                         maxiters=maxiters, kernels=kernels)
    while True:
        if stats is not None:
            stats.syncs += 1
        live = pool.active.nonzero().squeeze(1)
        if live.numel() == 0:
            break
        gm_trip(pool, rule, nbisect, kernels, live)
        if stats is not None:
            stats.trip(level)
    out = (pool.tot_val, pool.tot_err, pool.evals, pool.tot_err <= pool.tol)
    return out + (pool,) if return_state else out
