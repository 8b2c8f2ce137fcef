"""K5's start, seed and step entries (``ops/adaptive.py``) on the CPU: their
plain versions against the route they replace (a select, the rule's
reduction and a scatter to every lane, an update, a padded cold pool and its
totals, a seed chunk and its totals), bit for bit, and a 3-D nest at the
main path's knobs against the JAX package."""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import autobzcore_torch as T
import autobzcore_tpu as J
from autobzcore_torch.models import observables as tobs
from autobzcore_torch.models import tight_binding as ttb
from autobzcore_torch.ops import adaptive as tad
from autobzcore_tpu.models import tight_binding as jtb
from autobzcore_tpu.models.observables import dos_trace as jdos
from torch_parity import dyadic_pools

torch.set_num_threads(2)

F64, C128 = torch.float64, torch.complex128
VALUES = {"V1": ((), F64), "W2": ((2,), F64), "complex": ((), C128), "complex2": ((2,), C128)}
L, CAP, P = 24, 40, 15


def _values(rng, shape, dtype):
    v = torch.as_tensor(rng.normal(size=shape))
    return v if dtype == F64 else torch.complex(v, torch.as_tensor(rng.normal(size=shape)))


def _pool(rng, nb, V, dtype):
    """Pools from dyadic partitions with random values: lanes 0-2 with
    n < nbisect (their picks run into dead slots), lanes 3-5 stopped, lanes
    6-7 converged (atol far above their errors)."""
    a, b, e, n = dyadic_pools(rng, L, CAP, np.array([0.0, 0.5, 1.0]), "cpu")
    n[:3] = torch.as_tensor([1, 2, 3]).clamp(max=max(nb - 1, 1))
    live = torch.arange(CAP)[None, :] < n[:, None]
    zero = torch.zeros((), dtype=F64)
    e[:3], e[6:8] = 0.5, 1e-3  # the collision lanes stay live, lanes 6-7 converge
    a, b, e = (torch.where(live, t, zero) for t in (a, b, e))
    val = _values(rng, (L, CAP) + V, dtype) * live.reshape((L, CAP) + (1,) * len(V))
    atol = torch.as_tensor(rng.random(L) * 1e-9)
    atol[6:8] = 1e3
    active = torch.ones(L, dtype=torch.bool)
    active[3:6] = False
    return tad.GKPool(a=a.contiguous(), b=b.contiguous(), err=e.contiguous(), l1=(2 * e).contiguous(),
                      val=val.contiguous(), n=n.contiguous(),
                      evals=torch.as_tensor(rng.integers(0, 1000, L).astype(np.float64)), atol=atol, rtol=1e-6,
                      max_evals=5e5, active=active)


def _node_children(rng, ca, cb, live, V, dtype):
    """Random node values and per-node counts at the Kronrod nodes of the
    lanes ``live``'s children (ca, cb) (L, K)."""
    xk, wk, wg = tad.gk_rule(7, "cpu")
    _, half = tad.gk_nodes(ca[live], cb[live], xk)
    La, K = half.shape
    fx = _values(rng, (La, K, P) + V, dtype).contiguous()
    counts = torch.as_tensor(rng.integers(15, 4000, (La, K, P)).astype(np.float64))
    return tad.NodeChildren(fx, counts, half.contiguous(), live, wk, wg)


def _assert_same(got, want, picks=True, active=True):
    names = ("a", "b", "err", "l1", "val", "n", "evals", "tot_val", "tot_err", "tol")
    for name in names + (("active",) if active else ()) + (("idx", "ca", "cb") if picks else ()):
        assert torch.equal(getattr(got, name), getattr(want, name)), name


@pytest.mark.parametrize("nb", [1, 4])
@pytest.mark.parametrize("values", sorted(VALUES))
def test_plain_start_and_step_are_the_old_trips(nb, values):
    """Trip by trip: the old route (select; the rule's reduction scattered
    to every lane; update) and the new (start on the pool as it stands, then
    the step from the live lanes' node values) give the same pools, picks,
    totals and live flags, with the collision (n < nbisect), stopped and
    converged lanes among them."""
    V, dtype = VALUES[values]
    rng = np.random.default_rng(19 + nb)
    old = _pool(rng, nb, V, dtype)
    tad.gk_pool_totals_plain(old)
    new = old.clone()
    tad.gk_pool_start(new, nb)
    for trip in range(6):
        idx, ca, cb = tad.gk_pool_select_plain(old, nb)
        assert torch.equal(idx, new.idx) and torch.equal(ca, new.ca) and torch.equal(cb, new.cb)
        assert torch.equal(old.active, new.active)
        live = old.active.nonzero().squeeze(1)
        if trip == 0:
            assert bool(old.active[:3].all()) and not bool(old.active[3:8].any())
        if live.numel() == 0:
            break
        kids = _node_children(rng, ca, cb, live, V, dtype)
        val, err, l1, count = tad.scatter_lanes(L, live, *tad.gk_rule_reduce_plain(*kids[:3], kids.wk, kids.wg))
        tad.gk_pool_update_plain(old, nb, idx, ca, cb, val, err, l1, count)
        tad.gk_pool_step(new, nb, kids)
        _assert_same(new, old, picks=False, active=False)  # the old route tests at the next select
    # a trip from reduced children of every lane takes the same route
    idx, ca, cb = tad.gk_pool_select_plain(old, nb)
    kids = tad.ReducedChildren(_values(rng, (L, 2 * nb) + V, dtype), torch.as_tensor(rng.random((L, 2 * nb))),
                               torch.as_tensor(rng.random((L, 2 * nb))), torch.full((L,), 2.0 * nb * P, dtype=F64))
    tad.gk_pool_update_plain(old, nb, idx, ca, cb, *kids[:4])
    tad.gk_pool_step(new, nb, kids)
    idx, ca, cb = tad.gk_pool_select_plain(old, nb)
    _assert_same(new, old, picks=False)
    assert torch.equal(new.idx, idx) and torch.equal(new.ca, ca) and torch.equal(new.cb, cb)


@pytest.mark.parametrize("form", ["nodes", "reduced"])
@pytest.mark.parametrize("values", ["V1", "complex2"])
def test_plain_cold_start_is_the_padded_pool(form, values):
    """The cold start from the rule's outputs on K segments: the old padded
    pool and its totals, then the first select."""
    V, dtype = VALUES[values]
    rng = np.random.default_rng(7)
    K, nb = 3, 4
    a0 = torch.as_tensor(np.sort(rng.random((L, K + 1)), axis=1))
    a0, b0 = a0[:, :-1].contiguous(), a0[:, 1:].contiguous()
    everyone = torch.arange(L)
    if form == "nodes":
        kids = _node_children(rng, a0, b0, everyone, V, dtype)
    else:
        kids = tad.ReducedChildren(_values(rng, (L, K) + V, dtype), torch.as_tensor(rng.random((L, K))),
                                   torch.as_tensor(rng.random((L, K))), torch.full((L,), 45.0, dtype=F64))
    val0, err0, l10, count0 = tad.reduced_children(kids, L)

    def pad(v):
        out = torch.zeros((L, CAP) + tuple(v.shape[2:]), dtype=v.dtype)
        out[:, :K] = v
        return out

    atol = torch.as_tensor(rng.random(L) * 1e-3)
    atol[::5] = 1e3  # converged from the start
    old = tad.GKPool(a=pad(a0), b=pad(b0), err=pad(err0), l1=pad(l10), val=pad(val0),
                     n=torch.full((L,), K, dtype=torch.int64), evals=count0.clone(), atol=atol, rtol=0.0,
                     max_evals=1e9, active=torch.ones(L, dtype=torch.bool))
    tad.gk_pool_totals_plain(old)
    idx, ca, cb = tad.gk_pool_select_plain(old, nb)
    new = tad._empty_pool(L, CAP, V, dtype, torch.device("cpu"), atol, 0.0, None)
    tad.gk_pool_start(new, nb, a0, b0, kids)
    _assert_same(new, old, picks=False)
    assert torch.equal(new.idx, idx) and torch.equal(new.ca, ca) and torch.equal(new.cb, cb)
    assert 0 < int(new.active.sum()) < L


@pytest.mark.parametrize("select", [False, True])
def test_plain_seed_is_the_old_chunk_write(select):
    """Two seed chunks of a partition: the old route (the pool cloned from
    the partition with zero values, each chunk written to its seeding lanes
    and the totals recomputed) and the seed entry (the first chunk starting
    the pool, the last with the first picks where asked)."""
    rng = np.random.default_rng(11)
    a_c, b_c, e_c, n0 = dyadic_pools(rng, L, CAP, np.array([0.0, 1.0]), "cpu")
    C, nb = 8, 4
    atol = torch.as_tensor(rng.random(L) * 1e-6)
    old = tad.GKPool(a=a_c.clone(), b=b_c.clone(), err=torch.zeros(L, CAP, dtype=F64), l1=torch.zeros(L, CAP, dtype=F64),
                     val=torch.zeros(L, CAP, dtype=C128), n=torch.zeros(L, dtype=torch.int64),
                     evals=torch.zeros(L, dtype=F64), atol=atol, rtol=0.0, max_evals=1e9,
                     active=torch.ones(L, dtype=torch.bool))
    new = tad._empty_pool(L, CAP, (), C128, torch.device("cpu"), atol, 0.0, None)
    for k, start in enumerate((0, C)):
        seeding = k * C < n0
        live = seeding.nonzero().squeeze(1)
        ca, cb = a_c[:, start:start + C].contiguous(), b_c[:, start:start + C].contiguous()
        kids = _node_children(rng, ca, cb, live, (), C128)
        cval, cerr, cl1, count = tad.reduced_children(kids, L)
        rows, slots = live[:, None], start + torch.arange(C)
        for arr, c in ((old.a, ca), (old.b, cb), (old.err, cerr), (old.l1, cl1), (old.val, cval)):
            arr[rows, slots] = c[live]
        old.n[live] = n0[live]
        old.evals[live] += count[live]
        tad.gk_pool_totals_plain(old)
        tad.gk_pool_seed(new, start, kids, n0, seeding, nb, partition=(a_c, b_c) if k == 0 else None,
                         select=select and k == 1)
        _assert_same(new, old, picks=False)
    if select:
        idx, ca, cb = tad.gk_pool_select_plain(old, nb)
        assert torch.equal(new.idx, idx) and torch.equal(new.ca, ca) and torch.equal(new.active, old.active)
    else:
        assert new.idx is None


def test_entries_refuse_what_they_do_not_take():
    rng = np.random.default_rng(3)
    pool = _pool(rng, 2, (), F64)
    tad.gk_pool_start(pool, 2)
    live = pool.active.nonzero().squeeze(1)
    kids = _node_children(rng, pool.ca, pool.cb, live, (), F64)
    with pytest.raises(ValueError):  # node values of another dtype than the pool's
        tad.gk_pool_step(pool, 2, kids._replace(fx=kids.fx.to(C128)))
    with pytest.raises(ValueError):  # children of 3 a lane for nbisect 2
        tad.gk_pool_step(pool, 2, kids._replace(fx=kids.fx[:, :3].contiguous(), half=kids.half[:, :3].contiguous()))
    z = lambda *shape: torch.zeros(shape, dtype=F64)  # noqa: E731
    with pytest.raises(ValueError):  # more lanes than the pool has
        tad.gk_pool_step(pool, 2, tad.ReducedChildren(z(L + 1, 4), z(L + 1, 4), z(L + 1, 4), z(L + 1),
                                                      torch.arange(L + 1)))
    with pytest.raises(ValueError):  # a cold start wider than cap
        tad.gk_pool_start(pool, 2, z(L, CAP + 1), z(L, CAP + 1),
                          tad.ReducedChildren(z(L, CAP + 1), z(L, CAP + 1), z(L, CAP + 1), z(L)))
    with pytest.raises(ValueError):  # a seed chunk past cap
        tad.gk_pool_seed(pool, CAP - 2, tad.ReducedChildren(z(L, 4), z(L, 4), z(L, 4), z(L)), pool.n,
                         pool.active, 2)


def test_flagship_knob_nest_matches_reference():
    """A 3-D DOS nest at the main path's knobs (inner_cap 64, inner_nbisect
    4) on a small random Wannier model: the leaf's trip route (the fused
    solve's plain version) and the mid level's steps from node values, with
    the reference's counts and retcode."""
    js, ts = jtb.synthetic_wannier(2, nr=3), ttb.synthetic_wannier(2, nr=3, device="cpu")
    kw = dict(inner_cap=64, inner_nbisect=4)
    jbz, tbz = J.load_bz(J.FBZ(), np.eye(3)), T.load_bz(T.FBZ(), np.eye(3))
    want = J.solve(J.IntegralProblem(J.FourierIntegrand(jdos, js, eta=0.3), jbz, 0.2), J.IAI(**kw), abstol=1e-2)
    got = T.solve(T.IntegralProblem(T.FourierIntegrand(tobs.dos_trace, ts, eta=0.3), tbz, 0.2),
                  T.IAI(device="cpu", **kw), abstol=1e-2)
    w = float(np.asarray(want.u))
    assert abs(float(got.u) - w) <= 1e-12 * abs(w)
    assert got.numevals == want.numevals and got.retcode == want.retcode is True
