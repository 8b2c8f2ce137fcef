"""The fused leaf solve of a nested DOS (``gk_leaf_dos_solve``) on the CPU:
its plain version is the loop of ``gk_adaptive_lanes`` (select, K4, update
until no lane is live) bit for bit, on cold and seeded pools, one frequency
or an omega block per lane; and an IAI DOS nest that runs its leaves
through it gives the JAX package's values, ``numevals`` and retcodes."""
import math

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

POOL_FIELDS = ("a", "b", "err", "l1", "val", "n", "evals", "tot_val", "tot_err", "tol", "active")


def _leaf_problem(seed, L, m, W, n=5):
    """L leaf lanes of random Hermitian 1-D series (n terms of m x m), one
    frequency each (W = 0: om, eta (L,)) or an omega block of W, eta 0.05-0.2,
    each lane on [0, 1] with its own absolute tolerance."""
    rng = np.random.default_rng(seed)
    a = rng.normal(size=(L, n, m, m)) + 1j * rng.normal(size=(L, n, m, m))
    a *= np.exp(-np.abs(np.arange(n) - n // 2))[None, :, None, None]
    a = (a + np.conj(a[:, ::-1].transpose(0, 1, 3, 2))) / 2  # H(x) Hermitian
    c = torch.as_tensor(a.reshape(L, n, m * m)).contiguous()
    shape = (L,) if W == 0 else (L, W)
    om = torch.as_tensor(rng.uniform(-2.0, 2.0, shape))
    eta = torch.as_tensor(rng.uniform(0.05, 0.2, shape))
    segs = torch.tensor([0.0, 1.0], dtype=torch.float64).expand(L, 2).contiguous()
    atol = torch.as_tensor(10 ** rng.uniform(-6, -3, L))
    return c, torch.arange(L), -(n // 2), 1.0, om, eta, segs, atol


def _routes(problem, *, cap, nbisect, maxiters=None, init_pool=None, seed_coarsen=True):
    """The same lanes by the trip route (``gk_adaptive_lanes``'s loop on the
    plain select, K4 and update) and through the fused solve's hook (on the
    CPU its plain version); returns both final pools, the trip route's
    stats, the solve's per-lane trips and the stats that counted them."""
    c, cmap, offset, period, om, eta, segs, atol = problem
    xk, wk, wg = tad.gk_rule(7, "cpu")
    rule = tobs.leaf_dos_rule(c, cmap, offset, period, om, eta, xk, wk, wg, tobs.gk_leaf_dos)
    kw = dict(cap=cap, nbisect=nbisect, rtol=0.0, maxiters=maxiters, level=1, return_state=True,
              seed_coarsen=seed_coarsen)
    stats = tad.LoopStats()
    seed = None if init_pool is None else tuple(t.clone() for t in init_pool)
    trip_pool = tad.gk_adaptive_lanes(rule, segs, atol, stats=stats, init_pool=seed, **kw)[4]
    out = {}
    solve_stats = tad.LoopStats()

    def solve(pool, nb):
        out["trips"] = tobs.gk_leaf_dos_solve(pool, c, cmap, offset, period, om, eta, xk, wk, wg, nb)
        solve_stats.device_trip(1, out["trips"])

    seed = None if init_pool is None else tuple(t.clone() for t in init_pool)
    solve_pool = tad.gk_adaptive_lanes(rule, segs, atol, init_pool=seed, solve=solve, stats=solve_stats, **kw)[4]
    solve_stats.read_device_trips()
    return trip_pool, solve_pool, stats, out["trips"], solve_stats


def _assert_same_pools(got, want):
    for k in POOL_FIELDS:
        assert torch.equal(getattr(got, k), getattr(want, k)), k


@pytest.mark.parametrize("W", [0, 2], ids=["one_frequency", "block2"])
@pytest.mark.parametrize("m", [1, 3])
@pytest.mark.parametrize("start", ["cold", "seeded"])
def test_plain_solve_is_the_adaptive_loop_bit_for_bit(start, m, W):
    problem = _leaf_problem(10 * m + W, 16, m, W)
    init = None
    if start == "seeded":
        a, b, e, n = dyadic_pools(np.random.default_rng(3), 16, 32, [0.0, 0.5, 1.0], "cpu")
        init = (a, b, e, n)
    trip_pool, solve_pool, stats, trips, solve_stats = _routes(problem, cap=32, nbisect=2, init_pool=init,
                                                               seed_coarsen=start == "seeded")
    _assert_same_pools(solve_pool, trip_pool)
    # the trip route's host loop runs as many trips as the busiest lane
    assert int(trips.max()) == stats.trips[1] == solve_stats.trips[1] > 0
    assert not bool(solve_pool.active.any())


@pytest.mark.parametrize("limit", ["cap", "budget"])
def test_plain_solve_stops_at_cap_and_budget_as_the_loop(limit):
    """Lanes that fill their pool (cap 12) or spend their evaluation budget
    stop where the trip route stops them, unconverged."""
    problem = _leaf_problem(7, 10, 2, 0)
    kw = dict(cap=12, nbisect=4) if limit == "cap" else dict(cap=64, nbisect=2, maxiters=400)
    c, cmap, offset, period, om, eta, segs, atol = problem
    problem = (c, cmap, offset, period, om, eta * 0.2, segs, atol * 1e-6)
    trip_pool, solve_pool, stats, trips, _ = _routes(problem, **kw)
    _assert_same_pools(solve_pool, trip_pool)
    assert int(trips.max()) == stats.trips[1]
    assert not bool((solve_pool.tot_err <= solve_pool.tol).all())


def test_solve_leaves_inactive_lanes_and_counts_trips_per_lane():
    """Against the trip route lane by lane on one started pool: inactive
    lanes keep their pools and count no trip; every lane's trips match."""
    c, cmap, offset, period, om, eta, segs, atol = _leaf_problem(5, 12, 3, 0)
    xk, wk, wg = tad.gk_rule(7, "cpu")
    rule = tobs.leaf_dos_rule(c, cmap, offset, period, om, eta, xk, wk, wg, tobs.gk_leaf_dos)
    pool = tad._cold_pool(rule, segs, atol, cap=32, nbisect=2, rtol=0.0, maxiters=None, presplit=1,
                          kernels=tad.pool_kernels())
    pool.active[::4] = False
    ref = tad.GKPool(**{k: (v.clone() if isinstance(v, torch.Tensor) else v) for k, v in pool.__dict__.items()})
    before = tobs.gk_leaf_dos_solve.launches
    trips = tobs.gk_leaf_dos_solve(pool, c, cmap, offset, period, om, eta, xk, wk, wg, 2)
    assert tobs.gk_leaf_dos_solve.launches == before  # CPU: the plain version, no launch
    want = tobs.gk_leaf_dos_solve_plain(ref, c, cmap, offset, period, om, eta, xk, wk, wg, 2)
    assert torch.equal(trips, want) and bool((trips[::4] == 0).all()) and bool((trips[1::4] > 0).all())
    _assert_same_pools(pool, ref)


def test_solve_wrapper_refuses_what_it_does_not_take():
    c, cmap, offset, period, om, eta, segs, atol = _leaf_problem(2, 4, 2, 0)
    xk, wk, wg = tad.gk_rule(7, "cpu")
    rule = tobs.leaf_dos_rule(c, cmap, offset, period, om, eta, xk, wk, wg, tobs.gk_leaf_dos)
    pool = tad._cold_pool(rule, segs, atol, cap=16, nbisect=2, rtol=0.0, maxiters=None, presplit=1,
                          kernels=tad.pool_kernels())
    args = (c, cmap, offset, period)
    with pytest.raises(ValueError):  # a block's frequencies for a one-channel pool
        tobs.gk_leaf_dos_solve(pool, *args, om[:, None].expand(4, 2).contiguous(),
                               eta[:, None].expand(4, 2).contiguous(), xk, wk, wg, 2)
    with pytest.raises(ValueError):  # a map of the wrong length
        tobs.gk_leaf_dos_solve(pool, c, cmap[:3], offset, period, om, eta, xk, wk, wg, 2)
    with pytest.raises(ValueError):  # pool values that are not float64
        tobs.gk_leaf_dos_solve(tad.GKPool(**dict(pool.__dict__, val=pool.val.float())), *args, om, eta, xk, wk,
                               wg, 2)
    pool.tot_val = None
    with pytest.raises(ValueError):  # a pool that was never started
        tobs.gk_leaf_dos_solve(pool, *args, om, eta, xk, wk, wg, 2)
    assert tobs.leaf_solve_takes(torch.device("cpu"), 4096, 9, 64, 61, 20, 3)


def _nest_cases():
    rng = np.random.default_rng(15)
    return [("tb_integer", "FBZ", float(rng.uniform(-2.5, 2.5)), 0.3),
            ("tb_integer", "CubicSymIBZ", float(rng.uniform(-2.5, 2.5)), 0.3),
            ("synthetic_wannier", "FBZ", float(rng.uniform(-1.0, 1.0)), 0.4)]


@pytest.mark.parametrize("model,kind,om,eta", _nest_cases(), ids=["tb_integer_fbz", "tb_integer_ibz",
                                                                    "synthetic3_fbz"])
def test_iai_nest_through_the_solve_matches_reference(monkeypatch, model, kind, om, eta):
    """A small 3-D IAI DOS nest whose leaf levels run through the fused
    solve's entry (its plain version on the CPU) against the JAX package's
    IAI: identical numevals and retcodes, values to 1e-12."""
    calls = []
    plain = tobs.gk_leaf_dos_solve_plain

    def counted(*a, **k):
        calls.append(1)
        return plain(*a, **k)

    monkeypatch.setattr(tobs, "gk_leaf_dos_solve_plain", counted)
    if model == "tb_integer":
        js, ts = jtb.tb_integer(3), ttb.tb_integer(3, device="cpu")
    else:
        js = jtb.synthetic_wannier(3, nr=3, seed=4)
        ts = ttb.synthetic_wannier(3, nr=3, seed=4, device="cpu")
    jbz, tbz = J.load_bz(getattr(J, kind)(), np.eye(3)), T.load_bz(getattr(T, kind)(), np.eye(3))
    want = J.solve(J.IntegralProblem(J.FourierIntegrand(jdos, js, eta=eta), jbz, om),
                   J.IAI(inner_cap=32, inner_nbisect=2), abstol=1e-3)
    got = T.solve(T.IntegralProblem(T.FourierIntegrand(tobs.dos_trace, ts, eta=eta), tbz, om),
                  T.IAI(inner_cap=32, inner_nbisect=2, device="cpu"), abstol=1e-3)
    w = float(np.asarray(want.u))
    assert calls, "the leaf levels did not go through gk_leaf_dos_solve"
    assert abs(float(got.u) - w) <= 1e-12 * max(abs(w), 1.0) and math.isfinite(w)
    assert got.numevals == want.numevals and got.retcode == want.retcode
