"""Parity of the port's lane-batched Gauss-Kronrod pools (``ops/adaptive``,
``algorithms/gk``) with the JAX package on the CPU: the rule evaluation
(plain K5 reduction and plain K4), the cold pool against ``vmap`` of the
reference's ``gk_adaptive``, and the 1-D ``QuadGKJL`` anchors."""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import autobzcore_torch as T
import autobzcore_tpu as J
from autobzcore_torch.fourier import FourierCarrier as TCarrier
from autobzcore_torch.models import observables as tobs
from autobzcore_torch.models import tight_binding as ttb
from autobzcore_torch.ops import adaptive as tad
from autobzcore_torch.ops import quad_rules as tqr
from autobzcore_tpu.fourier import FourierCarrier as JCarrier
from autobzcore_tpu.models import tight_binding as jtb
from autobzcore_tpu.models.observables import dos_trace as jdos
from autobzcore_tpu.ops import adaptive as jad
from autobzcore_tpu.ops import quad_rules as jqr

torch.set_num_threads(2)


@pytest.mark.parametrize("order", [3, 7, 9, 15])
def test_rules_are_the_reference_rules(order):
    for got, want in zip(tqr.kronrod(order), jqr.kronrod(order)):
        np.testing.assert_array_equal(got, want)
    np.testing.assert_array_equal(tqr.gausslegendre(order)[0], jqr.gausslegendre(order)[0])
    np.testing.assert_array_equal(tqr.trapz(order)[1], jqr.trapz(order)[1])


def test_count_and_budget_are_float64():
    assert tad._count_dtype() == torch.float64
    assert tad._as_eval_budget(None) == 2.0**62 and tad._as_eval_budget(150) == 150.0


def _series_1d(model, rng):
    """A 1-D series from a 3-D model contracted at random (x3, x2), as the
    leaf of a nest sees it, in both packages."""
    js, ts = {"flagship": (None, ttb.flagship_series(device="cpu")),
              "wannier2": (jtb.synthetic_wannier(2), ttb.synthetic_wannier(2, device="cpu"))}[model]
    if js is None:
        import __graft_entry__

        js = __graft_entry__._flagship_series(jnp.complex128)
    x3, x2 = rng.random(2)
    return js.contract(x3).contract(x2), ts.contract(x3).contract(x2)


@pytest.mark.parametrize("model", ["flagship", "wannier2"])
def test_rule_eval_matches_reference(model):
    """gk_rule_eval over the 1-D carrier and dos_trace: the plain K5
    reduction and the plain fused leaf K4 against JAX's gk_rule_eval."""
    rng = np.random.default_rng(5)
    js1, ts1 = _series_1d(model, rng)
    om, eta = 0.7, 0.05
    a = np.sort(rng.random(6))
    aa, bb = a[:3], a[3:]
    bb[1] = aa[1]  # a dead (zero-width) interval
    xk, wk, wg = (jnp.asarray(t) for t in jqr.kronrod(7))
    jfi, jp = J.FourierIntegrand(jdos, js1, eta=eta).with_parameters(om)
    jcar = jfi.nest_carrier()
    assert isinstance(jcar, JCarrier)
    want = jad.gk_rule_eval(lambda xs, p: jcar.eval_batch(xs, (), p), jp,
                            jnp.asarray(aa), jnp.asarray(bb), xk, wk, wg, lambda x: x)
    want = [np.asarray(w) for w in want]
    txk, twk, twg = tad.gk_rule(7, "cpu")
    tfi, tp = T.FourierIntegrand(tobs.dos_trace, ts1, eta=eta).with_parameters(om)
    tcar = tfi.nest_carrier()
    assert isinstance(tcar, TCarrier)
    params = T.parameters.LaneParams(tp)

    def batch_f(xs, p):
        return tcar.eval_batch(xs[None], (), params)[0]

    got = tad.gk_rule_eval(batch_f, None, torch.as_tensor(aa), torch.as_tensor(bb), txk, twk, twg)
    scale = np.max(want[2])
    for g, w in zip(got[:3], want[:3]):
        assert np.max(np.abs(g.numpy() - w)) <= 1e-12 * scale
    assert float(got[3]) == float(want[3]) == 3 * 15
    m = int(np.sqrt(ts1.c.shape[-1] * ts1.c.shape[-2]))
    c1 = ts1.c.reshape(1, ts1.c.shape[0], m * m).contiguous()
    fused = tobs.gk_leaf_dos(c1, torch.zeros(1, dtype=torch.int64), ts1.offset[0], ts1.period[0],
                             torch.as_tensor(aa)[None], torch.as_tensor(bb)[None],
                             torch.tensor([om], dtype=torch.float64), torch.tensor([eta], dtype=torch.float64), torch.ones(1, dtype=torch.bool),
                             txk, twk, twg)
    for g, w in zip(fused[:3], want[:3]):
        assert np.max(np.abs(g[0].numpy() - w)) <= 1e-12 * scale
    assert float(fused[3][0]) == 3 * 15


def test_rule_reduce_sums_per_node_counts_and_masks_dead_intervals():
    rng = np.random.default_rng(6)
    fx = torch.as_tensor(rng.normal(size=(2, 3, 15)) + 1j * rng.normal(size=(2, 3, 15)))
    counts = torch.as_tensor(rng.integers(1, 100, (2, 3, 15)).astype(np.float64))
    half = torch.as_tensor(rng.random((2, 3)))
    half[1, 2] = 0.0
    _, wk, wg = tad.gk_rule(7, "cpu")
    val, err, l1, count = tad.gk_rule_reduce(fx, counts, half, wk, wg)
    assert torch.equal(count, counts.sum(dim=(1, 2)))
    assert val[1, 2] == 0 and err[1, 2] == 0 and l1[1, 2] == 0
    want = jad.gk_rule_eval(lambda xs, p: jnp.asarray(fx[0].reshape(-1).numpy()), None,
                            jnp.zeros(3), 2 * jnp.asarray(half[0].numpy()), jnp.asarray(np.zeros(15)),
                            jnp.asarray(wk.numpy()), jnp.asarray(wg.numpy()), lambda x: x)
    np.testing.assert_allclose(val[0].numpy(), np.asarray(want[0]), rtol=1e-13, atol=0)
    np.testing.assert_allclose(err[0].numpy(), np.asarray(want[1]), rtol=1e-12, atol=1e-300)


# --- the pool against vmap(gk_adaptive) -------------------------------------------
PS = np.array([0.13, 0.5, 0.77, 0.91])  # one peak position per lane


def _jax_f(x, p):
    return 1.0 / ((x - p) ** 2 + 1e-3) + jnp.sin(7 * x)


def _torch_f(x, p):
    return 1.0 / ((x - p) ** 2 + 1e-3) + torch.sin(7 * x)


def _lanes(ps, segs, *, cap, nbisect, abstol, reltol=None, maxiters=None, presplit=1, order=7):
    """The port's pool over one lane per peak position."""
    xk, wk, wg = tad.gk_rule(order, "cpu")
    p = torch.as_tensor(ps)

    def rule(ca, cb, active, live):
        nodes, half = tad.gk_nodes(ca, cb, xk)
        fx = _torch_f(nodes, p[:, None, None])
        out = tad.gk_rule_reduce(fx.contiguous(), None, half.contiguous(), wk, wg)
        zero = torch.zeros((), dtype=torch.float64)
        return [torch.where(active.reshape((-1,) + (1,) * (o.ndim - 1)), o, zero) for o in out]

    atol_s, rtol_s = T.algorithms.base.effective_tolerances(abstol, reltol)
    segs_t = torch.as_tensor(np.asarray(segs, dtype=np.float64)).expand(len(ps), -1).contiguous()
    return tad.gk_adaptive_lanes(rule, segs_t, torch.full((len(ps),), atol_s), cap=cap,
                                 nbisect=nbisect, rtol=rtol_s, maxiters=maxiters, presplit=presplit)


def _jax_lanes(ps, segs, **kw):
    def batch_f(xs, p):
        return _jax_f(xs, p)

    return jax.vmap(lambda p: jad.gk_adaptive(batch_f, p, jnp.asarray(segs), **kw))(jnp.asarray(ps))


POOL_CASES = {
    "nbisect1": dict(cap=256, nbisect=1, abstol=1e-8),
    "nbisect2": dict(cap=256, nbisect=2, abstol=1e-8),
    "nbisect4": dict(cap=256, nbisect=4, abstol=1e-8),
    "presplit3": dict(cap=256, nbisect=2, abstol=1e-8, presplit=3),
    "two_segments": dict(cap=256, nbisect=2, abstol=1e-9, segs=(0.0, 0.4, 1.0)),
    "collision": dict(cap=64, nbisect=4, abstol=1e-7),  # one segment, n = 1 < nbisect at the start
    "reltol": dict(cap=256, nbisect=2, abstol=None, reltol=1e-10),
    "saturates_cap": dict(cap=24, nbisect=2, abstol=1e-14),
    "maxiters": dict(cap=256, nbisect=2, abstol=1e-14, maxiters=200),
    "order9": dict(cap=128, nbisect=2, abstol=1e-8, order=9),
}


@pytest.mark.parametrize("case", sorted(POOL_CASES))
def test_pool_matches_vmapped_reference(case):
    kw = dict(POOL_CASES[case])
    segs = kw.pop("segs", (0.0, 1.0))
    got = _lanes(PS, segs, **kw)
    want = _jax_lanes(PS, segs, **kw)
    val, err, ne, conv = (np.asarray(w) for w in want)
    np.testing.assert_array_equal(got[2].numpy(), ne)
    np.testing.assert_array_equal(got[3].numpy(), conv)
    assert np.max(np.abs(got[0].numpy() - val)) <= 1e-12 * np.max(np.abs(val))
    # error estimates are differences of the two rules: held at the values' scale
    assert np.max(np.abs(got[1].numpy() - err)) <= 1e-12 * np.max(np.abs(val))
    if case in ("saturates_cap", "maxiters"):
        assert not conv.any()
    else:
        assert conv.all()
    if case == "saturates_cap":
        # trips until n + nbisect > cap, each evaluating 2 nbisect intervals
        assert np.all(ne == 15 * (1 + 2 * 2 * ((24 - 1) // 2)))


def test_pool_collision_keeps_the_right_child():
    """nbisect = 2 on one segment: the second pick is the dead slot 1,
    which the fresh right child must overwrite (two sequential scatters)."""
    f64 = dict(dtype=torch.float64)
    pool = tad.GKPool(a=torch.zeros(1, 4, **f64), b=torch.tensor([[1.0, 0, 0, 0]], **f64),
                      err=torch.tensor([[0.5, 0, 0, 0]], **f64), l1=torch.zeros(1, 4, **f64),
                      val=torch.tensor([[9.0, 0, 0, 0]], **f64), n=torch.ones(1, dtype=torch.int64),
                      evals=torch.zeros(1, dtype=torch.float64), atol=torch.zeros(1, dtype=torch.float64),
                      rtol=0.0, max_evals=1e9, active=torch.ones(1, dtype=torch.bool))
    tad.gk_pool_totals(pool)
    idx, ca, cb = tad.gk_pool_select(pool, 2)
    assert idx.tolist() == [[0, 1]]
    cval = torch.tensor([[1.0, 2.0, 3.0, 4.0]], dtype=torch.float64)
    tad.gk_pool_update(pool, 2, idx, ca, cb, cval, cval / 10, cval,
                       torch.tensor([60.0], dtype=torch.float64))
    assert pool.a[0].tolist() == [0.0, 0.5, 0.0, 0.0] and pool.b[0].tolist() == [0.5, 1.0, 0.0, 0.0]
    assert pool.val[0].tolist() == [1.0, 3.0, 4.0, 0.0] and pool.n.tolist() == [3]
    assert float(pool.tot_val[0]) == 8.0 and float(pool.evals[0]) == 60.0


@pytest.mark.parametrize("kw", [dict(nbisect=2, abstol=1e-9), dict(nbisect=4, reltol=1e-11, presplit=3),
                                dict(cap=16, nbisect=2, abstol=1e-14), dict()],
                         ids=["abstol", "reltol_presplit", "saturates_cap", "default_tolerance"])
def test_single_pool_gk_adaptive_matches_reference(kw):
    """The reference's signature: one pool, a batch integrand with per-node
    counts (stats), node_builder lifting nodes."""
    def jf(xs, p):
        return _jax_f(xs[:, 0], p), jnp.full(xs.shape[:1], 3)

    def tf(xs, p):
        return _torch_f(xs[:, 0], p), torch.full(xs.shape[:1], 3.0, dtype=torch.float64)

    want = jad.gk_adaptive(jf, 0.77, jnp.asarray([0.0, 0.5, 1.0]), stats=True,
                           node_builder=lambda x: x[:, None], **kw)
    got = tad.gk_adaptive(tf, 0.77, [0.0, 0.5, 1.0], stats=True, node_builder=lambda x: x[:, None], **kw)
    val = float(np.asarray(want[0]))
    assert abs(float(got[0]) - val) <= 1e-12 * abs(val)
    assert float(got[2]) == float(np.asarray(want[2])) and bool(got[3]) == bool(np.asarray(want[3]))


@pytest.mark.parametrize("kw", [dict(init_pool=(None,) * 4), dict(seed_width=8), dict(noise_rfloor=1e-6),
                                dict(stall_patience=4), dict(norm=lambda v: v)])
def test_single_pool_refuses_later_slices(kw):
    with pytest.raises(NotImplementedError, match="A5"):
        tad.gk_adaptive(lambda xs, p: xs, None, [0.0, 1.0], **kw)


# --- QuadGKJL -----------------------------------------------------------------------
@pytest.mark.parametrize("order,evals", [(7, 15), (9, 19)])
def test_quadgk_counts_one_rule_on_a_polynomial(order, evals):
    sol = T.solve(T.IntegralProblem(lambda x, p: x**3 + 2 * x, 0.0, 1.0),
                  T.QuadGKJL(order=order, device="cpu"))
    assert sol.numevals == evals and sol.retcode
    assert abs(float(sol.u) - 1.25) <= 1e-14


def test_quadgk_gloc_1d_anchor():
    """H(k) = cos(2 pi k), eta = 0.1: gloc(0) = -0.9950375451895513 i, with
    the reference's value and count."""
    def make(P, h, xp):
        def g(k, h, eta=None, om=None):
            return 1.0 / ((om + 1j * eta) - h(xp.atleast_1d(k)))

        return P.IntegralProblem(P.ParameterIntegrand(g, h, eta=0.1), 0.0, 1.0,
                                 P.MixedParameters(om=0.0))

    th = T.FourierSeries(np.array([0.5, 0.0, 0.5]), period=1.0, offset=-1, device="cpu")
    jh = J.FourierSeries(np.array([0.5, 0.0, 0.5]), period=1.0, offset=-1)
    got = T.solve(make(T, th, torch), T.QuadGKJL(device="cpu"), abstol=1e-3)
    want = J.solve(make(J, jh, jnp), J.QuadGKJL(), abstol=1e-3)
    val = complex(got.u)
    assert abs(val.imag + 0.9950375451895513) <= 1e-3 and abs(val.real) < 1e-10
    assert abs(val - complex(np.asarray(want.u))) <= 1e-12
    assert got.numevals == want.numevals and got.retcode == want.retcode
    prob = make(T, th, torch)
    solver = T.IntegralSolver(prob.f, prob.dom, T.QuadGKJL(device="cpu"), abstol=1e-3)
    assert complex(solver(om=0.0)) == val


@pytest.mark.parametrize("a,b", [(0.0, np.inf), (-np.inf, np.inf), (np.inf, 0.0), (-np.inf, 1.0)])
def test_quadgk_infinite_limits_match_reference(a, b):
    got = T.solve(T.IntegralProblem(lambda x, p: torch.exp(-(x - p) ** 2), a, b, 0.3),
                  T.QuadGKJL(device="cpu"), abstol=1e-10)
    want = J.solve(J.IntegralProblem(lambda x, p: jnp.exp(-(x - p) ** 2), a, b, 0.3),
                   J.QuadGKJL(), abstol=1e-10)
    assert abs(float(got.u) - float(np.asarray(want.u))) <= 1e-12
    assert got.numevals == want.numevals and got.retcode == want.retcode


def test_quadgk_refuses_unported_forms():
    with pytest.raises(NotImplementedError, match="A5"):
        T.solve(T.IntegralProblem(lambda x, p: x, 0.0, 1.0),
                T.QuadGKJL(norm=lambda v: 0.0, device="cpu"))
    with pytest.raises(RuntimeError, match="CUDA"):
        T.solve(T.IntegralProblem(lambda x, p: x, 0.0, 1.0), T.QuadGKJL())
