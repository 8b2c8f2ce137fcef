"""Parity of the port's Genz-Malik cubature (``ops/genz_malik``,
``algorithms/hcubature``, ``brillouin.TAI``) with the JAX package on the CPU:
the rule, the box evaluation (plain K14 and K15) with dead slots and an
integrand that is NaN at the origin, one pool trip from the reference's
mid-loop pool, and value, error, retcode and ``numevals`` on the reference's
own HCubatureJL and TAI cases. Values agree within 1e-12 relative where both
packages take the same path (sums in another order), counts and retcodes
exactly."""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import autobzcore_torch as T
import autobzcore_tpu as J
from autobzcore_torch import interop
from autobzcore_torch.models import observables as tobs
from autobzcore_torch.models import tight_binding as ttb
from autobzcore_torch.ops import genz_malik as tgm
from autobzcore_tpu.models import tight_binding as jtb
from autobzcore_tpu.models.observables import dos_trace as jdos
from autobzcore_tpu.ops import genz_malik as jgm

torch.set_num_threads(2)
REL = 1e-12


def _close(got, want, rel=REL, scale=None):
    """max|got - want| <= rel * scale, the scale max|want| unless given (an
    error estimate is a difference of two rule values: its scale is theirs)."""
    got, want = np.asarray(got), np.asarray(want)
    scale = max(float(np.max(np.abs(want))) if scale is None else scale, 1e-300)
    assert got.shape == want.shape
    assert float(np.max(np.abs(got - want))) <= rel * scale, (got, want)


def _same_solution(got, want, rel=REL):
    u = np.complex128(np.asarray(want.u))
    _close(np.complex128(np.asarray(got.u)), u, rel)
    if want.resid is not None:
        _close(float(got.resid), float(np.asarray(want.resid)), rel, scale=float(np.max(np.abs(u))))
    assert got.numevals == want.numevals and got.retcode == bool(want.retcode)


@pytest.mark.parametrize("d", [2, 3, 4])
def test_rule_is_the_reference_rule(d):
    for got, want in zip(tgm.gm_rule(d), jgm.gm_rule(d)):
        np.testing.assert_array_equal(got, want)
    assert tgm.gm_rule(d)[0].shape[0] == {2: 17, 3: 33, 4: 57}[d]
    with pytest.raises(ValueError):
        tgm.gm_rule(1)


def _boxes(rng, K, d, dead):
    c = rng.uniform(0.3, 0.7, (K, d))
    h = rng.uniform(0.01, 0.25, (K, d))
    c[dead], h[dead] = 0.0, 0.0
    return c, h


KINDS = {
    # smooth, real
    "real": (lambda x, p: jnp.exp(jnp.sin(3 * x[..., 0]) * jnp.cos(2 * x[..., -1])) * p,
             lambda x, p: torch.exp(torch.sin(3 * x[..., 0]) * torch.cos(2 * x[..., -1])) * p),
    # complex, two channels
    "complex": (lambda x, p: jnp.stack([jnp.exp(1j * p * jnp.sum(x, -1)), jnp.sum(x * x, -1) + 0j], -1),
                lambda x, p: torch.stack([torch.exp(1j * p * torch.sum(x, -1)),
                                          torch.sum(x * x, -1) + 0j], -1)),
    # NaN at the origin, where dead boxes put their nodes
    "nan_at_origin": (lambda x, p: jnp.sqrt(x[..., 0] - 0.01) * jnp.log(x[..., 1]) * p,
                      lambda x, p: torch.sqrt(x[..., 0] - 0.01) * torch.log(x[..., 1]) * p),
}


@pytest.mark.parametrize("kind", list(KINDS))
@pytest.mark.parametrize("d", [2, 3])
def test_box_eval_matches_reference(kind, d):
    """gm_box_eval on seeded boxes with dead slots: the plain K14 against the
    reference's, val and err masked to exactly 0 on dead boxes, splitdim
    identical (the first NaN where the dead boxes' fourth differences are
    NaN)."""
    rng = np.random.default_rng(11 + d)
    dead = np.array([2, 5, 6])
    c, h = _boxes(rng, 9, d, dead)
    jf, tf = KINDS[kind]
    want = jgm.gm_box_eval(jax.vmap(jf, in_axes=(0, None)), 1.7, jnp.asarray(c), jnp.asarray(h),
                           *(jnp.asarray(a) for a in jgm.gm_rule(d)))
    rule = tgm.gm_rule_tensors(d, "cpu")
    got = tgm.gm_box_eval_plain(lambda X, p: tf(X, p), 1.7, torch.as_tensor(c), torch.as_tensor(h),
                                *rule)
    val, err, sd = (np.asarray(w) for w in want)
    _close(got[0].numpy(), val)
    _close(got[1].numpy(), err, scale=float(np.max(np.abs(val))))
    np.testing.assert_array_equal(got[2].numpy(), sd)
    assert got[2].dtype == torch.int32
    assert np.all(got[0].numpy()[dead] == 0) and np.all(got[1].numpy()[dead] == 0)


def _flagship():
    import __graft_entry__

    js = __graft_entry__._flagship_series(jnp.complex128)
    ts = interop.series_from_arrays(np.asarray(js.c), js.offset, js.period, js.sndim, device="cpu")
    return js, ts


@pytest.mark.parametrize("block", [False, True])
def test_box_dos_rule_matches_reference(block):
    """K15's plain version (dos_trace at the nodes of the flagship's series,
    then the rule) against the reference's gm_box_eval of the DOS integrand,
    one frequency per box or an omega block of 3."""
    js, ts = _flagship()
    rng = np.random.default_rng(4)
    c, h = _boxes(rng, 8, 3, np.array([1, 4]))
    om = np.array([0.3, -1.1, 2.4]) if block else 0.7
    jfi, jp = J.FourierIntegrand(jdos, js, eta=0.05).with_parameters(om)
    want = jgm.gm_box_eval(jax.vmap(jfi, in_axes=(0, None)), jp, jnp.asarray(c), jnp.asarray(h),
                           *(jnp.asarray(a) for a in jgm.gm_rule(3)))
    pts, wk, we, diff_idx = tgm.gm_rule_tensors(3, "cpu")
    nodes, vol = tgm.gm_box_nodes(torch.as_tensor(c), torch.as_tensor(h), pts)
    H = ts.eval_points(nodes.reshape(-1, 3)).reshape(8, pts.shape[0], 3, 3)
    shape = (8, 3) if block else (8,)
    omt = torch.as_tensor(np.broadcast_to(om, shape).copy())
    got = tobs.gm_leaf_dos(H, omt, torch.full(shape, 0.05, dtype=torch.float64), vol, wk, we, diff_idx)
    vscale = float(np.max(np.abs(np.asarray(want[0]))))
    for g, w in zip(got[:2], want[:2]):
        _close(g.numpy(), np.asarray(w), scale=vscale)
    np.testing.assert_array_equal(got[2].numpy(), np.asarray(want[2]))


def _reference_trip(state, jf, p, nbisect):
    """One trip of the reference's gm_adaptive body (autobzcore_tpu/ops/
    genz_malik.py:202-230) from the state tuple, with its own operations."""
    pool_c, pool_h, pool_val, pool_err, n, pool_sd, evals = (jnp.asarray(a) for a in state)
    d = pool_c.shape[1]
    pts, wk, we, diff_idx = (jnp.asarray(a) for a in jgm.gm_rule(d))
    _, idx = jax.lax.top_k(pool_err, nbisect)
    cc, hh, sd = pool_c[idx], pool_h[idx], pool_sd[idx]
    onehot = jax.nn.one_hot(sd, d, dtype=cc.dtype)
    new_h = hh * (1 - onehot / 2)
    off = hh * onehot / 2
    ca = jnp.concatenate([cc - off, cc + off])
    ha = jnp.concatenate([new_h, new_h])
    cval, cerr, csd = jgm.gm_box_eval(jax.vmap(jf, in_axes=(0, None)), p, ca, ha, pts, wk, we,
                                      diff_idx)
    new_idx = n + jnp.arange(nbisect, dtype=n.dtype)

    def two_scatter(arr, ch):
        return arr.at[idx].set(ch[:nbisect]).at[new_idx].set(ch[nbisect:])

    return tuple(np.asarray(a) for a in (
        two_scatter(pool_c, ca), two_scatter(pool_h, ha), two_scatter(pool_val, cval),
        two_scatter(pool_err, cerr), n + nbisect, two_scatter(pool_sd, csd),
        evals + 2 * nbisect * pts.shape[0]))


@pytest.mark.parametrize("n", [2, 9])
def test_one_trip_from_a_reference_pool(n):
    """A mid-loop box pool made with numpy from a seed (dead slots among the
    live ones, tied errors, n below and above nbisect) goes through one port
    trip (plain K16 and K14) and through the reference's body: the same
    pool, slot for slot, and the same loop test."""
    rng = np.random.default_rng(n)
    cap, d, nb = 32, 2, 4
    c, h = np.zeros((cap, d)), np.zeros((cap, d))
    c[:n], h[:n] = _boxes(rng, n, d, np.array([1]))
    err = np.zeros(cap)
    err[:n] = np.where(h[:n, 0] > 0, rng.choice([1e-3, 2e-3, 5e-4], n), 0.0)
    val = np.where(h[:, 0] > 0, rng.normal(size=cap), 0.0)
    sd = np.where(h[:, 0] > 0, rng.integers(0, d, cap), 0).astype(np.int32)
    state = (c, h, val, err, np.int32(n), sd, 17.0 * (1 + 8 * (n // 4)))
    jf, tf = KINDS["nan_at_origin"]
    want = _reference_trip(state, jf, 1.3, nb)
    pool = interop.box_pool_from_arrays(state, 17, atol=1e-9, device="cpu")
    np.testing.assert_array_equal(interop.box_pool_to_arrays(pool)[0], c)
    tgm.gm_pool_begin(pool, nb)  # the totals, the loop test and the trip's children
    assert bool(pool.active[0])
    rule_t = tgm.gm_rule_tensors(d, "cpu")

    def rule(cc, hh, active, live):
        out = tgm.gm_box_eval_plain(lambda X, p: tf(X, p), 1.3, cc[0], hh[0], *rule_t)
        return tuple(o[None] for o in out)

    tgm.gm_trip(pool, rule, nb, tgm.box_kernels())
    got = interop.box_pool_to_arrays(pool)
    for k in (0, 1, 4, 5, 6):  # centres, halves, n, splitdim, evals
        np.testing.assert_array_equal(np.asarray(got[k]), np.asarray(want[k]))
    vscale = float(np.max(np.abs(want[2])))
    for k in (2, 3):  # values, errors
        _close(got[k], want[k], scale=vscale)
    tot_err, tot_val = float(np.sum(want[3])), float(np.sum(want[2]))
    _close(float(pool.tot_err[0]), tot_err, scale=vscale)
    _close(float(pool.tot_val[0]), tot_val, scale=vscale)
    assert bool(pool.active[0]) == (tot_err > max(1e-9, 0.0) and want[4] + nb <= cap)


def _step_pool(rng, case, L=6, cap=48, d=3, nb=4):
    """A mid-loop box pool of L lanes made with numpy: random boxes in n live
    slots, and per ``case`` tied errors, dead slots among the live ones,
    fewer live boxes than nbisect, or lanes that stop in their first step
    (tot_err falls to atol, n + nbisect passes cap, evals reach the
    budget)."""
    n = rng.integers(nb + 1, cap - 3 * nb, L)
    if case == "few_live":
        n[:] = rng.integers(1, nb, L)
    live = np.arange(cap)[None, :] < n[:, None]
    if case == "dead":
        live &= rng.random((L, cap)) > 0.3
    err = rng.integers(0, 3, (L, cap)) * 0.5 if case == "ties" else rng.random((L, cap))
    err = np.where(live, err, 0.0)
    atol = np.full(L, 1e-12)
    evals = np.full(L, 33.0 * 9)
    if case == "stops":
        atol[0] = 0.9 * err[0].sum()  # the children's small errors bring tot_err below atol
        n[1] = cap - 2 * nb + 1  # one step, then no room for the next
        evals[2] = 1000.0 - 2 * nb * 33  # one step, then the budget is spent
    put = lambda a, dt=torch.float64: torch.as_tensor(a, dtype=dt)  # noqa: E731
    return tgm.GMPool(c=put(np.where(live[..., None], rng.random((L, cap, d)), 0.0)),
                      h=put(np.where(live[..., None], rng.random((L, cap, d)) * 0.1, 0.0)),
                      err=put(err), sd=put(np.where(live, rng.integers(0, d, (L, cap)), 0), torch.int32),
                      val=put(np.where(live, rng.normal(size=(L, cap)), 0.0)), n=put(n, torch.int64),
                      evals=put(evals), atol=put(atol), rtol=0.0, max_evals=1000.0 if case == "stops" else 1e9,
                      npts=33, active=torch.ones(L, dtype=torch.bool))


def _step_rule(cc, hh, active, live):
    """A deterministic stand-in for the rule: each child's value, error and
    splitdim from its centre and half, zeros on inactive lanes."""
    vol = torch.prod(2 * hh, dim=-1)
    val = torch.cos(cc.sum(-1)) * vol
    err = 1e-3 * torch.abs(torch.sin(3 * cc.sum(-1))) * vol
    sd = torch.argmax(hh * (1 + cc), dim=-1).to(torch.int32)
    on = active[:, None]
    return (torch.where(on, val, 0.0), torch.where(on, err, 0.0),
            torch.where(on, sd, torch.zeros((), dtype=torch.int32)))


@pytest.mark.parametrize("case", ["ties", "dead", "few_live", "stops"])
def test_step_route_equals_update_then_select(case):
    """A trip as the rule on the pending children and one K16 step (its
    plain route, which the CPU takes) against the trip as it was: select,
    the rule, update. Four trips on pools with planted ties, dead slots,
    fewer live boxes than nbisect, and lanes that stop in the step: the
    pools, picks and children stay identical, and a stopped lane gets zero
    children."""
    rng = np.random.default_rng({"ties": 1, "dead": 2, "few_live": 3, "stops": 4}[case])
    nb = 4
    step = _step_pool(rng, case, nb=nb)
    old = step.clone()
    tgm.gm_pool_begin(step, nb)
    tgm.gm_pool_totals_plain(old, nb)
    assert bool(step.active.all())
    k = tgm.box_kernels()
    fields = ("c", "h", "err", "sd", "val", "n", "evals", "active", "tot_val", "tot_err", "tol")
    for trip in range(4):
        idx, cc, hh = tgm.gm_pool_select_plain(old, nb)
        assert torch.equal(step.idx, idx) and torch.equal(step.cc, cc) and torch.equal(step.hh, hh)
        live = step.active.nonzero().squeeze(1)
        if live.numel() == 0:
            break
        tgm.gm_trip(step, _step_rule, nb, k, live)
        tgm.gm_pool_update_plain(old, nb, idx, cc, hh, *_step_rule(cc, hh, old.active, live))
        for name in fields:
            assert torch.equal(getattr(step, name), getattr(old, name)), (trip, name)
        if case == "stops" and trip == 0:
            assert not bool(step.active[:3].any()) and bool(step.active[3:].all())
            assert not bool(step.cc[:3].any()) and not bool(step.hh[:3].any())
    assert trip == 3 or case == "stops"


# a complex integrand whose fourth differences tie along no axis (KINDS'
# complex one ties, where rounding picks the split: ROADMAP C3)
STEP_KINDS = {"real": KINDS["real"],
              "complex": (lambda x, p: jnp.exp(1j * p * (x[..., 0] + 2 * x[..., 1])) * (1 + x[..., 0] ** 2),
                          lambda x, p: torch.exp(1j * p * (x[..., 0] + 2 * x[..., 1])) * (1 + x[..., 0] ** 2))}


@pytest.mark.parametrize("kind,abstol", [("real", 2e-6), ("complex", 1e-5)])
def test_step_route_solve_matches_reference_gm_adaptive(kind, abstol):
    """Lanes of gm_adaptive_lanes through the step route (the pool's start,
    then a rule and one step a trip) against the reference's gm_adaptive
    per lane: equal numevals and retcodes, values within 1e-12."""
    jf, tf = STEP_KINDS[kind]
    d, cap, nb = 2, 64, 4
    ps = [0.4, 1.3, 2.9]
    a, b = np.zeros(d), np.full(d, 1.5)
    want = [jgm.gm_adaptive(jf, p, a, b, cap=cap, nbisect=nb, abstol=abstol) for p in ps]
    rule_t = tgm.gm_rule_tensors(d, "cpu")
    P = rule_t[0].shape[0]

    def rule(cc, hh, active, live):
        if live is None:
            live = active.nonzero().squeeze(1)
        outs = {int(j): tgm.gm_box_eval_plain(tf, ps[int(j)], cc[j], hh[j], *rule_t) for j in live}
        proto = next(iter(outs.values()))
        full = [torch.zeros((len(ps),) + tuple(o.shape), dtype=o.dtype) for o in proto]
        for j, out in outs.items():
            for f, o in zip(full, out):
                f[j] = o
        return tuple(full)

    A = torch.as_tensor(np.tile(a, (len(ps), 1)))
    B = torch.as_tensor(np.tile(b, (len(ps), 1)))
    val, err, ne, conv = tgm.gm_adaptive_lanes(rule, A, B, abstol, cap=cap, nbisect=nb, npts=P,
                                               kernels=tgm.box_kernels())
    for j, (wv, we, wn, wc) in enumerate(want):
        _close(val[j].numpy(), np.asarray(wv))
        assert int(ne[j]) == int(wn) and bool(conv[j]) == bool(wc)
    assert not bool(conv.all()) and bool(conv.any())  # both kinds of lane


def _peak_j(x, p):
    return 1.0 / (p + jnp.sum(jnp.cos(x), axis=-1) ** 2)


def _peak_t(x, p):
    return 1.0 / (p + torch.sum(torch.cos(x), dim=-1) ** 2)


@pytest.mark.parametrize("maxiters", [None, 200])
def test_budget_truncates_as_the_reference(maxiters):
    """The reference's test_hcubature_budget_truncates: the peak at abstol
    1e-9 runs out of pool (1,023 trips, 139,145 evals) or of budget."""
    want = J.solve(J.IntegralProblem(_peak_j, J.HyperCube(np.zeros(2), np.full(2, 2 * np.pi)), 1e-3),
                   J.HCubatureJL(), abstol=1e-9, maxiters=maxiters)
    got = T.solve(T.IntegralProblem(_peak_t, T.HyperCube(np.zeros(2), np.full(2, 2 * np.pi)), 1e-3),
                  T.HCubatureJL(device="cpu"), abstol=1e-9, maxiters=maxiters)
    _same_solution(got, want)
    assert got.retcode is False and got.numevals == (139145 if maxiters is None else 289)


def test_integrand_undefined_at_the_origin():
    """The reference's case: one live box and three dead ones at the origin,
    where sqrt(x - 2) is NaN; the masked dead boxes keep the pool finite."""
    jf = lambda x, p: jnp.sqrt(x[..., 0] - 2.0) * jnp.sqrt(x[..., 1] - 2.0)  # noqa: E731
    tf = lambda x, p: torch.sqrt(x[..., 0] - 2.0) * torch.sqrt(x[..., 1] - 2.0)  # noqa: E731
    want = J.solve(J.IntegralProblem(jf, np.array([2.0, 2.0]), np.array([3.0, 3.0])), J.HCubatureJL(),
                   abstol=1e-8)
    got = T.solve(T.IntegralProblem(tf, np.array([2.0, 2.0]), np.array([3.0, 3.0])),
                  T.HCubatureJL(device="cpu"), abstol=1e-8)
    _same_solution(got, want)
    assert got.retcode and abs(float(got.u) - 4.0 / 9.0) < 1e-7


@pytest.mark.parametrize("dims", [1, 2, 3])
def test_fourier_consistency_matches_reference(dims):
    """test_fourier.py's HCubatureJL consistency case: a * s(x) + b over the
    unit cube at abstol 1e-8 (d = 1 runs Gauss-Kronrod on lifted scalars)."""
    def fj(v, a, b=None):
        return a * v.s + b

    def ft(v, a, b=None):
        return a * v.s + b

    js = J.FourierSeries(jtb.integer_lattice(dims), period=1.0, offset=(-1,) * dims)
    ts = T.FourierSeries(ttb.integer_lattice(dims), period=1.0, offset=(-1,) * dims, device="cpu")
    want = J.solve(J.IntegralProblem(J.FourierIntegrand(fj, js, 1.3, b=4.2),
                                     J.HyperCube(np.zeros(dims), np.ones(dims))),
                   J.HCubatureJL(), abstol=1e-8)
    got = T.solve(T.IntegralProblem(T.FourierIntegrand(ft, ts, 1.3, b=4.2),
                                    T.HyperCube(np.zeros(dims), np.ones(dims))),
                  T.HCubatureJL(device="cpu"), abstol=1e-8)
    _same_solution(got, want)


def test_interval_form_takes_scalars():
    """``IntegralProblem(f, a, b)`` is the reference's punctured interval: the
    integrand sees scalars (no lifting), through the 1-D Gauss-Kronrod pool."""
    want = J.solve(J.IntegralProblem(lambda x, p: 1.0 / (p - jnp.cos(x)), 0.0, 2 * np.pi, 1.5),
                   J.HCubatureJL(), abstol=1e-6)
    got = T.solve(T.IntegralProblem(lambda x, p: 1.0 / (p - torch.cos(x)), 0.0, 2 * np.pi, 1.5),
                  T.HCubatureJL(device="cpu"), abstol=1e-6)
    _same_solution(got, want)


@pytest.mark.parametrize("counter", [False, True])
@pytest.mark.parametrize("kind", ["FBZ", "InversionSymIBZ", "CubicSymIBZ"])
def test_tai_unit_measure(kind, counter):
    """TAI's unit measure, (2 pi)^3 to 1e-6, for a plain integrand and (the
    reference's test_fourier case) a FourierIntegrand, under EvalCounter;
    the cubic wedge's limits are not cubic, so TAI runs on the full zone."""
    vol = (2 * np.pi) ** 3
    jbz, tbz = J.load_bz(getattr(J, kind)(), np.eye(3)), T.load_bz(getattr(T, kind)(), np.eye(3))
    ja, ta = J.TAI(), T.TAI(device="cpu")
    if counter:
        ja, ta = J.EvalCounter(ja), T.EvalCounter(ta)
    want = J.solve(J.IntegralProblem(lambda x, p: jnp.asarray(1.0), jbz), ja)
    got = T.solve(T.IntegralProblem(lambda x, p: torch.ones(()), tbz), ta)
    _same_solution(got, want)
    assert abs(float(got.u) - vol) <= 1e-6 * vol

    s_j = J.FourierSeries(jtb.integer_lattice(3), period=1.0, offset=(-1,) * 3)
    s_t = T.FourierSeries(ttb.integer_lattice(3), period=1.0, offset=(-1,) * 3, device="cpu")
    jfi = J.FourierIntegrand(lambda v, a, b=None: jnp.real(a * v.s) + b, s_j, 0.0, b=1.0)
    tfi = T.FourierIntegrand(lambda v, a, b=None: torch.real(a * v.s) + b, s_t, 0.0, b=1.0)
    want = J.IntegralSolver(J.IntegralProblem(jfi, jbz), ja, reltol=0,
                            abstol=1e-6).solve_p(J.MixedParameters())
    got = T.IntegralSolver(T.IntegralProblem(tfi, tbz), ta, reltol=0,
                           abstol=1e-6).solve_p(T.MixedParameters())
    _same_solution(got, want)
    assert abs(float(got.u) - vol) <= 1e-5


@pytest.mark.parametrize("seed", [3, 7])
def test_bz_algorithms_agree_2d(seed):
    """test_bz_algorithms_agree_2d's TAI: a generic 2-band model, eta 0.8,
    omega 0.3, abstol 1e-5, through the fused DOS rule's plain version; the
    reference's value, count and retcode, and PTR's value within 5e-5."""
    jh = jtb.synthetic_wannier(2, nr=3, ndim=2, seed=seed)
    th = ttb.synthetic_wannier(2, nr=3, ndim=2, seed=seed, device="cpu")
    from autobzcore_tpu.models.observables import dos_integrand as jdi

    want = J.solve(J.IntegralProblem(jdi(jh, eta=0.8), J.load_bz(J.FBZ(), np.eye(2)), 0.3), J.TAI(),
                   abstol=1e-5)
    tbz = T.load_bz(T.FBZ(), np.eye(2))
    got = T.solve(T.IntegralProblem(tobs.dos_integrand(th, eta=0.8), tbz, 0.3), T.TAI(device="cpu"),
                  abstol=1e-5)
    _same_solution(got, want)
    ptr = T.solve(T.IntegralProblem(tobs.dos_integrand(th, eta=0.8), tbz, 0.3), T.PTR(device="cpu"))
    assert got.retcode and abs(float(got.u) - float(ptr.u)) <= 5e-5


def test_flagship_by_cubature_matches_reference():
    """The flagship's 3-band series at one frequency by HCubatureJL(cap=256)
    on the unit cube: the pool fills unconverged, as the reference's does."""
    js, ts = _flagship()
    want = J.solve(J.IntegralProblem(J.FourierIntegrand(jdos, js, eta=0.05),
                                     J.HyperCube(np.zeros(3), np.ones(3)), 0.5),
                   J.HCubatureJL(cap=256), abstol=1e-3)
    got = T.solve(T.IntegralProblem(T.FourierIntegrand(tobs.dos_trace, ts, eta=0.05),
                                    T.HyperCube(np.zeros(3), np.ones(3)), 0.5),
                  T.HCubatureJL(cap=256, device="cpu"), abstol=1e-3)
    _same_solution(got, want)
    assert got.numevals == 33 + 63 * 8 * 33 and got.retcode is False


def test_sweep_lanes_equal_solves_alone():
    """SweepSolver over TAI runs a chunk's frequencies as lanes of one box
    pool: each lane's value and count equal the solve alone and the
    reference's sweep (a converging 2-D DOS, and numevals per lane)."""
    from autobzcore_torch.parallel.sweep import SweepSolver, sweep_solve
    from autobzcore_tpu.models.observables import dos_integrand as jdi
    from autobzcore_tpu.parallel.sweep import sweep_solve as jsweep

    oms = np.array([-0.7, 0.3, 1.9])
    jh = jtb.synthetic_wannier(2, nr=3, ndim=2, seed=3)
    th = ttb.synthetic_wannier(2, nr=3, ndim=2, seed=3, device="cpu")
    tprob = T.IntegralProblem(tobs.dos_integrand(th, eta=0.8), T.load_bz(T.FBZ(), np.eye(2)))
    sw = SweepSolver(tprob, T.TAI(device="cpu"), abstol=1e-4, chunk=2, scan=True)
    d = sw(oms)
    alone = [T.solve(T.IntegralProblem(tobs.dos_integrand(th, eta=0.8), T.load_bz(T.FBZ(), np.eye(2)),
                                       om), T.TAI(device="cpu"), abstol=1e-4) for om in oms]
    np.testing.assert_array_equal(d, [float(s.u) for s in alone])
    np.testing.assert_array_equal(sw.lane_numevals, [s.numevals for s in alone])
    assert sw.retcode and sw.stats.syncs > 0
    ju, _, jconv, jne = jsweep(J.IntegralProblem(jdi(jh, eta=0.8), J.load_bz(J.FBZ(), np.eye(2))),
                               J.TAI(), jnp.asarray(oms), abstol=1e-4)
    _close(d, np.asarray(ju))
    np.testing.assert_array_equal(sw.lane_numevals, np.asarray(jne))
    tu, _, tconv, tne = sweep_solve(tprob, T.TAI(device="cpu"), oms, abstol=1e-4)
    np.testing.assert_array_equal(tne, np.asarray(jne))
    assert np.all(tconv) and np.all(np.asarray(jconv))


def test_custom_norm_and_entry_points():
    """Custom norms raise as elsewhere in the port; without device= TAI and
    HCubatureJL's plain solves place their data on the card, which they
    demand."""
    with pytest.raises(NotImplementedError, match="norm"):
        T.solve(T.IntegralProblem(lambda x, p: x[0], T.HyperCube(np.zeros(2), np.ones(2))),
                T.HCubatureJL(norm=lambda v: 0.0, device="cpu"))
    if torch.cuda.is_available():
        return
    with pytest.raises(RuntimeError, match="CUDA"):
        T.TAI()
    with pytest.raises(RuntimeError, match="CUDA"):
        T.solve(T.IntegralProblem(lambda x, p: x[0], T.HyperCube(np.zeros(2), np.ones(2))),
                T.HCubatureJL())
