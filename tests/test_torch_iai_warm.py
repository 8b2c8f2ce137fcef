"""Parity of the port's warm ``SweepSolver(warm=True)`` over IAI with the JAX
package's warm scan sweep on the CPU, on the models of the reference's own
warm tests: after every call the same values (1e-10), ``numevals``,
per-chunk evaluations and seeds, retcode, carried pool and library keys.

The frequencies avoid the points where the integrand's symmetry makes two
intervals' errors equal in exact arithmetic (omega = 0 of the integer
lattices): there the first bisection follows rounding, which differs between
the packages (ROADMAP section C)."""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import autobzcore_torch as T
import autobzcore_tpu as J
from autobzcore_torch.interop import pool_from_arrays, pool_to_arrays
from autobzcore_torch.models import observables as tobs
from autobzcore_torch.models import tight_binding as ttb
from autobzcore_torch.parallel.sweep import SweepSolver
from autobzcore_torch.parameters import LaneParams
from autobzcore_torch.utils.chebinterp import hchebinterp
from autobzcore_tpu.models import observables as jobs
from autobzcore_tpu.models import tight_binding as jtb
from autobzcore_tpu.parallel.sweep import SweepSolver as JSweepSolver
from autobzcore_tpu.parameters import merge_parameters as jmerge
from autobzcore_tpu.utils.chebinterp import hchebinterp as jhchebinterp

torch.set_num_threads(2)


def _probs(d, obs, eta, kind="FBZ"):
    bz = lambda P: P.load_bz(getattr(P, kind)(), 2 * np.pi * np.eye(d))  # noqa: E731
    jprob = J.IntegralProblem(J.FourierIntegrand(getattr(jobs, obs), jtb.tb_integer(d), eta=eta), bz(J))
    tprob = T.IntegralProblem(T.FourierIntegrand(getattr(tobs, obs), ttb.tb_integer(d, device="cpu"),
                                                 eta=eta), bz(T))
    return jprob, tprob


def _sweeps(d, obs, eta, abstol, chunk, kind="FBZ", warm_lib=12, **alg):
    jprob, tprob = _probs(d, obs, eta, kind)
    jsw = JSweepSolver(jprob, J.IAI(**alg), abstol=abstol, chunk=chunk, scan=True, warm=True,
                       warm_lib=warm_lib)
    tsw = SweepSolver(tprob, T.IAI(device="cpu", **alg), abstol=abstol, chunk=chunk, scan=True,
                      warm=True, warm_lib=warm_lib)
    return jsw, tsw


def _assert_same_pool(got, want):
    """A carried pool: live counts equal, endpoints within 1e-15."""
    got = pool_to_arrays(got)
    assert len(got) == len(want) and got[3] == int(want[3])
    for k in (0, 1):
        assert np.max(np.abs(got[k] - np.asarray(want[k]))) <= 1e-15
    if len(want) > 4:
        assert got[4][3] == int(want[4][3])
        for k in (0, 1):
            assert np.max(np.abs(got[4][k] - np.asarray(want[4][k]))) <= 1e-15


def _call_both(jsw, tsw, xs):
    want, got = np.asarray(jsw(jnp.asarray(xs))), tsw(xs)
    assert got.shape == want.shape == (len(xs),)
    assert np.max(np.abs(got - want)) <= 1e-10 * np.max(np.abs(want))
    assert tsw.numevals == jsw.numevals and tsw.retcode == jsw.retcode is True
    assert tsw.chunk_evals == jsw.chunk_evals
    assert tsw.chunk_meta == jsw.chunk_meta
    assert [x for x, _ in tsw._pool_lib] == [x for x, _ in jsw._pool_lib]
    _assert_same_pool(tsw._pool, jsw._pool)
    return got


@pytest.mark.parametrize("obs", ["greens_function_trace", "dos_trace"])
def test_warm_sweep_1d_matches_reference(obs):
    """No mid seed and no harvest: the outer pool alone, coarsened and seeded
    warm_width-wide; dos_trace runs the fused leaf (K4's plain version),
    which counts the seed chunks' dead slots as the reference does."""
    jsw, tsw = _sweeps(1, obs, 0.1, 1e-6, 4, warm_width=8)
    _call_both(jsw, tsw, np.array([-1.93, -1.37, -0.61, 0.17, 0.83, 1.54, 1.91]))
    _call_both(jsw, tsw, np.array([-1.71, -1.18]))
    assert tsw._pool.mid is None and tsw._harvest is None and len(jsw._pool) == 4
    assert tsw.stats.seed_trips[1] > 0


@pytest.mark.parametrize("warm_lib", [12, 1])
def test_warm_sweep_2d_matches_reference(warm_lib):
    """Two chunks, then a call that jumps back and seeds from the library
    (strictly nearer than the carried pool); warm_lib = 1 keeps one entry,
    replaced by each newcomer."""
    jsw, tsw = _sweeps(2, "dos_trace", 0.1, 1e-4, 4, warm_lib=warm_lib, inner_cap=64, inner_nbisect=2)
    _call_both(jsw, tsw, np.array([-2.9, -2.15, -1.3, -0.45, 0.35, 1.2, 2.05]))
    _call_both(jsw, tsw, np.array([-2.7, -2.5, -2.2, -1.95]))
    x0, _, seed_d = tsw.chunk_meta[2]
    assert len(tsw._pool_lib) == min(warm_lib, 3)
    if warm_lib > 1:  # the library's first entry (-0.45), not the carried 2.05
        assert x0 == -2.7 and seed_d == pytest.approx(2.25)
    assert tsw._pool.mid.tn > 0 and set(tsw.stats.seed_trips) == {1, 2}


@pytest.mark.parametrize("kind", ["FBZ", "CubicSymIBZ"])
def test_warm_sweep_3d_matches_reference(kind):
    """Three levels: the outer pool coarsened, the mid pools seeded from the
    carried partition (per-lane [0, x] on the wedge), the leaf cold (K4's
    plain version); pads solved in the chain and excluded from the counts."""
    jsw, tsw = _sweeps(3, "dos_trace", 0.5, 1e-3, 3, kind=kind, inner_cap=32, inner_nbisect=2)
    _call_both(jsw, tsw, np.array([-2.3, -1.1, 0.35, 1.45]))
    _call_both(jsw, tsw, np.array([-1.8, 0.9]))
    assert set(tsw.stats.seed_trips) == {2, 3}


@pytest.mark.parametrize("x0", [1.4, 1.9, 0.5, -3.0, np.nan, np.inf])
@pytest.mark.parametrize("carried", [True, False])
def test_seed_selection_matches_reference(carried, x0):
    """The chunk seed: the nearest of the carried pool and the library, the
    carried pool on ties; with no candidate strictly nearer than inf (a
    non-finite key), the carried pool if there is one, else the cold pool."""
    jsw, tsw = _sweeps(1, "greens_function_trace", 0.1, 1e-6, 4)
    names = {}
    for sw in (jsw, tsw):
        sw._pool, sw._pool_x = ("carried", 1.0) if carried else (None, None)
        sw._pool_lib = [(0.0, "lib0"), (2.0, "lib1")]
        names[id(sw._pool0)] = "cold"
    pick = lambda sw: sw._select_seed(x0)  # noqa: E731
    (jp, jd), (tp, td) = pick(jsw), pick(tsw)
    assert names.get(id(tp), tp) == names.get(id(jp), jp)
    assert td == jd or (np.isnan(td) and np.isnan(jd))
    if not np.isfinite(x0):
        assert td == np.inf and (tp == "carried" if carried else tp is tsw._pool0)


def test_one_warm_solve_from_a_shared_pool():
    """Both packages seeded from the same pool (interop): one warm solve and
    one harvest give the same value, counts and pools."""
    jprob, tprob = _probs(2, "dos_trace", 0.1)
    jalg, talg = J.IAI(inner_cap=64, inner_nbisect=2), T.IAI(inner_cap=64, inner_nbisect=2, device="cpu")
    jc, tc = J.init(jprob, jalg), T.init(tprob, talg)
    jfn, jpool0 = jalg.solve_fn_warm(jc.cacheval)
    tfn, _ = talg.solve_fn_warm(tc.cacheval)
    jpool = tuple(jax.tree_util.tree_map(jnp.asarray, tuple(jpool0)))
    jpool = jfn(jmerge(jc.p, -0.8), 1e-4, 0.0, jpool)[4]
    jpool = jalg.harvest_fn(jc.cacheval)(jmerge(jc.p, -0.8), 1e-4, 0.0, jpool)[0]
    shared = jax.tree_util.tree_map(np.asarray, jpool)
    p = LaneParams(tc.p, torch.tensor([-0.6], dtype=torch.float64), True)
    want = jfn(jmerge(jc.p, -0.6), 1e-4, 0.0, jpool)
    got = tfn(p, 1e-4, 0.0, pool_from_arrays(shared, device="cpu"))
    assert abs(float(got[0][0]) - float(np.asarray(want[0]))) <= 1e-10 * abs(float(np.asarray(want[0])))
    assert int(got[3][0]) == int(want[3])
    _assert_same_pool(got[4], want[4])
    wh = jalg.harvest_fn(jc.cacheval)(jmerge(jc.p, -0.6), 1e-4, 0.0, want[4])
    th = talg.harvest_fn(tc.cacheval)(p, 1e-4, 0.0, got[4])
    assert float(th[1][0]) == float(wh[1])
    _assert_same_pool(th[0], wh[0])


def test_warm_sweep_through_a_tied_point_stays_within_the_certificate():
    """Through omega = 0 of the 2-D lattice, where rounding decides which of
    two mirror intervals is bisected first: the carried partitions may
    differ from the reference's from there on, the values stay within the
    two certificates."""
    jsw, tsw = _sweeps(2, "dos_trace", 0.1, 1e-4, 4, inner_cap=64, inner_nbisect=2)
    for xs in (np.linspace(-3.0, 3.0, 7), np.linspace(-2.9, -2.0, 4)):
        want, got = np.asarray(jsw(jnp.asarray(xs))), tsw(xs)
        assert np.max(np.abs(got - want)) <= 2e-4
        assert tsw.retcode is jsw.retcode is True


def test_warm_canary_matches_reference():
    """The reference's warm canary (``bench.py:257-276``): 2-D tb_integer,
    eta 0.1, 64 omegas in chunks of 16, abstol 1e-5, cold and warm, with the
    reference's counts; warm/cold 0.6633 and max |warm - cold| 5.5e-6 are the
    figures ``BENCH_r05.json`` recorded."""
    jprob, tprob = _probs(2, "dos_trace", 0.1)
    oms = np.linspace(-3.0, 3.0, 64)
    out = {}
    for warm in (False, True):
        kw = dict(abstol=1e-5, chunk=16, scan=True, warm=warm)
        jsw = JSweepSolver(jprob, J.IAI(inner_cap=64, inner_nbisect=2), **kw)
        tsw = SweepSolver(tprob, T.IAI(inner_cap=64, inner_nbisect=2, device="cpu"), **kw)
        want, got = np.asarray(jsw(jnp.asarray(oms))), tsw(oms)
        assert np.max(np.abs(got - want)) <= 1e-10 * np.max(np.abs(want))
        assert tsw.numevals == jsw.numevals and tsw.retcode is True
        out[warm] = (tsw.numevals, got)
    assert round(out[True][0] / out[False][0], 4) == 0.6633
    assert round(float(np.max(np.abs(out[True][1] - out[False][1]))), 7) == 5.5e-6


def test_interpolated_warm_curve_matches_reference():
    """hchebinterp over a 2-D warm sweep: the reference's panels, frequency
    count and numevals."""
    jsw, tsw = _sweeps(2, "dos_trace", 0.3, 1e-3, 33, inner_cap=32, inner_nbisect=2)
    want = jhchebinterp(jsw, -4.1, 3.7, atol=1e-2)
    got = hchebinterp(tsw, -4.1, 3.7, atol=1e-2)
    assert [(p.a, p.b) for p in got.panels] == [(p.a, p.b) for p in want.panels]
    assert got.numevals == want.numevals
    assert tsw.numevals == jsw.numevals and tsw.retcode == jsw.retcode is True
    assert tsw.chunk_evals == jsw.chunk_evals
    ws = np.linspace(-4.1, 3.7, 101)
    assert np.max(np.abs(got(ws) - np.asarray(want(ws)))) <= 1e-10 * np.max(np.abs(got(ws)))
