"""Parity of the port's warm-start pools with the JAX package on the CPU:
the coarsening (K6's plain version) bit for bit, the mid-seed remap, and the
seeded single-pool ``gk_adaptive`` against the reference's."""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from autobzcore_torch.algorithms import nested as tnest
from autobzcore_torch.ops import adaptive as tad
from autobzcore_tpu.algorithms import nested as jnest
from autobzcore_tpu.ops import adaptive as jad
from torch_parity import ERROR_KINDS, dyadic_pool

torch.set_num_threads(2)

SEGS = ([0.0, 1.0], [0.0, 0.3, 1.0], [0.0, 0.125, 0.5])


@pytest.mark.parametrize("kind", ERROR_KINDS)
@pytest.mark.parametrize("cap", [64, 2048])
def test_coarsen_is_the_reference_bit_for_bit(cap, kind):
    """Every breakpoint set and two tolerances, three pools each: the same
    a2, b2 and n2 as ``coarsen_pool``, here all lanes in one call."""
    rng = np.random.default_rng(cap + ERROR_KINDS.index(kind))
    for segs in SEGS:
        pools = [dyadic_pool(rng, cap, segs, int(rng.integers(3, cap // 2)), kind) for _ in range(3)]
        tols = [1e-6, 1e-3, 10 ** rng.uniform(-8, -2)]
        want = [jad.coarsen_pool(jnp.asarray(a), jnp.asarray(b), jnp.asarray(e), jnp.int32(n),
                                 jnp.asarray(segs), jnp.float64(t)) for (a, b, e, n), t in zip(pools, tols)]
        a, b, e = (torch.as_tensor(np.stack([p[k] for p in pools])) for k in range(3))
        n = torch.tensor([p[3] for p in pools])
        got = tad.coarsen_pool(a, b, e, n, torch.tensor(segs, dtype=torch.float64),
                               torch.tensor(tols, dtype=torch.float64))
        for i, (wa, wb, wn) in enumerate(want):
            np.testing.assert_array_equal(got[0][i].numpy(), np.asarray(wa))
            np.testing.assert_array_equal(got[1][i].numpy(), np.asarray(wb))
            assert int(got[2][i]) == int(wn)


def test_coarsen_cap_pressure_case_of_the_reference():
    """The reference's own cap-pressure case: 32 noise-floored intervals
    keep all 32; with all but 4 quiet, the cheapest siblings merge and the
    survivors still tile [0, 1]."""
    n, cap = 32, 64
    edges = np.linspace(0.0, 1.0, n + 1)
    a, b = np.zeros(cap), np.zeros(cap)
    a[:n], b[:n] = edges[:-1], edges[1:]
    for e_live in (np.full(n, 1e-8), np.r_[np.full(4, 1e-7), np.full(n - 4, 1e-12)]):
        e = np.zeros(cap)
        e[:n] = e_live
        want = jad.coarsen_pool(jnp.asarray(a), jnp.asarray(b), jnp.asarray(e), jnp.int32(n),
                                jnp.asarray([0.0, 1.0]), jnp.float64(1e-6))
        got = tad.coarsen_pool(*(torch.as_tensor(x)[None] for x in (a, b, e)), torch.tensor([n]),
                               torch.tensor([0.0, 1.0], dtype=torch.float64),
                               torch.tensor([1e-6], dtype=torch.float64))
        n2 = int(got[2][0])
        assert n2 == int(want[2]) and np.array_equal(got[0][0].numpy(), np.asarray(want[0]))
        aa, bb = got[0][0, :n2].numpy(), got[1][0, :n2].numpy()
        assert aa[0] == 0.0 and bb[-1] == 1.0 and np.array_equal(bb[:-1], aa[1:])
    assert n2 < n


def test_mid_seed_remap_is_the_reference_per_lane():
    """A carried partition onto per-lane inner domains (the wedge's [0, x]),
    junk past tn masked, the cold sentinel, and the normalization back."""
    cap = 8
    ta, tb, te = np.zeros(cap), np.zeros(cap), np.zeros(cap)
    ta[:3], tb[:3], te[:3] = [0.0, 1 / 3, 2 / 3], [1 / 3, 2 / 3, 1.0], [1e-6, 2e-6, 3e-6]
    ta[3:], tb[3:] = 0.4, 0.9  # junk
    segs = np.array([[0.0, 0.37], [2.0, 6.0], [0.0, 0.5]])
    for tn in (3, 0):
        got, n_host = tnest._mid_seed_pool(
            tnest.MidSeed(*(torch.as_tensor(x) for x in (ta, tb, te)), tn), torch.as_tensor(segs))
        assert n_host == (3 if tn else 1)
        for i, s in enumerate(segs):
            want = jnest._mid_seed_pool((jnp.asarray(ta), jnp.asarray(tb), jnp.asarray(te), jnp.int32(tn)),
                                        jnp.asarray(s))
            for g, w in zip(got[:3], want[:3]):
                np.testing.assert_allclose(g[i].numpy(), np.asarray(w), rtol=0, atol=1e-15)
            assert int(got[3][i]) == int(want[3])
    state = tad.GKPool(a=got[0][1:2], b=got[1][1:2], err=got[2][1:2], l1=None, val=None, n=got[3][1:2],
                       evals=None, atol=None, rtol=0.0, max_evals=0.0)
    back = tnest._mid_seed_norm(state, torch.as_tensor(segs[1:2]))
    want = jnest._mid_seed_norm((jnp.asarray(got[0][1].numpy()), jnp.asarray(got[1][1].numpy()), None,
                                 jnp.asarray(got[2][1].numpy()), None, 1), jnp.asarray(segs[1]))
    for g, w in zip(back[:3], want[:3]):
        np.testing.assert_allclose(g.numpy(), np.asarray(w), rtol=0, atol=1e-15)
    assert back.tn == 1


def _jf(xs, p):
    return 1.0 / ((xs[:, 0] - p) ** 2 + 1e-3) + jnp.sin(7 * xs[:, 0]), jnp.full(xs.shape[:1], 3)


def _tf(xs, p):
    return 1.0 / ((xs[:, 0] - p) ** 2 + 1e-3) + torch.sin(7 * xs[:, 0]), torch.full(xs.shape[:1], 3.0,
                                                                                  dtype=torch.float64)


@pytest.mark.parametrize("seed_width", [None, 8])
@pytest.mark.parametrize("seed_coarsen", [True, False])
def test_seeded_single_pool_matches_reference(seed_width, seed_coarsen):
    """A pool left by a solve at p = 0.3 seeds a solve at p = 0.77, counts
    per node (stats) and a lifted node builder: the reference's numevals,
    final pool and value."""
    kw = dict(stats=True, node_builder=lambda x: x[:, None], cap=128, nbisect=2, abstol=1e-9)
    segs = [0.0, 0.5, 1.0]
    st = jad.gk_adaptive(_jf, 0.3, jnp.asarray(segs), _return_state=True, **kw)[4]
    pool = (np.asarray(st[0]), np.asarray(st[1]), np.asarray(st[3]), int(st[5]))
    want = jad.gk_adaptive(_jf, 0.77, jnp.asarray(segs), init_pool=tuple(jnp.asarray(x) for x in pool),
                           seed_width=seed_width, seed_coarsen=seed_coarsen, _return_state=True, **kw)
    got = tad.gk_adaptive(_tf, 0.77, segs, init_pool=pool, seed_width=seed_width,
                          seed_coarsen=seed_coarsen, _return_state=True, **kw)
    assert float(got[2]) == float(want[2]) and bool(got[3]) == bool(want[3]) is True
    assert abs(float(got[0]) - float(want[0])) <= 1e-12 * abs(float(want[0]))
    assert int(got[4][5]) == int(want[4][5])
    for k in (0, 1):  # endpoints: the same bisections of the same seed
        np.testing.assert_array_equal(got[4][k].numpy(), np.asarray(want[4][k]))
    # error estimates are differences of the two rules: held at the value's scale
    assert np.max(np.abs(got[4][3].numpy() - np.asarray(want[4][3]))) <= 1e-12 * abs(float(want[0]))


def test_seed_chunks_count_dead_slots_and_overlap():
    """n0 = 5 intervals at C = 4: two chunks (slots 0-3, then 4-7 with 3
    dead slots), 8 x 15 evaluations; at cap 6 the second chunk starts at 2
    and re-evaluates slots 2-3, 8 x 15 again."""
    segs = [0.0, 1.0]
    a = np.array([0.0, 0.25, 0.5, 0.625, 0.75, 0, 0, 0])
    b = np.array([0.25, 0.5, 0.625, 0.75, 1.0, 0, 0, 0])
    e = np.full(8, np.inf)

    def plain(xs, p):
        return torch.cos(xs)

    for cap in (8, 6):
        pool = (a[:cap], b[:cap], e[:cap], 5)
        out = tad.gk_adaptive(plain, None, segs, init_pool=pool, seed_width=4, seed_coarsen=False,
                              cap=cap, nbisect=1, abstol=1.0, _return_state=True)
        want = jad.gk_adaptive(lambda xs, p: jnp.cos(xs), None, jnp.asarray(segs),
                               init_pool=tuple(jnp.asarray(x) for x in pool[:3]) + (jnp.int32(5),),
                               seed_width=4, seed_coarsen=False, cap=cap, nbisect=1, abstol=1.0)
        assert float(out[2]) == float(want[2]) == 8 * 15
        assert abs(float(out[0]) - np.sin(1.0)) <= 1e-14
