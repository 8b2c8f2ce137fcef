"""The kernel wrappers: what they take and refuse, and on a CUDA card each
kernel against its plain PyTorch version.

This file imports no JAX, so the card tests run where JAX is not installed:

    python -m pytest --noconftest -m gpu tests/test_torch_cuda.py

Without a card the ``gpu`` tests skip.
"""
import numpy as np
import pytest
import torch

import autobzcore_torch as T
from autobzcore_torch.models import observables as tobs
from autobzcore_torch.models import tight_binding as ttb
from autobzcore_torch.ops.fourier_eval import fourier_points, fourier_points_plain
from autobzcore_torch.parallel.sweep import SweepSolver
from torch_parity import cuda_device, random_hermitian, rel_err  # noqa: F401  (cuda_device is a fixture)

torch.set_num_threads(2)


def test_fourier_wrapper_takes_plain_version_on_cpu_without_counting():
    s = ttb.flagship_series(device="cpu")
    X = torch.rand(40, 3, dtype=torch.float64)
    before = fourier_points.launches
    got = fourier_points(s.c, X, s.offset, s.period)
    assert fourier_points.launches == before
    assert torch.equal(got, fourier_points_plain(s.c, X, s.offset, s.period))


def test_fourier_wrapper_rejects_what_the_kernel_does_not_take():
    s = ttb.flagship_series(device="cpu")
    with pytest.raises(ValueError):
        fourier_points(s.c, torch.rand(4, 3, dtype=torch.float32), s.offset, s.period)
    with pytest.raises(ValueError):
        fourier_points(s.c, torch.rand(4, 4, dtype=torch.float64), s.offset, s.period)
    with pytest.raises(ValueError):
        fourier_points(s.c, torch.rand(3, 4, dtype=torch.float64).T, s.offset, s.period)
    with pytest.raises(ValueError):
        fourier_points(s.c.to(torch.complex64), torch.rand(4, 3, dtype=torch.float64),
                       s.offset, s.period)


def test_dos_wrapper_checks_its_inputs():
    H = torch.as_tensor(random_hermitian(np.random.default_rng(0), 8, 3))
    w = torch.ones(8, dtype=torch.float64)
    om = torch.zeros(5, dtype=torch.float64)
    before = tobs.dos_trace_weighted_sum.launches
    tobs.dos_trace_weighted_sum(H, w, om, om + 0.1, 1.0)
    assert tobs.dos_trace_weighted_sum.launches == before  # CPU: plain version, no launch
    with pytest.raises(ValueError):
        tobs.dos_trace_weighted_sum(H.to(torch.complex64), w, om, om + 0.1, 1.0)
    with pytest.raises(ValueError):
        tobs.dos_trace_weighted_sum(H, w[:7], om, om + 0.1, 1.0)
    with pytest.raises(ValueError):
        tobs.dos_trace_weighted_sum(H, w, om, om[:4] + 0.1, 1.0)


def _random_series(dev, box, vshape, offset, period, seed):
    """A series-like record of random coefficients (box + vshape) with the
    given offsets and periods."""
    from types import SimpleNamespace

    rng = np.random.default_rng(seed)
    shape = tuple(box) + tuple(vshape)
    c = torch.as_tensor(rng.normal(size=shape) + 1j * rng.normal(size=shape), device=dev)
    return SimpleNamespace(c=c, sndim=len(box), offset=tuple(offset), period=tuple(period))


@pytest.mark.gpu
@pytest.mark.parametrize("build", [
    lambda dev: ttb.tb_integer(1, device=dev),
    lambda dev: ttb.tb_graphene(device=dev),
    # an 11^3 box of 4x4 values: several coefficient tiles and value passes
    lambda dev: ttb.synthetic_wannier(4, nr=11, seed=3, device=dev),
    # the tensor-core tiles' edges: 105 rows (no whole k-slab), V = 1,
    # negative offsets
    lambda dev: _random_series(dev, (3, 5, 7), (), (-1, -2, -3), (1.0, 0.7, 1.3), 1),
    # V = 4 (one n8 tile of four outputs)
    lambda dev: _random_series(dev, (5, 5, 5), (2, 2), (-2, -2, -2), (1.0, 1.0, 1.0), 2),
    # V = 900 (25 column tiles of 36 outputs) in 2-D
    lambda dev: _random_series(dev, (3, 3), (30, 30), (-1, -1), (1.0, 1.0), 3),
    # a 1-D series of 9 frequencies, negative offset, V = 3 (a ragged n8 tile)
    lambda dev: _random_series(dev, (9,), (3,), (-4,), (2.5,), 4),
], ids=["1d", "2d", "3d_m4_nr11", "3d_n357_v1", "3d_v4", "2d_v900", "1d_n9_v3"])
def test_fourier_kernel_matches_plain_on_card(cuda_device, build):
    s = build(cuda_device)
    X = torch.rand(5001, s.sndim, dtype=torch.float64, device=cuda_device)  # a ragged last block
    before = fourier_points.launches
    got = fourier_points(s.c, X, s.offset, s.period)
    assert fourier_points.launches == before + 1
    want = fourier_points_plain(s.c, X, s.offset, s.period)
    assert float((got - want).abs().max() / want.abs().max()) <= 1e-12
    assert torch.equal(got, fourier_points(s.c, X, s.offset, s.period))
    # a point's value does not depend on its place in the launch (the
    # nest's lanes, solved alone or in a chunk, count on it)
    assert torch.equal(got[37:], fourier_points(s.c, X[37:].contiguous(), s.offset, s.period))


@pytest.mark.gpu
@pytest.mark.parametrize("m", [1, 2, 3])
def test_dos_kernel_matches_plain_on_card(cuda_device, m):
    rng = np.random.default_rng(m)
    K = 10_000  # several k-chunks of the kernel
    H = torch.as_tensor(random_hermitian(rng, K, m), device=cuda_device)
    w = torch.as_tensor(rng.random(K) + 0.5, device=cuda_device)
    om = torch.linspace(-3, 3, 45, dtype=torch.float64, device=cuda_device)  # a ragged lane tile
    eta = torch.full_like(om, 0.05)
    before = tobs.dos_trace_weighted_sum.launches
    got = tobs.dos_trace_weighted_sum(H, w, om, eta, 0.5)
    assert tobs.dos_trace_weighted_sum.launches == before + 1
    want = tobs.dos_trace_weighted_sum_plain(H, w, om, eta, 0.5)
    assert float((got - want).abs().max() / want.abs().max()) <= 1e-10
    assert torch.equal(got, tobs.dos_trace_weighted_sum(H, w, om, eta, 0.5))


@pytest.mark.gpu
def test_dos_kernel_refuses_more_than_three_bands(cuda_device):
    """K2 itself refuses m > 3; the wrapper sends such sums to the
    eigenvalue form (eigvalsh in chunks, then K8, one launch per eta)."""
    from autobzcore_torch.ops import grid_sweep as gsw
    from autobzcore_torch.ops.cuda_lib import load_kernels

    H = torch.as_tensor(random_hermitian(np.random.default_rng(0), 8, 4), device=cuda_device)
    w = torch.ones(8, dtype=torch.float64, device=cuda_device)
    om = torch.zeros(3, dtype=torch.float64, device=cuda_device)
    part = torch.empty((1, 3), dtype=torch.float64, device=cuda_device)
    out = torch.empty(3, dtype=torch.float64, device=cuda_device)
    rc = load_kernels().dos_trace_weighted_sum_launch(
        H.data_ptr(), w.data_ptr(), om.data_ptr(), om.data_ptr(), part.data_ptr(), out.data_ptr(),
        8, 3, 4, 1.0, 0, torch.cuda.current_stream(cuda_device).cuda_stream)
    assert rc != 0
    before = (tobs.dos_trace_weighted_sum.launches, gsw.lorentzian_sum.launches)
    eta = torch.tensor([0.1, 0.2, 0.1], dtype=torch.float64, device=cuda_device)
    got = tobs.dos_trace_weighted_sum(H, w, om, eta, 1.0)
    assert (tobs.dos_trace_weighted_sum.launches, gsw.lorentzian_sum.launches) == (before[0], before[1] + 2)
    want = tobs.dos_trace_weighted_sum_plain(H, w, om, eta, 1.0)
    assert float((got - want).abs().max() / want.abs().max()) <= 1e-10


@pytest.mark.gpu
@pytest.mark.parametrize("kind,model", [("FBZ", ttb.flagship_series),
                                        ("CubicSymIBZ", lambda device: ttb.tb_integer(3, device=device))])
def test_sweep_on_card_matches_cpu(cuda_device, kind, model):
    xs = np.linspace(-6, 7, 100)
    out = []
    for dev in ("cpu", cuda_device):
        prob = T.IntegralProblem(tobs.dos_integrand(model(device=dev), 0.2),
                                 T.load_bz(getattr(T, kind)(), np.eye(3)))
        out.append(SweepSolver(prob, T.PTR(npt=16, device=dev), chunk=64)(xs))
    assert rel_err(out[1], out[0]) <= 1e-10


@pytest.mark.gpu
def test_kernels_take_edge_shapes(cuda_device):
    s = ttb.flagship_series(device=cuda_device)
    empty = fourier_points(s.c, torch.empty((0, 3), dtype=torch.float64, device=cuda_device),
                           s.offset, s.period)
    assert empty.shape == (0, 3, 3)
    rng = np.random.default_rng(4)
    for K, W in ((0, 5), (4097, 1), (1, 33)):  # no k; one k past a chunk; one k, a lane past a tile
        H = torch.as_tensor(random_hermitian(rng, K, 3), device=cuda_device)
        w = torch.ones(K, dtype=torch.float64, device=cuda_device)
        om = torch.linspace(-1, 1, W, dtype=torch.float64, device=cuda_device)
        eta = torch.full_like(om, 0.1)
        got = tobs.dos_trace_weighted_sum(H, w, om, eta, 1.0)
        want = tobs.dos_trace_weighted_sum_plain(H, w, om, eta, 1.0)
        assert got.shape == (W,)
        assert torch.allclose(got, want, rtol=1e-12, atol=1e-300)


# --- the nest's kernels: K3 fourier_contract, K4 gk_leaf_dos, K5 the pool step ---
from autobzcore_torch.ops import adaptive as tad  # noqa: E402
from autobzcore_torch.ops.fourier_eval import fourier_contract, fourier_contract_plain  # noqa: E402


def _flat_coeffs(s):
    """(1, n_1..n_d, V) coefficients of a series, value axes flattened."""
    return s.c.reshape((1,) + tuple(s.c.shape[:s.sndim]) + (-1,)).contiguous()


def test_nest_wrappers_take_plain_versions_on_cpu_without_counting():
    s = ttb.flagship_series(device="cpu")
    c = _flat_coeffs(s)
    cmap = torch.zeros(3, dtype=torch.int64)
    x = torch.rand(3, 4, dtype=torch.float64)
    before = fourier_contract.launches
    got = fourier_contract(c, cmap, x, s.offset[-1], s.period[-1])
    assert fourier_contract.launches == before
    assert torch.equal(got, fourier_contract_plain(c, cmap, x, s.offset[-1], s.period[-1]))
    with pytest.raises(ValueError):
        fourier_contract(c, cmap, x.to(torch.float32), s.offset[-1], s.period[-1])
    with pytest.raises(ValueError):
        fourier_contract(c, cmap[:2], x, s.offset[-1], s.period[-1])
    with pytest.raises(ValueError):
        fourier_contract(c.to(torch.complex64), cmap, x, s.offset[-1], s.period[-1])


@pytest.mark.gpu
def test_default_device_is_the_card(cuda_device):
    assert ttb.flagship_series().c.device.type == "cuda"
    assert T.FourierSeries(np.ones((3, 1, 1)), offset=-1, ndim=1).c.device.type == "cuda"
    assert T.PTR().device.type == "cuda" and T.IAI().device.type == "cuda"


@pytest.mark.gpu
def test_contract_kernel_matches_plain_on_card(cuda_device):
    """The flagship at 30 outer nodes of two lanes, then 900 mid contractions
    of the results, then 1-D values; and an 11-wide axis of 4x4 values."""
    rng = np.random.default_rng(11)
    s = ttb.flagship_series(device=cuda_device)
    c = _flat_coeffs(s)
    c3 = torch.cat([c, 2 * c], dim=0)
    cmap = torch.as_tensor(rng.integers(0, 2, 30), device=cuda_device)
    stages = [(c3, cmap, torch.as_tensor(rng.random((30, 15)), device=cuda_device), -2)]
    before = fourier_contract.launches
    for _ in range(2):
        cc, cm, x, o = stages[-1]
        got = fourier_contract(cc, cm, x, o, 1.0)
        want = fourier_contract_plain(cc, cm, x, o, 1.0)
        assert float((got - want).abs().max()) <= 1e-12 * float(cc.abs().max())
        c2 = got.reshape((-1,) + tuple(got.shape[2:]))
        stages.append((c2, torch.arange(c2.shape[0], device=cuda_device),
                       torch.as_tensor(rng.random((c2.shape[0], 2)), device=cuda_device), -2))
    assert stages[2][0].shape == (900, 5, 9)
    cc, cm, x, o = stages[-1]
    got = fourier_contract(cc, cm, x, o, 1.0)
    assert got.shape == (900, 2, 9)
    want = fourier_contract_plain(cc, cm, x, o, 1.0)
    assert float((got - want).abs().max()) <= 1e-12 * float(cc.abs().max())
    assert fourier_contract.launches == before + 3
    w = ttb.synthetic_wannier(4, nr=11, seed=3, device=cuda_device)
    cw = _flat_coeffs(w)
    cmw = torch.zeros(7, dtype=torch.int64, device=cuda_device)
    xw = torch.as_tensor(rng.uniform(-1, 2, (7, 5)), device=cuda_device)
    got = fourier_contract(cw, cmw, xw, w.offset[-1], w.period[-1])
    want = fourier_contract_plain(cw, cmw, xw, w.offset[-1], w.period[-1])
    assert float((got - want).abs().max()) <= 1e-12 * float(cw.abs().max())


@pytest.mark.gpu
@pytest.mark.parametrize("Lc,L,J,rows,n,V,bad", [
    (1, 1, 30, (5, 5), 5, 9, False),  # one lane: the nodes spread over blocks
    (1, 33, 30, (5, 5), 5, 9, False),  # the outer level: 33 lanes on one cmap entry
    (4, 990, 1, (5,), 5, 9, False),  # J = 1
    (4, 50, 7, (3,), 5, 4, False),  # J = 7
    (3, 20, 6, (4,), 1, 9, False),  # n = 1
    (2, 5, 3, (), 1024, 2, False),  # n = 1024: the phase table at its cap, outputs in chunks
    (2, 40, 4, (11, 11), 11, 16, False),  # a slab beyond shared memory: chunks of outputs
    (3, 12, 5, (5,), 5, 9, True),  # lane map entries outside 0..Lc-1 give NaN
])
def test_contract_kernel_edges_match_plain_on_card(cuda_device, Lc, L, J, rows, n, V, bad):
    """K3's block and chunk edges against its plain version (1e-12 of
    max|c|), bit-identical on repeat; bad lane-map entries give NaN rows."""
    rng = np.random.default_rng(13 + L + n)
    shape = (Lc,) + rows + (n, V)
    c = torch.as_tensor(rng.normal(size=shape) + 1j * rng.normal(size=shape), device=cuda_device)
    cmap = torch.as_tensor(rng.integers(0, Lc, L), device=cuda_device)
    if bad:
        cmap[::4] = Lc
        cmap[1] = -1
    # at n = 1024 the points stay near 0, so that the phase angles (up to
    # 2 pi 512 x / 1.3) are small enough for both versions' rounding of
    # them to stay below the tolerance
    x = torch.as_tensor(rng.uniform(-1, 2, (L, J)) * (0.01 if n > 100 else 1.0), device=cuda_device)
    before = fourier_contract.launches
    got = fourier_contract(c, cmap, x, -(n // 2), 1.3)
    assert fourier_contract.launches == before + 1
    assert got.shape == (L, J) + rows + (V,)
    again = fourier_contract(c, cmap, x, -(n // 2), 1.3)
    assert torch.equal(got.isnan(), again.isnan())
    assert torch.equal(torch.nan_to_num(got), torch.nan_to_num(again))
    good = (cmap >= 0) & (cmap < Lc)
    if bad:
        assert bool(got[~good].isnan().all()) and int((~good).sum()) > 0
    want = fourier_contract_plain(c, torch.where(good, cmap, 0), x, -(n // 2), 1.3)
    assert float((got[good] - want[good]).abs().max()) <= 1e-12 * float(c.abs().max())


def _leaf_inputs(rng, dev, m, L=900, I=2):
    """1-D coefficients of L leaf lanes (a model contracted at random
    (x3, x2)), two intervals per lane, a few inactive lanes and dead
    intervals."""
    s = ttb.flagship_series(device=dev) if m == 3 else ttb.synthetic_wannier(m, seed=m, device=dev)
    c = _flat_coeffs(s)
    x3 = torch.as_tensor(rng.random((1, L)), device=dev)
    c2 = fourier_contract_plain(c, torch.zeros(1, dtype=torch.int64, device=dev), x3,
                                s.offset[2], 1.0).reshape((L,) + tuple(c.shape[2:-1]) + (-1,))
    x2 = torch.as_tensor(rng.random((L, 1)), device=dev)
    c1 = fourier_contract_plain(c2, torch.arange(L, device=dev), x2, s.offset[1], 1.0)
    c1 = c1.reshape(L, -1, m * m).contiguous()
    a = torch.as_tensor(rng.random((L, I)) * 0.5, device=dev)
    b = a + torch.as_tensor(rng.random((L, I)) * 0.5, device=dev)
    b[::17, 1] = a[::17, 1]  # dead intervals
    om = torch.as_tensor(rng.uniform(-4, 5, L), device=dev)
    eta = torch.full_like(om, 0.05)
    active = torch.as_tensor(rng.random(L) > 0.1, device=dev)
    return c1, torch.arange(L, device=dev), s.offset[0], a.contiguous(), b.contiguous(), om, eta, active


@pytest.mark.gpu
@pytest.mark.parametrize("m", [1, 2, 3])
def test_leaf_dos_kernel_matches_plain_on_card(cuda_device, m):
    rng = np.random.default_rng(20 + m)
    c, cmap, off, a, b, om, eta, active = _leaf_inputs(rng, cuda_device, m)
    xk, wk, wg = tad.gk_rule(7, cuda_device)
    before = tobs.gk_leaf_dos.launches
    got = tobs.gk_leaf_dos(c, cmap, off, 1.0, a, b, om, eta, active, xk, wk, wg)
    assert tobs.gk_leaf_dos.launches == before + 1
    want = tobs.gk_leaf_dos_plain(c, cmap, off, 1.0, a, b, om, eta, active, xk, wk, wg)
    l1 = want[2]
    assert torch.all((got[0] - want[0]).abs() <= 1e-12 * l1 + 1e-300)
    assert torch.all((got[1] - want[1]).abs() <= 1e-12 * l1 + 1e-300)
    assert torch.allclose(got[2], l1, rtol=1e-12, atol=0)
    assert torch.equal(got[3], want[3])
    dead = (b == a) | ~active[:, None]
    assert torch.all(got[0][dead] == 0) and torch.all(got[1][dead] == 0)


@pytest.mark.gpu
def test_leaf_dos_kernel_refuses_more_than_three_bands(cuda_device):
    c = torch.zeros((1, 3, 16), dtype=torch.complex128, device=cuda_device)
    z = torch.zeros((1, 2), dtype=torch.float64, device=cuda_device)
    om = torch.zeros(1, dtype=torch.float64, device=cuda_device)
    xk, wk, wg = tad.gk_rule(7, cuda_device)
    with pytest.raises(NotImplementedError, match="above three bands the IAI nest evaluates the leaf by its generic"):
        tobs.gk_leaf_dos(c, torch.zeros(1, dtype=torch.int64, device=cuda_device), -1, 1.0, z, z,
                         om, om + 0.1, torch.ones(1, dtype=torch.bool, device=cuda_device),
                         xk, wk, wg)


def _random_pool(rng, dev, L=900, cap=64, nb=4, V=(), complex_vals=False):
    """Pools with planted error ties, lanes with n < nbisect (dead slots of
    error 0 tie with each other) and lanes that have converged or run out
    of room or budget."""
    n = torch.as_tensor(rng.integers(1, cap - nb + 3, L), device=dev)
    if nb > 1:  # n < nbisect: the picks run into dead slots
        n[:40] = torch.as_tensor(rng.integers(1, nb, 40), device=dev)
    a = torch.as_tensor(rng.random((L, cap)), device=dev)
    b = a + torch.as_tensor(rng.random((L, cap)), device=dev)
    err = torch.as_tensor(rng.integers(0, 6, (L, cap)) * 0.125, device=dev)  # many ties
    live = torch.arange(cap, device=dev)[None, :] < n[:, None]
    a, b, err = (torch.where(live, t, torch.zeros((), dtype=torch.float64, device=dev))
                 for t in (a, b, err))
    dt = torch.complex128 if complex_vals else torch.float64
    val = torch.as_tensor(rng.normal(size=(L, cap) + V), device=dev).to(dt)
    if complex_vals:
        val = val + 1j * torch.as_tensor(rng.normal(size=(L, cap) + V), device=dev)
    val = torch.where(live.reshape((L, cap) + (1,) * len(V)), val, torch.zeros((), dtype=dt, device=dev))
    pool = tad.GKPool(a=a.contiguous(), b=b.contiguous(), err=err.contiguous(),
                      l1=(err * 2).contiguous(), val=val.contiguous(), n=n.contiguous(),
                      evals=torch.as_tensor(rng.integers(0, 2000, L).astype(np.float64), device=dev),
                      atol=torch.as_tensor(rng.random(L) * 4, device=dev), rtol=1e-3,
                      max_evals=1500.0, active=torch.as_tensor(rng.random(L) > 0.05, device=dev))
    tad.gk_pool_totals_plain(pool)
    return pool


def _clone_pool(pool):
    return pool.clone()


def _node_children(rng, pool, live, P=15, counts=True, ca=None, cb=None):
    """Random node values (and per-node counts) of the live lanes'
    children, at their intervals (ca, cb), by default the pool's picks'
    children."""
    dev = pool.a.device
    xk, wk, wg = tad.gk_rule(7, dev)
    ca, cb = (pool.ca, pool.cb) if ca is None else (ca, cb)
    _, half = tad.gk_nodes(ca[live], cb[live], xk)
    La, K = half.shape
    V = tuple(pool.val.shape[2:])
    fx = torch.as_tensor(rng.normal(size=(La, K, P) + V), device=dev)
    if pool.val.is_complex():
        fx = torch.complex(fx, torch.as_tensor(rng.normal(size=(La, K, P) + V), device=dev))
    cnt = torch.as_tensor(rng.integers(15, 5000, (La, K, P)).astype(np.float64), device=dev) if counts else None
    return tad.NodeChildren(fx.contiguous(), cnt, half.contiguous(), live, wk, wg)


def _reduced_on_card(kids):
    """Node children reduced by K5's reduction alone on the card, for the
    plain versions to take in: the step's reduction gives its bits (the
    plain reduction sums in another order, within 1e-12)."""
    return tad.ReducedChildren(*tad.gk_rule_reduce(kids.fx, kids.counts, kids.half, kids.wk, kids.wg), kids.live)


def _tree_sum(x):
    """Each lane's sum of x (L, cap) in the pool kernels' order: entry v of
    256 sums slots v, v + 256, ... in order, then a halving tree."""
    L, cap = x.shape
    n = -(-cap // 256) * 256
    e = torch.zeros((L, n), dtype=x.dtype, device=x.device)
    e[:, :cap] = x
    e = e.reshape(L, n // 256, 256)
    s = e[:, 0]
    for k in range(1, n // 256):
        s = s + e[:, k]
    w = 128
    while w:
        s = s[:, :w] + s[:, w:2 * w]
        w //= 2
    return s[:, 0]


def _assert_pools_match(pool, ref, picks=True):
    """Identical pools, n, evals, live flags (and picks); the totals bit for
    bit the sums in the kernels' tree order, and within 1e-14 of the plain
    version's (another order) relative to each lane's sum of magnitudes."""
    L, cap = pool.a.shape
    for name in ("a", "b", "err", "l1", "val", "n", "evals", "active") + (("idx", "ca", "cb") if picks else ()):
        assert torch.equal(getattr(pool, name), getattr(ref, name)), name
    val = pool.real_val().reshape(L, cap, -1)
    tv = (torch.view_as_real(pool.tot_val) if pool.tot_val.is_complex() else pool.tot_val).reshape(L, -1)
    assert torch.equal(pool.tot_err, _tree_sum(pool.err))
    assert all(torch.equal(tv[:, f], _tree_sum(val[:, :, f].contiguous())) for f in range(val.shape[2]))
    mag = pool.err.sum(1).clamp_min(1e-300)
    assert float(((pool.tot_err - ref.tot_err).abs() / mag).max()) <= 1e-14
    rv = (torch.view_as_real(ref.tot_val) if ref.tot_val.is_complex() else ref.tot_val).reshape(L, -1)
    mag = val.abs().sum(1).clamp_min(1e-300)
    assert float(((tv - rv).abs() / mag).max()) <= 1e-14
    assert float(((pool.tol - ref.tol).abs() / (pool.atol + pool.rtol * mag.norm(dim=1))).max()) <= 1e-14


@pytest.mark.gpu
@pytest.mark.parametrize("nb", [1, 2, 4])
@pytest.mark.parametrize("V,complex_vals", [((), False), ((3,), True)], ids=["real", "complex3"])
def test_pool_kernels_match_plain_on_card(cuda_device, nb, V, complex_vals):
    """K5's start (on the pool as it stands) and three steps (from node
    values with counts, without, and reduced children) against their plain
    versions (node values reduced by the reduction alone): identical picks,
    live flags, pools, n and evals, totals within 1e-14."""
    rng = np.random.default_rng(30 + nb)
    pool = _random_pool(rng, cuda_device, nb=nb, V=V, complex_vals=complex_vals)
    ref = _clone_pool(pool)
    before = dict(tad.gk_pool_launches)
    tad.gk_pool_start(pool, nb)
    tad.gk_pool_start_plain(ref, nb)
    _assert_pools_match(pool, ref)
    live = ref.active
    assert 0 < int(live.sum()) < live.numel()
    pool.max_evals = ref.max_evals = 1e300  # the budget stopped lanes at the start; the rest go on
    L = pool.nlanes
    for trip in range(3):
        live = ref.active.nonzero().squeeze(1)
        if trip < 2:
            kids = _node_children(rng, ref, live, counts=trip == 0)
        else:
            cval = torch.as_tensor(rng.normal(size=(L, 2 * nb) + V), device=cuda_device).to(pool.val.dtype)
            cerr = torch.as_tensor(rng.random((L, 2 * nb)), device=cuda_device)
            kids = tad.ReducedChildren(cval, cerr, cerr * 3, torch.full((L,), 2.0 * nb * 15, dtype=torch.float64,
                                                                        device=cuda_device))
        tad.gk_pool_step(pool, nb, kids)
        tad.gk_pool_step_plain(ref, nb, _reduced_on_card(kids) if trip < 2 else kids)
        _assert_pools_match(pool, ref)
        if trip == 0:  # the plain reduction within 1e-12 of the values' scale
            want = tad.gk_rule_reduce_plain(kids.fx, kids.counts, kids.half, kids.wk, kids.wg)
            got = tad.gk_rule_reduce(kids.fx, kids.counts, kids.half, kids.wk, kids.wg)
            for g, w in zip(got[:3], want[:3]):
                assert float((g - w).abs().max()) <= 1e-12 * float(want[2].max())
            assert torch.equal(got[3], want[3])
    assert tad.gk_pool_launches["start"] == before["start"] + 1
    assert tad.gk_pool_launches["step"] == before["step"] + 3


@pytest.mark.gpu
def test_pool_select_breaks_the_collision_as_the_reference(cuda_device):
    """One live slot of n = 1 and nbisect = 2: the second pick is the dead
    slot 1 (error 0, the lowest such index), which the fresh right child
    of slot 0 must overwrite; in both teams of a lane (a warp at cap 8, a
    block at cap 512)."""
    dev = cuda_device
    z = lambda *s: torch.zeros(s, dtype=torch.float64, device=dev)  # noqa: E731
    for cap in (8, 512):
        a, b, err = z(1, cap), z(1, cap), z(1, cap)
        b[0, 0], err[0, 0] = 1.0, 0.5
        pool = tad.GKPool(a=a, b=b, err=err, l1=err.clone(), val=z(1, cap),
                          n=torch.ones(1, dtype=torch.int64, device=dev), evals=z(1), atol=z(1) + 1e-9, rtol=0.0,
                          max_evals=1e9, active=torch.ones(1, dtype=torch.bool, device=dev))
        tad.gk_pool_start(pool, 2)
        assert pool.idx.tolist() == [[0, 1]]
        cval = torch.tensor([[1.0, 2.0, 3.0, 4.0]], dtype=torch.float64, device=dev)
        tad.gk_pool_step(pool, 2, tad.ReducedChildren(cval, cval / 10, cval, z(1) + 60))
        assert pool.n.tolist() == [3]
        assert pool.a[0, :3].tolist() == [0.0, 0.5, 0.0] and pool.b[0, :3].tolist() == [0.5, 1.0, 0.0]
        assert pool.val[0, :3].tolist() == [1.0, 3.0, 4.0]


@pytest.mark.gpu
@pytest.mark.parametrize("cap", [64, 2048])
def test_pool_warp_totals_equal_the_block_form_on_card(cuda_device, cap):
    """The start and two steps at the nest's mid cap (a warp a lane) and the
    outermost level's (a block a lane): totals bit for bit the block tree's
    sums (:func:`_tree_sum`, the fused leaf solve's order), pools and picks
    identical to the plain versions'."""
    rng = np.random.default_rng(80 + cap)
    base = _random_pool(rng, cuda_device, L=200, cap=cap, nb=4, V=(2,))
    base.err = base.err * torch.as_tensor(rng.random(base.err.shape), device=cuda_device)  # few ties
    pool, ref = _clone_pool(base), _clone_pool(base)
    tad.gk_pool_start(pool, 4)
    tad.gk_pool_start_plain(ref, 4)
    _assert_pools_match(pool, ref)
    pool.max_evals = ref.max_evals = 1e300
    for _ in range(2):
        kids = _node_children(rng, ref, ref.active.nonzero().squeeze(1))
        tad.gk_pool_step(pool, 4, kids)
        tad.gk_pool_step_plain(ref, 4, _reduced_on_card(kids))
        _assert_pools_match(pool, ref)


@pytest.mark.gpu
@pytest.mark.parametrize("cap", [96, 320])
def test_pool_picks_take_ties_in_slot_order_on_card(cuda_device, cap):
    """Equal errors are picked lowest slot first, as lax.top_k, across a
    warp's slots and past them (cap 96, a warp a lane; cap 320, a block); a
    NaN-free lane with fewer live slots than picks takes its dead slots in
    order."""
    dev = cuda_device
    L, nb = 3, 6
    err = torch.zeros((L, cap), dtype=torch.float64, device=dev)
    err[0, :] = 0.25  # every slot tied
    err[1, [70, 5, 33, 64]] = 0.5  # four tied, then the rest tied at 0
    err[2, 90] = 1.0
    a = torch.arange(cap, dtype=torch.float64, device=dev).expand(L, cap).contiguous()
    pool = tad.GKPool(a=a, b=a + 1, err=err, l1=err.clone(), val=torch.zeros((L, cap), dtype=torch.float64, device=dev),
                      n=torch.full((L,), cap - nb, dtype=torch.int64, device=dev),
                      evals=torch.zeros(L, dtype=torch.float64, device=dev),
                      atol=torch.zeros(L, dtype=torch.float64, device=dev), rtol=0.0, max_evals=1e9,
                      active=torch.ones(L, dtype=torch.bool, device=dev))
    ref = _clone_pool(pool)
    tad.gk_pool_start(pool, nb)
    tad.gk_pool_start_plain(ref, nb)
    assert pool.idx.tolist() == [[0, 1, 2, 3, 4, 5], [5, 33, 64, 70, 0, 1], [90, 0, 1, 2, 3, 4]]
    assert torch.equal(pool.idx, ref.idx) and torch.equal(pool.ca, ref.ca) and torch.equal(pool.cb, ref.cb)


@pytest.mark.gpu
def test_pool_step_takes_rebound_fields_on_card(cuda_device):
    """Fields rebound on a started pool (a value pool replaced, the totals
    recomputed by the plain version) are what the next step reads and
    writes: the pool is checked again and its pointers taken anew."""
    rng = np.random.default_rng(85)
    pool = _random_pool(rng, cuda_device, L=300, cap=64, nb=2)
    tad.gk_pool_start(pool, 2)
    ref = _clone_pool(pool)
    old_val = pool.val
    pool.val = pool.val.clone()
    tad.gk_pool_totals_plain(pool)
    tad.gk_pool_totals_plain(ref)
    old_val.fill_(float("nan"))
    kids = _node_children(rng, ref, ref.active.nonzero().squeeze(1))
    tad.gk_pool_step(pool, 2, kids)
    tad.gk_pool_step_plain(ref, 2, _reduced_on_card(kids))
    _assert_pools_match(pool, ref)
    with pytest.raises(ValueError):
        pool.err = pool.err[:, :32]
        tad.gk_pool_step(pool, 2, _node_children(rng, pool, pool.active.nonzero().squeeze(1)))


@pytest.mark.gpu
@pytest.mark.parametrize("complex_vals", [False, True])
def test_rule_reduce_kernel_matches_plain_on_card(cuda_device, complex_vals):
    rng = np.random.default_rng(40)
    L, I, P = 900, 2, 15
    fx = torch.as_tensor(rng.normal(size=(L, I, P, 2)), device=cuda_device)
    if complex_vals:
        fx = torch.complex(fx, torch.as_tensor(rng.normal(size=(L, I, P, 2)), device=cuda_device))
    counts = torch.as_tensor(rng.integers(15, 500, (L, I, P)).astype(np.float64), device=cuda_device)
    half = torch.as_tensor(rng.random((L, I)), device=cuda_device)
    half[::13, 0] = 0.0
    _, wk, wg = tad.gk_rule(7, cuda_device)
    before = tad.gk_rule_reduce.launches
    got = tad.gk_rule_reduce(fx, counts, half, wk, wg)
    assert tad.gk_rule_reduce.launches == before + 1
    want = tad.gk_rule_reduce_plain(fx, counts, half, wk, wg)
    scale = float(want[2].max())
    for g, w in zip(got[:3], want[:3]):
        assert float((g - w).abs().max()) <= 1e-12 * scale
    assert torch.equal(got[3], want[3])
    assert torch.all(got[0][::13, 0] == 0)


@pytest.mark.gpu
@pytest.mark.parametrize("kind", ["FBZ", "CubicSymIBZ"])
def test_iai_on_card_matches_cpu(cuda_device, kind):
    """The whole cold nest through K3-K5 against the CPU's plain path: the
    same numevals and retcode, values within 1e-10."""
    om = np.array([-1.3, 0.4, 2.1])
    out = []
    for dev in ("cpu", cuda_device):
        prob = T.IntegralProblem(tobs.dos_integrand(ttb.tb_integer(3, device=dev), 0.3),
                                 T.load_bz(getattr(T, kind)(), np.eye(3)))
        sweep = SweepSolver(prob, T.IAI(inner_cap=32, inner_nbisect=2, device=dev), abstol=1e-3,
                            chunk=2, scan=True)
        out.append((sweep(om), sweep.numevals, sweep.retcode))
    assert out[1][1] == out[0][1] and out[1][2] is out[0][2] is True
    assert rel_err(out[1][0], out[0][0]) <= 1e-10


@pytest.mark.gpu
def test_kernels_refuse_out_of_range_maps_and_slots(cuda_device):
    """A lane map entry outside the coefficient tensors gives NaN (K3, K4)
    and a step with a pick outside the pool, or without room, writes
    nothing, sets the lane's totals to NaN and stops it (K5)."""
    dev = cuda_device
    s = ttb.flagship_series(device=dev)
    c = _flat_coeffs(s)
    cmap = torch.tensor([0, 1, -1], dtype=torch.int64, device=dev)
    x = torch.rand(3, 4, dtype=torch.float64, device=dev)
    got = fourier_contract(c, cmap, x, s.offset[-1], s.period[-1])
    assert torch.isfinite(got[0]).all() and torch.isnan(got[1:].real).all()
    rng = np.random.default_rng(50)
    c1, _, off, a, b, om, eta, active = _leaf_inputs(rng, dev, 3, L=4)
    xk, wk, wg = tad.gk_rule(7, dev)
    cm = torch.tensor([0, 4, 1, 2], dtype=torch.int64, device=dev)
    active = torch.ones(4, dtype=torch.bool, device=dev)
    val = tobs.gk_leaf_dos(c1, cm, off, 1.0, a, b, om, eta, active, xk, wk, wg)[0]
    assert torch.isnan(val[1]).all() and torch.isfinite(val[[0, 2, 3]]).all()
    for cap in (8, 512):  # a warp a lane, a block a lane
        pool = _random_pool(rng, dev, L=3, cap=cap, nb=1)
        pool.active[:] = True
        pool.atol[:] = 0.0
        pool.n[:] = 2
        pool.err[:, :2] = 0.5
        pool.evals[:] = 0.0
        tad.gk_pool_start(pool, 1)
        assert bool(pool.active.all())
        pool.n[:] = torch.tensor([2, 2, cap], device=dev)  # lane 2 has no room
        pool.idx[:] = torch.tensor([[0], [cap + 1], [1]], dtype=torch.int64, device=dev)  # lane 1 picks past cap
        before = _clone_pool(pool)
        ch = torch.ones((3, 2), dtype=torch.float64, device=dev)
        tad.gk_pool_step(pool, 1, tad.ReducedChildren(ch, ch.clone(), ch.clone(),
                                                      torch.ones(3, dtype=torch.float64, device=dev)))
        assert torch.isfinite(pool.tot_err[0]) and torch.isnan(pool.tot_err[1:]).all()
        assert pool.active.tolist() == [True, False, False] and torch.all(pool.ca[1:] == 0)
        for name in ("a", "b", "err", "val", "n", "evals"):
            assert torch.equal(getattr(pool, name)[1:], getattr(before, name)[1:]), name


# --- the warm start: K6 coarsen_pool and K5's seed entry ---------------------------
from torch_parity import dyadic_pools  # noqa: E402


def test_warm_wrappers_take_plain_versions_on_cpu_without_counting():
    rng = np.random.default_rng(60)
    a, b, e, n = dyadic_pools(rng, 5, 64, [0.0, 0.3, 1.0], "cpu")
    segs = torch.tensor([0.0, 0.3, 1.0], dtype=torch.float64)
    tol = torch.full((5,), 1e-6, dtype=torch.float64)
    before = tad.coarsen_pool.launches
    got = tad.coarsen_pool(a, b, e, n, segs, tol)
    assert tad.coarsen_pool.launches == before
    for g, w in zip(got, tad.coarsen_pool_plain(a, b, e, n, segs, tol)):
        assert torch.equal(g, w)
    with pytest.raises(ValueError):
        tad.coarsen_pool(a, b, e, n.to(torch.int32), segs, tol)
    with pytest.raises(ValueError):
        tad.coarsen_pool(a, b, e[:, :8], n, segs, tol)
    pool = _random_pool(rng, "cpu", L=5, cap=16, nb=1)
    ch = torch.ones((5, 4), dtype=torch.float64)
    seeding = torch.ones(5, dtype=torch.bool)
    before = dict(tad.gk_pool_launches)
    tad.gk_pool_seed(pool, 12, tad.ReducedChildren(ch, ch.clone(), ch.clone(), ch[:, 0].clone()), pool.n.clone(),
                     seeding, 1, select=True)
    tad.gk_pool_step(pool, 1, tad.ReducedChildren(ch[:, :2].clone(), ch[:, :2].clone(), ch[:, :2].clone(),
                                                  ch[:, 0].clone()))
    assert tad.gk_pool_launches == before
    with pytest.raises(ValueError, match="does not fit"):
        tad.gk_pool_seed(pool, 13, tad.ReducedChildren(ch, ch, ch, ch[:, 0]), pool.n, seeding, 1)


@pytest.mark.gpu
@pytest.mark.parametrize("cap", [64, 2048])
def test_coarsen_kernel_matches_plain_on_card(cuda_device, cap):
    """K6 against its plain version on dyadic pools with interior
    breakpoints, +inf, noise-floored and tied errors, dead slots and junk
    past n: identical a2, b2 and n2, per-lane segments and tolerances."""
    rng = np.random.default_rng(61 + cap)
    for segs in ([0.0, 1.0], [0.0, 0.3, 1.0], [0.0, 0.125, 0.5]):
        L = 40
        a, b, e, n = dyadic_pools(rng, L, cap, segs, cuda_device)
        seg_t = torch.tensor(segs, dtype=torch.float64, device=cuda_device).expand(L, -1).contiguous()
        tol = torch.as_tensor(10 ** rng.uniform(-7, -2, L), device=cuda_device)
        before = tad.coarsen_pool.launches
        got = tad.coarsen_pool(a, b, e, n, seg_t, tol)
        assert tad.coarsen_pool.launches == before + 1
        want = tad.coarsen_pool_plain(a, b, e, n, seg_t, tol)
        for g, w, name in zip(got, want, ("a2", "b2", "n2")):
            assert torch.equal(g, w), (segs, name)
        assert bool((want[2] < n).any())  # some pools did merge


@pytest.mark.gpu
@pytest.mark.parametrize("V,complex_vals", [((), False), ((3,), True)], ids=["real", "complex3"])
def test_pool_seed_kernel_matches_plain_on_card(cuda_device, V, complex_vals):
    """K5's seed entry against its plain version: a first chunk starting
    the pool from a partition, then a chunk from the seeding lanes' node
    values (a fifth of the lanes not seeding) written to their contiguous
    slots with the first picks: n = n0, evals += count, identical pools and
    picks, totals within 1e-14."""
    rng = np.random.default_rng(70)
    base = _random_pool(rng, cuda_device, L=300, cap=64, nb=1, V=V, complex_vals=complex_vals)
    L, C, dev = base.nlanes, 8, cuda_device
    part = (base.a, base.b)
    n0 = torch.as_tensor(rng.integers(50, 64, L), device=dev)
    pool = tad._empty_pool(L, 64, V, base.val.dtype, dev, base.atol, base.rtol, None)
    ref = tad._empty_pool(L, 64, V, base.val.dtype, dev, base.atol, base.rtol, None)
    before = tad.gk_pool_launches["seed"]
    for k, start in enumerate((0, 56)):
        seeding = torch.ones(L, dtype=torch.bool, device=dev) if k == 0 else torch.as_tensor(rng.random(L) > 0.2,
                                                                                              device=dev)
        live = seeding.nonzero().squeeze(1)
        kids = _node_children(rng, ref, live, ca=base.a[:, start:start + C], cb=base.b[:, start:start + C])
        first = part if k == 0 else None
        tad.gk_pool_seed(pool, start, kids, n0, seeding, 4, partition=first, select=k == 1)
        tad.gk_pool_seed_plain(ref, start, _reduced_on_card(kids), n0, seeding, 4, partition=first, select=k == 1)
        _assert_pools_match(pool, ref, picks=k == 1)
    assert tad.gk_pool_launches["seed"] == before + 2


@pytest.mark.gpu
@pytest.mark.parametrize("kind", ["FBZ", "CubicSymIBZ"])
def test_warm_iai_on_card_matches_cpu(cuda_device, kind):
    """The warm chain through K3-K6 against the CPU's plain path, two calls:
    the same numevals, chunk telemetry, retcode and carried pools, values
    within 1e-10."""
    from autobzcore_torch.interop import pool_to_arrays

    out = []
    for dev in ("cpu", cuda_device):
        prob = T.IntegralProblem(tobs.dos_integrand(ttb.tb_integer(3, device=dev), 0.5),
                                 T.load_bz(getattr(T, kind)(), np.eye(3)))
        sweep = SweepSolver(prob, T.IAI(inner_cap=32, inner_nbisect=2, device=dev), abstol=1e-3,
                            chunk=2, scan=True, warm=True)
        vals = [sweep(np.array([-1.3, 0.4, 2.1])), sweep(np.array([-0.7, 1.6]))]
        out.append((vals, sweep.numevals, sweep.chunk_evals, sweep.retcode, pool_to_arrays(sweep._pool)))
    (vc, nc, cc, rc, pc), (vg, ng, cg, rg, pg) = out
    assert ng == nc and cg == cc and rg is rc is True
    for g, w in zip(vg, vc):
        assert rel_err(g, w) <= 1e-10
    assert pg[3] == pc[3] and pg[4][3] == pc[4][3]
    assert np.max(np.abs(pg[0] - pc[0])) <= 1e-15 and np.max(np.abs(pg[4][0] - pc[4][0])) <= 1e-15


# --- the full-grid ladder's kernels: K7 fullgrid_tail, K8 lorentzian_sum, K9 eigvalsh_small ---
from autobzcore_torch import dos as tdos  # noqa: E402
from autobzcore_torch.ops import eigh3 as teigh  # noqa: E402
from autobzcore_torch.ops import grid_sweep as tgs  # noqa: E402
from torch_parity import dense_dos, hermitian_series_arrays  # noqa: E402


def _slab_planes(rng, m, S, inner, K2, device):
    """Entry planes (ne, K2 * S * inner) of random Hermitian matrices, and
    the matrices themselves on the host."""
    N = K2 * S * inner
    H = random_hermitian(rng, N, m)
    planes = torch.as_tensor(np.stack([H[:, i, j] for i, j in tgs._entries(m)]), device=device)
    return planes.contiguous(), H


def test_fullgrid_wrappers_take_plain_versions_on_cpu_without_counting():
    rng = np.random.default_rng(0)
    planes, H = _slab_planes(rng, 3, 2, 5, 3, "cpu")
    wrow = torch.tensor([1.0, 0.0], dtype=torch.float64)
    om = torch.linspace(-2, 2, 7, dtype=torch.float64)
    counts = (tgs.fullgrid_tail.launches, tgs.lorentzian_sum.launches, teigh.eigvalsh_small.launches)
    acc = tgs.fullgrid_tail(planes, 3, wrow, 5, om, 0.1, torch.zeros(7, dtype=torch.float64))
    assert torch.equal(acc, tgs.fullgrid_tail_plain(planes, 3, wrow, 5, om, 0.1,
                                                    torch.zeros(7, dtype=torch.float64)))
    e = teigh.eigvalsh_small(torch.as_tensor(H))
    assert torch.equal(e, teigh.eigvalsh_small_plain(torch.as_tensor(H)))
    assert torch.equal(tgs.lorentzian_sum(e, None, om, 0.1), tgs.lorentzian_sum_plain(e, None, om, 0.1))
    assert counts == (tgs.fullgrid_tail.launches, tgs.lorentzian_sum.launches, teigh.eigvalsh_small.launches)
    acc = torch.zeros(7, dtype=torch.float64)
    with pytest.raises(ValueError):  # planes of another band count
        tgs.fullgrid_tail(planes[:5].contiguous(), 3, wrow, 5, om, 0.1, acc)
    with pytest.raises(ValueError):
        tgs.fullgrid_tail(planes, 3, wrow, 5, om, 0.1, acc[:6])
    with pytest.raises(ValueError):
        tgs.fullgrid_tail(planes.to(torch.complex64), 3, wrow, 5, om, 0.1, acc)
    with pytest.raises(ValueError):
        tgs.lorentzian_sum(e, torch.ones(3, dtype=torch.float64), om, 0.1)
    with pytest.raises(ValueError):
        tgs.lorentzian_sum(e.to(torch.float32), None, om, 0.1)


@pytest.mark.gpu
@pytest.mark.parametrize("m", [1, 2, 3])
def test_fullgrid_tail_kernel_matches_plain_on_card(cuda_device, m):
    """K7 against its plain version with pad rows (weight 0), a ragged last
    tile and a ragged lane group, then bit-identical on repeat."""
    rng = np.random.default_rng(40 + m)
    planes, H = _slab_planes(rng, m, 3, 97, 41, cuda_device)
    wrow = torch.tensor([1.0, 0.5, 0.0], dtype=torch.float64, device=cuda_device)
    om = torch.linspace(-4, 4, 1100, dtype=torch.float64, device=cuda_device)
    before = tgs.fullgrid_tail.launches
    acc = tgs.fullgrid_tail(planes, m, wrow, 97, om, 0.05, torch.ones(1100, dtype=torch.float64,
                                                                        device=cuda_device), scale=0.5)
    assert tgs.fullgrid_tail.launches == before + 1
    want = tgs.fullgrid_tail_plain(planes, m, wrow, 97, om, 0.05,
                                   torch.ones(1100, dtype=torch.float64, device=cuda_device), scale=0.5)
    assert float((acc - want).abs().max() / want.abs().max()) <= 1e-12
    again = tgs.fullgrid_tail(planes, m, wrow, 97, om, 0.05, torch.ones(1100, dtype=torch.float64,
                                                                          device=cuda_device), scale=0.5)
    assert torch.equal(acc, again)
    with pytest.raises(ValueError):
        tgs.fullgrid_tail(planes, m, wrow, 0, om, 0.05, acc)


@pytest.mark.gpu
@pytest.mark.parametrize("nb, weighted", [(3, False), (5, True), (1, True)])
def test_lorentzian_sum_kernel_matches_plain_on_card(cuda_device, nb, weighted):
    rng = np.random.default_rng(nb)
    K = 20_001
    e = torch.as_tensor(rng.normal(size=(K, nb)) * 2, device=cuda_device)
    w = torch.as_tensor(rng.random(K), device=cuda_device) if weighted else None
    om = torch.linspace(-5, 5, 1000, dtype=torch.float64, device=cuda_device)
    before = tgs.lorentzian_sum.launches
    got = tgs.lorentzian_sum(e, w, om, 0.01, scale=1 / K)
    assert tgs.lorentzian_sum.launches == before + 1
    want = tgs.lorentzian_sum_plain(e, w, om, 0.01, scale=1 / K)
    assert float((got - want).abs().max() / want.abs().max()) <= 1e-12
    assert torch.equal(got, tgs.lorentzian_sum(e, w, om, 0.01, scale=1 / K))
    empty = tgs.lorentzian_sum(e[:0], None if w is None else w[:0], om, 0.01)
    assert torch.equal(empty, torch.zeros_like(om))


@pytest.mark.gpu
@pytest.mark.parametrize("m", [1, 2, 3])
def test_eigvalsh_small_kernel_matches_plain_and_numpy_on_card(cuda_device, m):
    rng = np.random.default_rng(50 + m)
    H = random_hermitian(rng, 70_000, m)
    H[:4] = np.eye(m) * np.array([0.0, 1.5, -2.0, 1e-3])[:, None, None]  # scalar matrices
    Ht = torch.as_tensor(H, device=cuda_device)
    before = teigh.eigvalsh_small.launches
    got = teigh.eigvalsh_small(Ht)
    assert teigh.eigvalsh_small.launches == before + 1
    want = teigh.eigvalsh_small_plain(Ht)
    assert float((got - want).abs().max()) <= 1e-12
    assert np.max(np.abs(got.cpu().numpy() - np.linalg.eigvalsh(H))) <= 1e-12
    assert teigh.eigvalsh_small(Ht[:0]).shape == (0, m)
    assert teigh.eigvalsh_small(Ht[:6].reshape(2, 3, m, m)).shape == (2, 3, m)


@pytest.mark.gpu
def test_m5_tail_chunks_eigvalsh_on_card(cuda_device):
    """m = 5: torch.linalg.eigvalsh in chunks the card's solver takes (the
    slab has 36,864 points, several chunks), then K8; against the CPU engine
    and the dense FP64 reference."""
    from autobzcore_torch.interop import series_from_arrays

    C, off = hermitian_series_arrays(seed=13, n=3, m=5)
    omegas = np.linspace(-5, 5, 16)
    assert 64 * 9 * 64 > teigh.eigvalsh_chunk(5)
    before = tgs.lorentzian_sum.launches
    out = {}
    for dev in ("cpu", cuda_device):
        s = series_from_arrays(C, off, 1.0, 3, device=dev)
        out[str(dev)] = tgs.FullGridSpectralSweep(s, omegas, 0.15, slab=9, device=dev).rung(64)
    assert tgs.lorentzian_sum.launches == before + 8  # one per slab on the card
    assert rel_err(out[str(cuda_device)], out["cpu"]) <= 1e-12
    assert rel_err(out[str(cuda_device)], dense_dos(C, off, 64, omegas, 0.15)) <= 1e-12


@pytest.mark.gpu
@pytest.mark.parametrize("m", [1, 2, 3])
def test_fullgrid_ladder_on_card_matches_cpu(cuda_device, m):
    C, off = hermitian_series_arrays(seed=60 + m, n=5 if m == 3 else 3, m=m)
    from autobzcore_torch.interop import series_from_arrays

    Es = np.linspace(-4, 4, 45)
    out = []
    for dev in ("cpu", cuda_device):
        alg = tdos.LorentzianFullGrid(0.5, nmin=8, nmax=64, slab=5, device=dev)
        s = series_from_arrays(C, off, 1.0, 3, device=dev)
        cache = tdos.init(T.DOSProblem(s, Es, T.load_bz(T.FBZ(), np.eye(3))), alg, abstol=1e-4)
        D, ok = alg.dos_sweep(cache.cacheval, Es, abstol=1e-4, with_status=True)
        out.append((D, ok, [r["npt"] for r in cache.cacheval["rung_log"]]))
    (Dc, okc, rc), (Dg, okg, rg) = out
    assert okc and okg and rc == rg
    assert rel_err(Dg, Dc) <= 1e-12
    assert rel_err(Dg, dense_dos(C, off, rg[-1], Es, 0.5) / rg[-1] ** 3) <= 1e-12


@pytest.mark.gpu
def test_fullgrid_entry_points_default_to_the_card(cuda_device):
    assert tdos.LorentzianFullGrid(0.1).device.type == "cuda"
    s = ttb.flagship_series()
    eng = tgs.FullGridSpectralSweep(s, np.linspace(0, 1, 4), 0.1)
    assert eng.device.type == "cuda" and eng.c6.device.type == "cuda"


# --- the m > 3 PTR sum, K2's grid-stride loop, K10 and K4 over omega blocks ---
from autobzcore_torch.dos import tetrahedron as ttet  # noqa: E402


@pytest.mark.gpu
def test_ptr_sum_takes_four_bands_on_card(cuda_device):
    """C1: the PTR leg of synthetic_wannier(4) at 264 omegas through
    eigvalsh + K8 against the plain path (1e-10 relative)."""
    from autobzcore_torch.ops import grid_sweep as gsw

    xs = np.linspace(-3, 3, 264)
    out = []
    for dev in (cuda_device, "cpu"):
        prob = T.IntegralProblem(tobs.dos_integrand(ttb.synthetic_wannier(4, device=dev), 0.1),
                                 T.load_bz(T.FBZ(), np.eye(3)))
        before = gsw.lorentzian_sum.launches
        out.append(SweepSolver(prob, T.PTR(npt=24, device=dev), chunk=264)(xs))
        if dev == cuda_device:
            assert gsw.lorentzian_sum.launches == before + 1
    assert rel_err(out[0], out[1]) <= 1e-10


@pytest.mark.gpu
def test_dos_kernel_grid_cap_loop_is_bit_identical(cuda_device):
    """C2: a launch with 7 block rows loops over the 245 k-chunks of 1e6
    points and gives the uncapped launch's bits."""
    rng = np.random.default_rng(7)
    K = 1_000_000
    H = torch.as_tensor(random_hermitian(rng, K, 3), device=cuda_device)
    w = torch.as_tensor(rng.random(K), device=cuda_device)
    om = torch.linspace(-3, 3, 40, dtype=torch.float64, device=cuda_device)
    eta = torch.full_like(om, 0.05)
    full = tobs._dos_trace_launch(H, w, om, eta, 0.5, tobs.DOS_GRID_CAP)
    capped = tobs._dos_trace_launch(H, w, om, eta, 0.5, 7)
    assert torch.equal(full, capped)
    want = tobs.dos_trace_weighted_sum_plain(H, w, om, eta, 0.5)
    assert float((full - want).abs().max() / want.abs().max()) <= 1e-10


def _near_degenerate(rng, K, m, center, split):
    """K Hermitian matrices with one m-fold eigenvalue ``center`` split by
    ``split``, in random unitary bases."""
    Q = np.linalg.qr(rng.normal(size=(K, m, m)) + 1j * rng.normal(size=(K, m, m)))[0]
    ev = center + split * np.arange(m)
    return Q @ (ev[:, None] * np.swapaxes(Q.conj(), 1, 2))


@pytest.mark.gpu
@pytest.mark.parametrize("W", [1, 8, 31, 33, 264])
@pytest.mark.parametrize("m", [1, 2, 3])
def test_dos_kernel_lane_widths_on_card(cuda_device, m, W):
    """K2 at every lane width its launch sizes itself to, on general complex
    H (not Hermitian) over a K that is no multiple of a chunk or of a warp's
    32 substreams: 1e-10 relative, bit-identical repeats, and each lane the
    bits it has in a launch of 264 (alone too)."""
    rng = np.random.default_rng(40 + m)
    K = 2 * 4096 + 1061
    H = torch.as_tensor(rng.normal(size=(K, m, m)) + 1j * rng.normal(size=(K, m, m)), device=cuda_device)
    w = torch.as_tensor(rng.random(K) + 0.5, device=cuda_device)
    om264 = torch.linspace(-3, 3, 264, dtype=torch.float64, device=cuda_device)
    eta264 = torch.as_tensor(rng.uniform(0.02, 0.2, 264), device=cuda_device)
    all264 = tobs.dos_trace_weighted_sum(H, w, om264, eta264, 0.5)
    sel = torch.as_tensor(np.linspace(0, 263, W).round().astype(np.int64), device=cuda_device)
    om, eta = om264[sel].contiguous(), eta264[sel].contiguous()
    got = tobs.dos_trace_weighted_sum(H, w, om, eta, 0.5)
    want = tobs.dos_trace_weighted_sum_plain(H, w, om, eta, 0.5)
    assert float((got - want).abs().max() / want.abs().max()) <= 1e-10
    assert torch.equal(got, tobs.dos_trace_weighted_sum(H, w, om, eta, 0.5))
    assert torch.equal(got, all264[sel])
    j = W // 2
    assert torch.equal(tobs.dos_trace_weighted_sum(H, w, om[j:j + 1], eta[j:j + 1], 0.5), got[j:j + 1])


@pytest.mark.gpu
@pytest.mark.parametrize("m", [2, 3])
def test_dos_kernel_near_degenerate_on_card(cuda_device, m):
    """K2 where its form's shifts are smallest: an m-fold eigenvalue split
    by 1e-9 at eta 1e-3, frequencies on the cluster and beside it, within
    1e-10 of the plain version relative to the largest lane."""
    rng = np.random.default_rng(50 + m)
    K = 5000
    H = torch.as_tensor(_near_degenerate(rng, K, m, 0.7, 1e-9), device=cuda_device)
    w = torch.as_tensor(rng.random(K) + 0.5, device=cuda_device)
    om = torch.as_tensor(0.7 + np.array([-3e-3, -1e-3, -1e-6, 0.0, 5e-10, 1e-6, 1e-3, 2e-2]), device=cuda_device)
    eta = torch.full_like(om, 1e-3)
    got = tobs.dos_trace_weighted_sum(H, w, om, eta, 0.5)
    want = tobs.dos_trace_weighted_sum_plain(H, w, om, eta, 0.5)
    assert float((got - want).abs().max() / want.abs().max()) <= 1e-10


@pytest.mark.gpu
@pytest.mark.parametrize("m", [1, 3])
def test_dos_kernel_exact_where_its_reciprocal_does_not_hold_on_card(cuda_device, m):
    """At eta 1e-160 on an eigenvalue, |det|^2 is subnormal and K2's
    reciprocal by rcp.approx does not hold: those pairs take a correctly
    rounded division, so the lane equals the plain version (1e-10 relative,
    ~1e160 in size) and the other lanes keep their bits."""
    rng = np.random.default_rng(60 + m)
    K = 300
    H = torch.as_tensor(random_hermitian(rng, K, m), device=cuda_device)
    H[7] = torch.diag(torch.arange(1, m + 1, dtype=torch.float64, device=cuda_device) * 0.5).to(H.dtype)
    w = torch.as_tensor(rng.random(K) + 0.5, device=cuda_device)
    om = torch.tensor([0.5, -0.3, 1.1], dtype=torch.float64, device=cuda_device)
    eta = torch.tensor([1e-160, 0.05, 0.05], dtype=torch.float64, device=cuda_device)
    got = tobs.dos_trace_weighted_sum(H, w, om, eta, 0.5)
    want = tobs.dos_trace_weighted_sum_plain(H, w, om, eta, 0.5)
    assert bool(torch.isfinite(got).all())
    assert float(((got - want).abs() / want.abs()).max()) <= 1e-10
    assert torch.equal(got[1:], tobs.dos_trace_weighted_sum(H, w, om[1:].contiguous(), eta[1:].contiguous(), 0.5))


@pytest.mark.gpu
def test_dos_kernel_grid_cap_loop_is_bit_identical_at_few_lanes(cuda_device):
    """The capped grid at a late AutoPTR rung's width (8 lanes, one lane
    group): 3 block rows loop over the 245 k-chunks of 1e6 points and give
    the uncapped launch's bits."""
    rng = np.random.default_rng(8)
    K = 1_000_000
    H = torch.as_tensor(random_hermitian(rng, K, 3), device=cuda_device)
    w = torch.as_tensor(rng.random(K), device=cuda_device)
    om = torch.linspace(-3, 3, 8, dtype=torch.float64, device=cuda_device)
    eta = torch.full_like(om, 0.05)
    full = tobs._dos_trace_launch(H, w, om, eta, 0.5, tobs.DOS_GRID_CAP)
    assert torch.equal(full, tobs._dos_trace_launch(H, w, om, eta, 0.5, 3))
    want = tobs.dos_trace_weighted_sum_plain(H, w, om, eta, 0.5)
    assert float((full - want).abs().max() / want.abs().max()) <= 1e-10


def _eig_grid(rng, m, npt, d, device):
    """A band-major grid (m, npt^d) of smooth periodic bands with exact
    ties (a cosine band) beside random ones."""
    x = np.meshgrid(*[np.arange(npt) / npt] * d, indexing="ij")
    bands = [sum(np.cos(2 * np.pi * xi) for xi in x)]
    for _ in range(m - 1):
        ph = rng.random(d)
        bands.append(sum(rng.normal() * np.cos(2 * np.pi * (xi + p)) for xi, p in zip(x, ph)) + rng.normal())
    return torch.as_tensor(np.stack([b.reshape(-1) for b in bands]), device=device).contiguous()


@pytest.mark.gpu
@pytest.mark.parametrize("d,npt,m", [(1, 997, 2), (2, 61, 3), (3, 23, 2)])
@pytest.mark.parametrize("nos", [False, True], ids=["dos", "nos"])
def test_tetra_kernel_matches_plain_on_card(cuda_device, d, npt, m, nos):
    """K10 against its plain version on a ragged tile and 1100 energies (a
    ragged lane group, corner energies, energies outside the bands); zero
    outside the bands and bit-identical on repeat."""
    rng = np.random.default_rng(d * 10 + m)
    eg = _eig_grid(rng, m, npt, d, cuda_device)
    lo, hi = float(eg.min()), float(eg.max())
    E = torch.linspace(lo - 1, hi + 1, 1100, dtype=torch.float64, device=cuda_device)
    E[:5] = eg.reshape(-1)[:5]  # energies at grid values
    tol, vol = 1e-9 * (hi - lo), 1.0 / (len(ttet._SIMPLICES[d]) * npt**d)
    before = ttet.tetra_dos.launches
    got = ttet.tetra_dos(eg, d, E, tol, vol, nos)
    assert ttet.tetra_dos.launches == before + 1
    want = ttet.tetra_dos_plain(eg, d, E, tol, vol, nos)
    assert float((got - want).abs().max() / want.abs().max()) <= 1e-12
    assert torch.equal(got, ttet.tetra_dos(eg, d, E, tol, vol, nos))
    outside = (E < lo) if nos else ((E < lo) | (E > hi))
    assert torch.all(got[outside] == 0.0)
    if nos:
        assert torch.all((got[E > hi] - m).abs() <= 1e-12 * m)


@pytest.mark.gpu
@pytest.mark.parametrize("d,npt,m", [(1, 997, 2), (2, 61, 3), (3, 23, 2), (3, 16, 3)])
@pytest.mark.parametrize("nos", [False, True], ids=["dos", "nos"])
def test_tetra_kernel_takes_energies_in_any_order_on_card(cuda_device, d, npt, m, nos):
    """K10 at 1001 energies in no order, with repeats, grid eigenvalues and
    energies outside every band, then at one to four of them (a Fermi-level
    step's one energy and the term-by-term kernel's few, unsorted and
    repeated): 1e-12 relative against the plain version, bit-identical
    repeats, a repeated energy the same bits at each of its places; the DOS
    exactly 0 outside the bands, N(E) exactly 0 below them and, above them,
    the plain version's bits (the band count to 1e-12)."""
    rng = np.random.default_rng(900 + 10 * d + m)
    eg = _eig_grid(rng, m, npt, d, cuda_device)
    lo, hi = float(eg.min()), float(eg.max())
    E = torch.linspace(lo - 1, hi + 1, 1001, dtype=torch.float64, device=cuda_device)
    E[:7] = eg.reshape(-1)[rng.integers(0, eg.numel(), 7)]  # grid eigenvalues
    eig = float(E[0])
    E[7:12] = E[500]  # repeats
    twice = float(E[500])
    E = E[torch.as_tensor(rng.permutation(1001), device=cuda_device)].contiguous()
    tol, vol = 1e-9 * (hi - lo), 1.0 / (len(ttet._SIMPLICES[d]) * npt**d)
    before = ttet.tetra_dos.launches
    got = ttet.tetra_dos(eg, d, E, tol, vol, nos)
    assert ttet.tetra_dos.launches == before + 1
    want = ttet.tetra_dos_plain(eg, d, E, tol, vol, nos)
    scale = float(want.abs().max())
    assert float((got - want).abs().max()) <= 1e-12 * scale
    assert torch.equal(got, ttet.tetra_dos(eg, d, E, tol, vol, nos))
    rep = got[E == twice]
    assert rep.numel() == 6 and torch.all(rep == rep[0])
    below, above = E < lo, E > hi
    assert torch.all(got[below] == 0.0)
    if nos:
        assert torch.equal(got[above], want[above])
        assert torch.all((got[above] - m).abs() <= 1e-12 * m)
    else:
        assert torch.all(got[above] == 0.0)
    i_eig, i_rep = int(torch.nonzero(E == eig)[0]), int(torch.nonzero(E == twice)[0])
    i_lo, i_hi = int(torch.nonzero(below)[0]), int(torch.nonzero(above)[0])
    for idx in ([0], [i_rep], [i_lo], [i_hi], [i_rep, i_lo], [i_hi, i_rep, i_eig], [i_hi, i_rep, i_lo, i_rep]):
        few = E[idx].contiguous()
        g1 = ttet.tetra_dos(eg, d, few, tol, vol, nos)
        w1 = ttet.tetra_dos_plain(eg, d, few, tol, vol, nos)
        assert float((g1 - w1).abs().max()) <= 1e-12 * scale
        assert torch.equal(g1, ttet.tetra_dos(eg, d, few, tol, vol, nos))
        assert torch.all(g1[few < lo] == 0.0)
        if not nos:
            assert torch.all(g1[few > hi] == 0.0)
        rep = g1[few == twice]
        assert rep.numel() == 0 or torch.all(rep == rep[0])


@pytest.mark.gpu
@pytest.mark.parametrize("kind", ["FBZ", "CubicSymIBZ"])
def test_ltm_on_card_matches_cpu(cuda_device, kind):
    """The init on the card (grid products, K9, the scatter) gives the CPU's
    eigenvalue grid to rounding; on that same grid the card's sweeps and
    Fermi level (K10) match the CPU's. (With each device's own grid, ulp
    differences at exact band ties move N(E) through the reference's
    ``_safe(e2 - e1)`` middle piece, ROADMAP C.)"""
    Es = np.linspace(-3.5, 3.5, 57)
    caches = []
    for dev in ("cpu", cuda_device):
        alg = tdos.LTM(npt=24)
        caches.append(tdos.init(T.DOSProblem(ttb.tb_integer(3, device=dev), 0.0,
                                             T.load_bz(getattr(T, kind)(), np.eye(3))), alg))
    cpu, card = (c.cacheval for c in caches)
    assert cpu["numevals"] == card["numevals"] and cpu["tol"] == pytest.approx(card["tol"], rel=1e-12)
    assert float((card["eg"].cpu() - cpu["eg"]).abs().max()) <= 1e-14
    card["eg"] = cpu["eg"].to(cuda_device)
    out = [(alg.dos_sweep(cv, Es), alg.nos_sweep(cv, Es), alg.fermi_level(cv, 0.3)) for cv in (cpu, card)]
    (dc, nc, fc), (dg, ng, fg) = out
    assert rel_err(dg, dc) <= 1e-12 and rel_err(ng, nc) <= 1e-12
    assert abs(fg - fc) <= 1e-10


@pytest.mark.gpu
@pytest.mark.parametrize("m", [1, 2, 3])
@pytest.mark.parametrize("W", [1, 2, 4, 8, 11])
def test_leaf_dos_block_entry_matches_plain_on_card(cuda_device, m, W):
    """K4 over an omega block: one channel group up to 8, groups of 8 above
    (W = 11 re-evaluates the series for its second group)."""
    rng = np.random.default_rng(80 + m + W)
    c, cmap, off, a, b, om, eta, active = _leaf_inputs(rng, cuda_device, m, L=700)
    omb = (om[:, None] + torch.as_tensor(rng.uniform(-0.3, 0.3, (700, W)), device=cuda_device)).contiguous()
    etab = torch.full_like(omb, 0.05)
    xk, wk, wg = tad.gk_rule(7, cuda_device)
    before = tobs.gk_leaf_dos.launches
    got = tobs.gk_leaf_dos(c, cmap, off, 1.0, a, b, omb, etab, active, xk, wk, wg)
    assert tobs.gk_leaf_dos.launches == before + 1
    want = tobs.gk_leaf_dos_plain(c, cmap, off, 1.0, a, b, omb, etab, active, xk, wk, wg)
    assert got[0].shape == (700, 2, W)
    l1 = want[2]
    assert torch.all((got[0] - want[0]).abs() <= 1e-12 * l1[..., None] + 1e-300)
    assert torch.all((got[1] - want[1]).abs() <= 1e-12 * l1 + 1e-300)
    assert torch.allclose(got[2], l1, rtol=1e-12, atol=0) and torch.equal(got[3], want[3])
    if W == 1:  # one frequency per lane is the one-channel block, bit for bit
        one = tobs.gk_leaf_dos(c, cmap, off, 1.0, a, b, omb[:, 0].contiguous(), etab[:, 0].contiguous(),
                               active, xk, wk, wg)
        assert torch.equal(got[0][..., 0], one[0]) and torch.equal(got[1], one[1]) and torch.equal(got[2], one[2])


POOL_FIELDS = ("a", "b", "err", "l1", "val", "n", "evals", "tot_val", "tot_err", "tol", "active")


def _solve_problem(rng, dev, m, W, L=300):
    """Leaf lanes for the fused solve: _leaf_inputs' series, a tenth of them
    constant (every node the same value, so equal-width intervals tie
    exactly), W frequencies a lane, tolerances from 1e-7 down to 1e-300
    (lanes that finish at different trips, and lanes that only cap or the
    budget stop)."""
    c, cmap, off, _, _, om, _, _ = _leaf_inputs(rng, dev, m, L=L)
    c[::10] = 0
    c[::10, c.shape[1] // 2] = torch.as_tensor(random_hermitian(rng, 1, m)[0].reshape(-1), device=dev)
    omb = (om[:, None] + torch.as_tensor(rng.uniform(-0.3, 0.3, (L, W)), device=dev)).contiguous()
    if W == 1:
        omb = omb[:, 0].contiguous()
    etab = torch.full_like(omb, 0.05)
    segs = torch.tensor([0.0, 1.0], dtype=torch.float64, device=dev).expand(L, 2).contiguous()
    atol = torch.as_tensor(10.0 ** rng.uniform(-7, -2, L), device=dev)
    atol[::7] = 1e-300
    return c, cmap, off, 1.0, omb, etab, segs, atol


def _started_pool(problem, dev, cap, nbisect, maxiters=None, init_pool=None):
    """The pool of a leaf-level solve after its start (K4's cold start, or
    K6 and K5's seed entry from ``init_pool``), taken through the solve hook
    of gk_adaptive_lanes before any trip."""
    c, cmap, off, period, om, eta, segs, atol = problem
    xk, wk, wg = tad.gk_rule(7, dev)
    rule = tobs.leaf_dos_rule(c, cmap, off, period, om, eta, xk, wk, wg, tobs.gk_leaf_dos)
    held = []
    tad.gk_adaptive_lanes(rule, segs, atol, cap=cap, nbisect=nbisect, rtol=0.0, maxiters=maxiters,
                          init_pool=init_pool, solve=lambda pool, nb: held.append(_clone_pool(pool)))
    return held[0], (xk, wk, wg)


@pytest.mark.gpu
@pytest.mark.parametrize("start", ["cold", "seeded"])
@pytest.mark.parametrize("W", [1, 2, 3, 4, 5, 6, 7, 9])
@pytest.mark.parametrize("m", [1, 2, 3])
def test_leaf_solve_matches_the_trip_route_on_card(cuda_device, m, W, start):
    """The fused leaf solve against the trip route (K5's select, K4, K5's
    update until no lane is live) on the same started pools: pools, totals,
    n, evals, active and every lane's trips torch.equal; a fifth of the
    lanes inactive, planted ties, lanes stopped by cap. Every channel group
    K4 compiles (1-8, and two groups at 9) against the solve's one path."""
    rng = np.random.default_rng(300 + 10 * m + W)
    problem = _solve_problem(rng, cuda_device, m, W)
    init = None
    if start == "seeded":
        init = dyadic_pools(rng, problem[6].shape[0], 64, [0.0, 0.5, 1.0], cuda_device)
    pool, rule = _started_pool(problem, cuda_device, 64, 4, init_pool=init)
    pool.active[::5] = False
    ref = _clone_pool(pool)
    c, cmap, off, period, om, eta = problem[:6]
    before = tobs.gk_leaf_dos_solve.launches
    trips = tobs.gk_leaf_dos_solve(pool, c, cmap, off, period, om, eta, *rule, 4)
    assert tobs.gk_leaf_dos_solve.launches == before + 1
    want = tobs.gk_leaf_dos_solve_plain(ref, c, cmap, off, period, om, eta, *rule, 4, kernels=True)
    stats = tad.LoopStats()
    stats.device_trip(1, trips)
    assert torch.equal(trips, want) and stats.read_device_trips() == {1: int(want.max())}
    for k in POOL_FIELDS:
        assert torch.equal(getattr(pool, k), getattr(ref, k)), k
    assert int(want.min()) == 0 and int(want.max()) > int(want[want > 0].min())  # lanes end at different trips
    assert bool((pool.n[::7] > 64 - 4).any())  # lanes that only cap stopped


@pytest.mark.gpu
@pytest.mark.parametrize("m,W", [(3, 1), (2, 9)])
def test_leaf_solve_stops_at_the_budget_as_the_trip_route_on_card(cuda_device, m, W):
    """An evaluation budget that stops lanes at different trips (seeded
    pools start from different counts)."""
    rng = np.random.default_rng(330 + m + W)
    problem = _solve_problem(rng, cuda_device, m, W, L=200)
    init = dyadic_pools(rng, 200, 64, [0.0, 0.5, 1.0], cuda_device)
    pool, rule = _started_pool(problem, cuda_device, 64, 4, maxiters=1500, init_pool=init)
    ref = _clone_pool(pool)
    c, cmap, off, period, om, eta = problem[:6]
    trips = tobs.gk_leaf_dos_solve(pool, c, cmap, off, period, om, eta, *rule, 4)
    want = tobs.gk_leaf_dos_solve_plain(ref, c, cmap, off, period, om, eta, *rule, 4, kernels=True)
    assert torch.equal(trips, want)
    for k in POOL_FIELDS:
        assert torch.equal(getattr(pool, k), getattr(ref, k)), k
    assert bool((pool.evals >= 1500).any())


@pytest.mark.gpu
def test_leaf_solve_refuses_what_it_does_not_take_on_card(cuda_device):
    rng = np.random.default_rng(340)
    problem = _solve_problem(rng, cuda_device, 2, 1, L=8)
    pool, rule = _started_pool(problem, cuda_device, 16, 2)
    c, cmap, off, period, om, eta = problem[:6]
    with pytest.raises(ValueError):  # 65 bisections a trip
        tobs.gk_leaf_dos_solve(pool, c, cmap, off, period, om, eta, *rule, 65)
    big = torch.zeros((8, 5, 16), dtype=torch.complex128, device=cuda_device)
    with pytest.raises(ValueError):  # four bands
        tobs.gk_leaf_dos_solve(pool, big, cmap, off, period, om, eta, *rule, 2)
    assert not tobs.leaf_solve_takes(cuda_device, 1 << 14, 9, 4, 15, 5, 3)  # a pool past shared memory


@pytest.mark.gpu
@pytest.mark.parametrize("W", [2, 4])
def test_pool_kernels_at_block_width_on_card(cuda_device, W):
    """K5's start and step (reduced children, then node values) and the
    rule reduction with V = W channels."""
    rng = np.random.default_rng(90 + W)
    pool = _random_pool(rng, cuda_device, L=900, cap=64, nb=4, V=(W,))
    ref = _clone_pool(pool)
    tad.gk_pool_start(pool, 4)
    tad.gk_pool_start_plain(ref, 4)
    _assert_pools_match(pool, ref)
    cval = torch.as_tensor(rng.normal(size=(900, 8, W)), device=cuda_device)
    cerr = torch.as_tensor(rng.random((900, 8)), device=cuda_device)
    count = torch.full((900,), 120.0, dtype=torch.float64, device=cuda_device)
    kids = tad.ReducedChildren(cval, cerr, cerr, count)
    tad.gk_pool_step(pool, 4, kids)
    tad.gk_pool_step_plain(ref, 4, kids)
    _assert_pools_match(pool, ref)
    kids = _node_children(rng, ref, ref.active.nonzero().squeeze(1))
    tad.gk_pool_step(pool, 4, kids)
    tad.gk_pool_step_plain(ref, 4, _reduced_on_card(kids))
    _assert_pools_match(pool, ref)
    fx = torch.as_tensor(rng.normal(size=(300, 2, 15, W)), device=cuda_device)
    half = torch.as_tensor(rng.random((300, 2)), device=cuda_device)
    _, wk, wg = tad.gk_rule(7, cuda_device)
    got, want = tad.gk_rule_reduce(fx, None, half, wk, wg), tad.gk_rule_reduce_plain(fx, None, half, wk, wg)
    for g, w in zip(got[:3], want[:3]):
        assert float((g - w).abs().max()) <= 1e-12 * float(want[2].max())


@pytest.mark.gpu
@pytest.mark.parametrize("warm", [False, True], ids=["cold", "warm"])
def test_block_iai_on_card_matches_cpu(cuda_device, warm):
    """The omega-block nest through K3, K4 over the block and K5 against the
    CPU's plain path: identical counts and block certificates."""
    oms = np.array([-1.3, -1.1, 0.4, 0.55, 2.1])
    out = []
    for dev in ("cpu", cuda_device):
        prob = T.IntegralProblem(tobs.dos_integrand(ttb.tb_integer(3, device=dev), 0.3),
                                 T.load_bz(T.FBZ(), np.eye(3)))
        sweep = SweepSolver(prob, T.IAI(inner_cap=32, inner_nbisect=2, device=dev), abstol=1e-3,
                            chunk=4, scan=True, block=2, warm=warm)
        before = tobs.gk_leaf_dos.launches
        out.append((sweep(oms), sweep.numevals, sweep.retcode, sweep.block_certificates))
        if dev == cuda_device:
            assert tobs.gk_leaf_dos.launches > before
    (vc, nc, rc, bcc), (vg, ng, rg, bcg) = out
    assert ng == nc and rg is rc is True
    assert np.array_equal(bcg[0], bcc[0]) and np.array_equal(bcg[1], bcc[1])
    assert rel_err(vg, vc) <= 1e-10


@pytest.mark.gpu
@pytest.mark.parametrize("d,vshape,box", [
    (1, (), None), (2, (2, 2), None), (3, (3, 3), None), (3, (5, 5), None),
    # the tensor-core tiles' edges: V = 1, V = 4, V = 900 (R = 4: 100
    # column tiles), 105 rows in a (3, 5, 7) box (no whole k-slab)
    (3, (), None), (3, (2, 2), None), (2, (30, 30), (3, 4)), (3, (3, 3), (3, 5, 7)),
])
def test_jacobian_kernel_matches_plain_on_card(cuda_device, d, vshape, box):
    """K11 against its plain version for R = 1..d + 1 outputs (one-hot,
    second and mixed orders, an order 2 among four outputs), negative
    offsets and periods other than 1, V beyond the value chunk (25 values)
    and up to 900, a point count off the 64-point tile; bit-identical on
    repeat; at R = 1 and order zero K1's bits."""
    from autobzcore_torch.ops import fourier_eval as tfe

    rng = np.random.default_rng(110 + d)
    shape = (tuple(rng.integers(3, 7, size=d)) if box is None else tuple(box)) + vshape
    c = torch.as_tensor(rng.normal(size=shape) + 1j * rng.normal(size=shape), device=cuda_device)
    off, per = tuple(int(o) for o in rng.integers(-3, 1, size=d)), tuple(rng.uniform(0.5, 2.0, size=d))
    X = torch.as_tensor(rng.random((5000, d)) * 2.0, device=cuda_device)
    jac = tfe.jacobian_orders(d)
    four = ((0,) * d, (2,) + (0,) * (d - 1), (1,) * d, (0,) * (d - 1) + (3,))  # an order 2 among R = 4
    for orders in (jac, jac[:2], ((2,) + (0,) * (d - 1),), ((1,) * d,), four):
        before = tfe.fourier_points_derivs.launches
        got = tfe.fourier_points_derivs(c, X, off, per, orders)
        assert tfe.fourier_points_derivs.launches == before + 1
        want = tfe.fourier_points_derivs_plain(c, X, off, per, orders)
        assert got.shape == (5000, len(orders)) + vshape
        assert float((got - want).abs().max() / want.abs().max()) <= 1e-12
        assert torch.equal(got, tfe.fourier_points_derivs(c, X, off, per, orders))
        assert torch.equal(got[37:], tfe.fourier_points_derivs(c, X[37:].contiguous(), off, per, orders))
    zero = tfe.fourier_points_derivs(c, X, off, per, ((0,) * d,))[:, 0]
    assert torch.equal(zero, fourier_points(c, X, off, per))


@pytest.mark.gpu
@pytest.mark.parametrize("m", [1, 3, 30, 60])
def test_band_velocity_kernel_matches_plain_on_card(cuda_device, m):
    """K12 on eigenvectors of random Hermitian matrices and a strided dH
    view (as K11's output gives it): m = 1, 3 (several points per block),
    30 (the bands30 shape) and 60 (eigenvectors read through L1)."""
    from autobzcore_torch.dos import ggr as tggr

    rng = np.random.default_rng(120 + m)
    K = 700 if m < 60 else 90
    H = torch.as_tensor(random_hermitian(rng, K, m), device=cuda_device)
    U = torch.linalg.eigh(H)[1].contiguous()
    J = torch.as_tensor(np.stack([random_hermitian(rng, K, m) for _ in range(4)], axis=1), device=cuda_device)
    dH = J[:, 1:]
    before = tggr.band_velocity.launches
    got = tggr.band_velocity(U, dH)
    assert tggr.band_velocity.launches == before + 1
    want = tggr.band_velocity_plain(U, dH)
    assert float((got - want).abs().max() / want.abs().max()) <= 1e-12
    assert torch.equal(got, tggr.band_velocity(U, dH))


@pytest.mark.gpu
@pytest.mark.parametrize("mode", [1, 2, 3, 0], ids=["box1d", "box2d", "box3d", "gauss"])
def test_ggr_sum_kernel_matches_plain_on_card(cuda_device, mode):
    """K13 in box mode (d = 1, 2, 3, with gated terms, ties between |v|
    components and a velocity component at rounding level) and in Gaussian
    mode, against its plain version at 1100 energies (a ragged lane group),
    bit-identical on repeat."""
    from autobzcore_torch.dos import ggr as tggr

    rng = np.random.default_rng(130 + mode)
    K, m = 3001, 3
    e = torch.as_tensor(rng.normal(size=(K, m)), device=cuda_device)
    w = torch.as_tensor(rng.integers(1, 5, size=K).astype(float), device=cuda_device)
    E = torch.linspace(-4, 4, 1100, dtype=torch.float64, device=cuda_device)
    if mode:
        v = rng.normal(size=(K, mode, m)) * 3
        v[:50] = 0.0  # gated off
        if mode > 1:
            v[50:100, 1] = v[50:100, 0]  # ties
            v[100:150, -1] = 1e-15  # rounding level
        v = torch.as_tensor(v, device=cuda_device)
        args = (e, v, w, E, 0.02, 1e-10)
        fn, plain, count = tggr.ggr_box_sum, tggr.ggr_box_sum_plain, lambda: tggr.ggr_box_sum.launches
    else:
        sigma = torch.as_tensor(rng.uniform(0.001, 0.3, size=(K, m)), device=cuda_device)
        args = (e, sigma, 1.0 / (np.sqrt(2 * np.pi) * sigma), w, E, 1.0 / float(w.sum()))
        fn, plain, count = tggr.gaussian_sum, tggr.gaussian_sum_plain, lambda: tggr.gaussian_sum.launches
    before = count()
    got = fn(*args)
    assert count() == before + 1
    want = plain(*args)
    assert float((got - want).abs().max() / want.abs().max()) <= 1e-12
    assert torch.equal(got, fn(*args))


@pytest.mark.gpu
@pytest.mark.parametrize("energies", ["unsorted", "one", "four"])
@pytest.mark.parametrize("mode", [1, 2, 3, 0], ids=["box1d", "box2d", "box3d", "gauss"])
def test_ggr_sum_kernel_takes_any_energies_on_card(cuda_device, mode, energies):
    """K13 against its plain version on energies in any order: 700 shuffled
    with 9 repeats and two beyond every band (exactly 0 there), and the
    few-energy path at one and at four energies (a repeat and one beyond
    the bands among them); gated terms in box mode, terms centred on an
    energy with a tiny sigma in Gaussian mode; within 1e-12 of max|D|,
    bit-identical on repeat."""
    from autobzcore_torch.dos import ggr as tggr

    rng = np.random.default_rng(140 + mode)
    K, m = 2001, 3
    grid = np.linspace(-4, 4, 700)
    e = rng.normal(size=(K, m))
    e[:40, 0] = grid[rng.integers(0, 700, 40)]  # terms centred on energies of the grid
    E = {"unsorted": np.concatenate([rng.permutation(grid), grid[rng.integers(0, 700, 9)], [-60.0, 60.0]]),
         "one": e[:1, 0], "four": np.array([e[0, 0], 0.3, e[0, 0], -60.0])}[energies]
    put = lambda a: torch.as_tensor(np.ascontiguousarray(a), device=cuda_device)  # noqa: E731
    e, E = put(e), put(E)
    w = put(rng.integers(1, 5, size=K).astype(float))
    if mode:
        v = rng.normal(size=(K, mode, m)) * 3
        v[40:90] = 0.0  # gated off
        args = (e, put(v), w, E, 0.02, 1e-10)
        fn, plain = tggr.ggr_box_sum, tggr.ggr_box_sum_plain
    else:
        sigma = rng.uniform(0.001, 0.3, size=(K, m))
        sigma[:40, 0] = 1e-7
        sigma = put(sigma)
        args = (e, sigma, 1.0 / (np.sqrt(2 * np.pi) * sigma), w, E, 1.0 / float(w.sum()))
        fn, plain = tggr.gaussian_sum, tggr.gaussian_sum_plain
    got, again, want = fn(*args), fn(*args), plain(*args)
    assert got.shape == E.shape
    assert float((got - want).abs().max()) <= 1e-12 * float(want.abs().max())
    assert torch.equal(got, again)
    if energies != "one":
        assert float(got[-1]) == 0.0


@pytest.mark.gpu
@pytest.mark.parametrize("alg", ["GGR", "AGB"])
def test_spectral_dos_on_card_matches_cpu(cuda_device, alg):
    """GGR and AGB with the init (K11, eigh, K12) and the sweep (K13) on the
    card against the CPU's: graphene on the full zone, the 2-D integer
    lattice on its inversion wedge, and a random 3-band 3-D series (no
    symmetric k-point where the 3-D closed form cancels, ROADMAP C8)."""
    from torch_parity import hermitian_series_arrays

    from autobzcore_torch.interop import series_from_arrays

    C, off = hermitian_series_arrays(seed=11)
    models = {"graphene": (lambda dev: ttb.tb_graphene(device=dev), "FBZ", 2, 60),
              "int2d": (lambda dev: ttb.tb_integer(2, device=dev), "InversionSymIBZ", 2, 60),
              "random3d": (lambda dev: series_from_arrays(C, off, 1.0, 3, device=dev), "FBZ", 3, 16)}
    for make, kind, d, npt in models.values():
        Es = np.linspace(-5.0, 5.0, 211)
        out = []
        for dev in ("cpu", cuda_device):
            a = T.GGR(npt=npt) if alg == "GGR" else tdos.AdaptiveGaussianBroadening(npt=npt)
            out.append(a.dos_sweep(a.init_cacheval(make(dev), 0.0, T.load_bz(getattr(T, kind)(), np.eye(d))), Es))
        assert rel_err(out[1], out[0]) <= 1e-10


@pytest.mark.gpu
def test_jacobian_integrands_on_card_match_cpu(cuda_device):
    """PTR (the (H, V) pair at the rule points by K11) and IAI (d + 1
    stacked channels contracted by K3) over a JacobianSeries integrand, on
    the card against the CPU: values within 1e-10, the same counts."""
    from autobzcore_torch.ops import fourier_eval as tfe

    def vdos(hv, om=None, eta=None):
        h, v = hv.s
        g = 1.0 / ((om + 1j * eta) - h[..., 0, 0])
        return -(g.imag * (v[0][..., 0, 0].real ** 2 + 1.0)) / np.pi

    sols = []
    before = tfe.fourier_points_derivs.launches
    for dev in ("cpu", cuda_device):
        s = T.JacobianSeries(ttb.tb_integer(2, device=dev))
        prob = T.IntegralProblem(T.FourierIntegrand(vdos, s, eta=0.3), T.load_bz(T.FBZ(), np.eye(2)),
                                 T.MixedParameters(om=0.4))
        sols.append((T.solve(prob, T.PTR(npt=64, device=dev)),
                     T.solve(prob, T.IAI(inner_cap=64, device=dev), abstol=1e-4)))
    assert tfe.fourier_points_derivs.launches == before + 1
    for cpu, card in zip(*sols):
        assert abs(float(card.u) - float(cpu.u)) <= 1e-10 * abs(float(cpu.u))
        assert card.numevals == cpu.numevals and card.retcode == cpu.retcode


# --- K14-K17: the Genz-Malik box rule and pool, fixed rules ------------------------------
def _gm_boxes(rng, dev, K, d, dead):
    """K boxes in [0, 1]^d (centres, halves) with the slots ``dead`` dead
    (centre 0, half 0), and the rule's nodes and volumes."""
    from autobzcore_torch.ops import genz_malik as tgm

    c = rng.uniform(0.3, 0.7, (K, d))
    h = rng.uniform(0.01, 0.25, (K, d))
    c[dead], h[dead] = 0.0, 0.0
    rule = tgm.gm_rule_tensors(d, dev)
    nodes, vol = tgm.gm_box_nodes(torch.as_tensor(c, device=dev), torch.as_tensor(h, device=dev),
                                  rule[0])
    return nodes, vol.contiguous(), rule


def test_box_wrappers_take_plain_versions_on_cpu_without_counting():
    from autobzcore_torch.ops import adaptive as tad
    from autobzcore_torch.ops import genz_malik as tgm

    rng = np.random.default_rng(0)
    nodes, vol, (pts, wk, we, di) = _gm_boxes(rng, "cpu", 6, 3, [2])
    fx = torch.cos(nodes.sum(-1))
    before = (tgm.gm_rule_reduce.launches, tobs.gm_leaf_dos.launches,
              tad.fixed_rule_reduce.launches, dict(tgm.gm_pool_launches))
    got = tgm.gm_rule_reduce(fx, vol, wk, we, di)
    assert all(torch.equal(g, w) for g, w in zip(got, tgm.gm_rule_reduce_plain(fx, vol, wk, we, di)))
    fx2 = torch.as_tensor(rng.normal(size=(2, 3, 5)))
    w5, half = torch.ones(5, dtype=torch.float64), torch.full((2, 3), 0.5, dtype=torch.float64)
    assert torch.equal(tad.fixed_rule_reduce(fx2, w5, half), tad.fixed_rule_reduce_plain(fx2, w5, half))
    assert before == (tgm.gm_rule_reduce.launches, tobs.gm_leaf_dos.launches,
                      tad.fixed_rule_reduce.launches, dict(tgm.gm_pool_launches))
    with pytest.raises(ValueError):
        tgm.gm_rule_reduce(fx.to(torch.float32), vol, wk, we, di)
    with pytest.raises(ValueError):
        tgm.gm_rule_reduce(fx, vol[:5], wk, we, di)
    with pytest.raises(ValueError):
        tgm.gm_rule_reduce(fx, vol, wk, we, di.long())
    with pytest.raises(ValueError):
        tad.fixed_rule_reduce(fx2, w5[:4], half)
    with pytest.raises(ValueError):
        tobs.gm_leaf_dos(torch.zeros(6, 33, 3, 3, dtype=torch.complex64), vol[:6], vol[:6], vol,
                         wk, we, di)


@pytest.mark.gpu
@pytest.mark.parametrize("kind", ["real", "complex", "nan_at_origin"])
def test_box_rule_kernel_matches_plain_on_card(cuda_device, kind):
    """K14 against its plain version on 264 boxes with dead slots: values,
    errors and splitdim bit-equal to the plain version's, dead boxes exactly
    0 (also where the integrand is NaN at the origin; splitdim the first NaN
    where the dead boxes' differences are NaN), repeats bit-identical."""
    from autobzcore_torch.ops import genz_malik as tgm

    rng = np.random.default_rng(140)
    dead = rng.choice(264, 40, replace=False)
    nodes, vol, (pts, wk, we, di) = _gm_boxes(rng, cuda_device, 264, 3, dead)
    x = nodes
    fx = {"real": torch.exp(torch.sin(3 * x[..., 0]) * torch.cos(2 * x[..., 2])),
          "complex": torch.stack([torch.exp(1j * x.sum(-1)), (x * x).sum(-1) + 0j], -1),
          "nan_at_origin": torch.sqrt(x[..., 0] - 0.01) * torch.log(x[..., 1])}[kind].contiguous()
    before = tgm.gm_rule_reduce.launches
    got = tgm.gm_rule_reduce(fx, vol, wk, we, di)
    again = tgm.gm_rule_reduce(fx, vol, wk, we, di)
    want = tgm.gm_rule_reduce_plain(fx, vol, wk, we, di)
    torch.cuda.synchronize()
    assert tgm.gm_rule_reduce.launches == before + 2
    assert all(torch.equal(g, w) for g, w in zip(got, want))
    assert all(torch.equal(g, a) for g, a in zip(got, again))
    assert bool((got[0][torch.as_tensor(dead, device=cuda_device)] == 0).all())
    assert bool(torch.isfinite(got[0]).all() and torch.isfinite(got[1]).all())


@pytest.mark.gpu
@pytest.mark.parametrize("B", [1, 7, 8, 9, 264, 265])
@pytest.mark.parametrize("d", [2, 3])
@pytest.mark.parametrize("kind", ["real", "complex", "channels"])
def test_box_rule_kernel_is_bit_equal_at_any_box_count(cuda_device, B, d, kind):
    """K14 against its plain version, torch.equal on all three outputs, at
    box counts on both sides of its boxes a block (8), in 2-D and 3-D, for
    real, complex and three-channel real values, a box in five dead."""
    from autobzcore_torch.ops import genz_malik as tgm

    rng = np.random.default_rng(1400 + B + 10 * d)
    dead = np.arange(B)[::5]
    nodes, vol, (pts, wk, we, di) = _gm_boxes(rng, cuda_device, B, d, dead)
    x = nodes
    fx = {"real": torch.exp(torch.sin(3 * x[..., 0]) * torch.cos(2 * x[..., -1])),
          "complex": torch.exp(1j * x.sum(-1)) * (1 + x[..., 0]),
          "channels": torch.stack([torch.cos(x.sum(-1)), (x * x).sum(-1), torch.sin(5 * x[..., 1])], -1)}[kind]
    fx = fx.contiguous()
    got = tgm.gm_rule_reduce(fx, vol, wk, we, di)
    want = tgm.gm_rule_reduce_plain(fx, vol, wk, we, di)
    torch.cuda.synchronize()
    assert all(torch.equal(g, w) for g, w in zip(got, want))
    assert bool((got[1][torch.as_tensor(dead, device=cuda_device)] == 0).all())


@pytest.mark.gpu
@pytest.mark.parametrize("d,V,is_complex", [(3, 150, False), (3, 200, False), (3, 100, True),
                                            (3, 1500, False), (2, 320, False)])
def test_box_rule_kernel_is_bit_equal_at_wide_values(cuda_device, d, V, is_complex):
    """K14 on 20 boxes whose values have many channels: at 150 real
    channels its rows are still staged in shared memory (one box a block);
    past that it reads them from device memory, and at 1,500 channels in
    several channel tiles. torch.equal on all three outputs against the
    plain version, dead boxes 0."""
    from autobzcore_torch.ops import genz_malik as tgm

    rng = np.random.default_rng(1500 + V + d)
    dead = np.arange(20)[::6]
    nodes, vol, (pts, wk, we, di) = _gm_boxes(rng, cuda_device, 20, d, dead)
    freq = torch.as_tensor(rng.uniform(0.5, 4.0, V), device=cuda_device)
    phase = nodes.sum(-1)[..., None] * freq + nodes[..., :1]
    fx = (torch.exp(1j * phase) * (1 + nodes[..., -1:]) if is_complex else torch.cos(phase)).contiguous()
    got = tgm.gm_rule_reduce(fx, vol, wk, we, di)
    want = tgm.gm_rule_reduce_plain(fx, vol, wk, we, di)
    torch.cuda.synchronize()
    assert all(torch.equal(g, w) for g, w in zip(got, want))
    assert bool((got[1][torch.as_tensor(dead, device=cuda_device)] == 0).all())
    assert bool((got[0][torch.as_tensor(dead, device=cuda_device)] == 0).all())


@pytest.mark.gpu
@pytest.mark.parametrize("m,W", [(1, 1), (2, 1), (3, 1), (3, 4)])
def test_box_dos_kernel_matches_k1_trace_and_k14_on_card(cuda_device, m, W):
    """K15 against K1 + the plain trace + K14 (and against its own plain
    version) on 33 lanes x 8 boxes with dead boxes: 1e-12 of the value
    scale, splitdim identical, repeats bit-identical."""
    from autobzcore_torch.ops import genz_malik as tgm

    rng = np.random.default_rng(150 + m)
    s = ttb.flagship_series(device=cuda_device) if m == 3 else ttb.synthetic_wannier(
        m, nr=3, seed=m, device=cuda_device)
    B = 33 * 8
    nodes, vol, (pts, wk, we, di) = _gm_boxes(rng, cuda_device, B, 3, rng.choice(B, 30, replace=False))
    H = s.eval_points(nodes.reshape(-1, 3).contiguous()).reshape(B, pts.shape[0], m, m)
    shape = (B, W) if W > 1 else (B,)
    om = torch.as_tensor(rng.uniform(-3, 3, shape), device=cuda_device)
    eta = torch.full(shape, 0.05, dtype=torch.float64, device=cuda_device)
    before = tobs.gm_leaf_dos.launches
    got = tobs.gm_leaf_dos(H, om, eta, vol, wk, we, di)
    again = tobs.gm_leaf_dos(H, om, eta, vol, wk, we, di)
    assert tobs.gm_leaf_dos.launches == before + 2
    D = tobs.dos_trace(T.FourierValue(None, H[:, :, None] if W > 1 else H),
                       om[:, None] if W == 1 else om[:, None, :],
                       eta=eta[:, None] if W == 1 else eta[:, None, :])
    via14 = tgm.gm_rule_reduce(D.contiguous(), vol, wk, we, di)
    plain = tobs.gm_leaf_dos_plain(H, om, eta, vol, wk, we, di)
    torch.cuda.synchronize()
    scale = float(plain[0].abs().max())
    for want in (via14, plain):
        assert float((got[0] - want[0]).abs().max()) <= 1e-12 * scale
        assert float((got[1] - want[1]).abs().max()) <= 1e-12 * scale
        assert torch.equal(got[2], want[2])
    assert all(torch.equal(g, a) for g, a in zip(got, again))


def _random_box_pool(rng, dev, L, cap, d, nb, V=()):
    """Box pools with n live slots of random boxes (some lanes below nbisect,
    dead slots among the live ones), errors from a few values so that ties
    are common, and a few inactive lanes."""
    from autobzcore_torch.ops import genz_malik as tgm

    n = rng.integers(1, cap - nb + 1, L)
    n[: L // 10] = rng.integers(1, nb, L // 10)
    live = np.arange(cap)[None, :] < n[:, None]
    live &= rng.random((L, cap)) > 0.05
    c = np.where(live[..., None], rng.random((L, cap, d)), 0.0)
    h = np.where(live[..., None], rng.random((L, cap, d)) * 0.1, 0.0)
    err = np.where(live, rng.integers(0, 4, (L, cap)) * 0.25, 0.0)
    val = np.where(live.reshape(live.shape + (1,) * len(V)), rng.normal(size=(L, cap) + V), 0.0)
    sd = np.where(live, rng.integers(0, d, (L, cap)), 0).astype(np.int32)
    put = lambda a, dt=torch.float64: torch.as_tensor(a, dtype=dt, device=dev)  # noqa: E731
    pool = tgm.GMPool(c=put(c), h=put(h), err=put(err), sd=put(sd, torch.int32), val=put(val),
                      n=put(n, torch.int64), evals=put(rng.integers(0, 50000, L).astype(float)),
                      atol=put(rng.random(L) * 4), rtol=1e-3, max_evals=40000.0, npts=33,
                      active=put(rng.random(L) > 0.05, torch.bool))
    tgm.gm_pool_totals_plain(pool, nb)
    return pool


@pytest.mark.gpu
@pytest.mark.parametrize("V", [(), (2,)])
def test_box_pool_kernels_match_plain_on_card(cuda_device, V):
    """K16's start and step against the plain route (totals, select; then
    update, select) on 33 lanes x cap 4096 x d = 3 with planted equal
    errors and V value fields: lax.top_k's tie order (the lower slot),
    identical picks, children and pools, totals within 1e-14, the same loop
    test."""
    from autobzcore_torch.ops import genz_malik as tgm

    rng = np.random.default_rng(160 + len(V))
    L, cap, d, nb = 33, 4096, 3, 4
    pool = _random_box_pool(rng, cuda_device, L, cap, d, nb, V)
    ref = pool.clone()
    tgm.gm_pool_begin(pool, nb)
    tgm.gm_pool_begin_plain(ref, nb)
    assert torch.equal(pool.active, ref.active)
    assert torch.equal(pool.idx, ref.idx) and torch.equal(pool.cc, ref.cc) and torch.equal(pool.hh, ref.hh)
    cval = torch.as_tensor(rng.normal(size=(L, 2 * nb) + V), device=cuda_device)
    cerr = torch.as_tensor(rng.random((L, 2 * nb)), device=cuda_device)
    csd = torch.as_tensor(rng.integers(0, d, (L, 2 * nb)).astype(np.int32), device=cuda_device)
    tgm.gm_pool_step(pool, nb, cval, cerr, csd)
    tgm.gm_pool_step_plain(ref, nb, cval, cerr, csd)
    for name in ("c", "h", "err", "sd", "val", "n", "evals", "active", "idx", "cc", "hh"):
        assert torch.equal(getattr(pool, name), getattr(ref, name)), name
    for name in ("tot_val", "tot_err", "tol"):
        g, w = getattr(pool, name), getattr(ref, name)
        assert float(((g - w).abs() / w.abs().clamp_min(1e-300)).max()) <= 1e-14, name


def _same_pools(a, b, totals_rel=None):
    """The pools' arrays, picks and children identical; the totals identical
    too, or within totals_rel: tot_err and tol (sums of non-negative terms)
    lane by lane, tot_val (random values that cancel, summed in another
    order by the plain version) of the largest |tot_val|."""
    for name in ("c", "h", "err", "sd", "val", "n", "evals", "active", "idx", "cc", "hh"):
        assert torch.equal(getattr(a, name), getattr(b, name)), name
    for name in ("tot_val", "tot_err", "tol"):
        g, w = getattr(a, name), getattr(b, name)
        if totals_rel is None:
            assert torch.equal(g, w), name
        elif name == "tot_val":
            assert float((g - w).abs().max()) <= totals_rel * float(w.abs().max()), name
        else:
            assert float(((g - w).abs() / w.abs().clamp_min(1e-300)).max()) <= totals_rel, name


@pytest.mark.gpu
@pytest.mark.parametrize("nb", [1, 4, 64])
def test_box_pool_step_matches_plain_on_card(cuda_device, nb):
    """K16's start and three steps (the route of a TAI trip) against the
    plain route (update, then select) on 33 lanes x cap 4096 x d = 3: tied
    errors, dead slots, lanes with fewer live boxes than nbisect and a few
    inactive ones; identical picks, children and pools, totals within
    1e-14; a second run bit-identical."""
    from autobzcore_torch.ops import genz_malik as tgm

    rng = np.random.default_rng(190 + nb)
    L, cap, d = 33, 4096, 3
    start = _random_box_pool(rng, cuda_device, L, cap, d, min(max(nb, 2), 8))
    kern, plain, again = start.clone(), start.clone(), start.clone()
    before = dict(tgm.gm_pool_launches)
    tgm.gm_pool_begin(kern, nb)
    tgm.gm_pool_begin(again, nb)
    tgm.gm_pool_begin_plain(plain, nb)
    _same_pools(kern, plain, 1e-14)
    for _ in range(3):
        cval = torch.as_tensor(rng.normal(size=(L, 2 * nb)), device=cuda_device)
        cerr = torch.as_tensor(rng.random((L, 2 * nb)) * 0.5, device=cuda_device)
        csd = torch.as_tensor(rng.integers(0, d, (L, 2 * nb)).astype(np.int32), device=cuda_device)
        for pool in (kern, again):
            tgm.gm_pool_step(pool, nb, cval, cerr, csd)
        tgm.gm_pool_step_plain(plain, nb, cval, cerr, csd)
        _same_pools(kern, plain, 1e-14)
        _same_pools(kern, again)
    assert tgm.gm_pool_launches["begin"] == before["begin"] + 2
    assert tgm.gm_pool_launches["step"] == before["step"] + 6


@pytest.mark.gpu
def test_box_pool_step_guards_out_of_range_picks(cuda_device):
    """A step whose picks lie outside the lane's slots writes nothing to
    that lane's pool, sets its totals to NaN and stops it; the other lanes
    step as the plain route does."""
    from autobzcore_torch.ops import genz_malik as tgm

    rng = np.random.default_rng(199)
    L, cap, d, nb = 8, 256, 2, 4
    pool = _random_box_pool(rng, cuda_device, L, cap, d, nb)
    pool.active.fill_(True)
    tgm.gm_pool_begin(pool, nb)
    ok = pool.active.clone()
    ok[:2] = False
    pool.idx[0, 1] = cap
    pool.idx[1, 0] = -1
    ref, snap = pool.clone(), pool.clone()
    ref.active.copy_(ok)
    cval = torch.as_tensor(rng.normal(size=(L, 2 * nb)), device=cuda_device)
    cerr = torch.as_tensor(rng.random((L, 2 * nb)), device=cuda_device)
    csd = torch.as_tensor(rng.integers(0, d, (L, 2 * nb)).astype(np.int32), device=cuda_device)
    tgm.gm_pool_step(pool, nb, cval, cerr, csd)
    tgm.gm_pool_step_plain(ref, nb, cval, cerr, csd)
    for name in ("c", "h", "err", "sd", "val", "n", "evals"):
        assert torch.equal(getattr(pool, name)[:2], getattr(snap, name)[:2]), name
        assert torch.equal(getattr(pool, name)[2:], getattr(ref, name)[2:]), name
    assert bool(torch.isnan(pool.tot_err[:2]).all()) and bool(torch.isnan(pool.tot_val[:2]).all())
    assert not bool(pool.active[:2].any()) and torch.equal(pool.active[2:], ref.active[2:])
    assert not bool(pool.cc[:2].any()) and torch.equal(pool.idx[2:], ref.idx[2:])


@pytest.mark.gpu
def test_box_pool_tie_order_on_card(cuda_device):
    """Every live error equal: K16's start picks the lowest slots, in slot
    order."""
    from autobzcore_torch.ops import genz_malik as tgm

    pool = _random_box_pool(np.random.default_rng(170), cuda_device, 4, 256, 2, 4)
    pool.err.fill_(0.5)
    pool.active.fill_(True)
    pool.atol.zero_()
    pool.max_evals = 1e300
    tgm.gm_pool_begin(pool, 4)
    assert bool(pool.active.all())
    assert torch.equal(pool.idx.cpu(), torch.arange(4).expand(4, 4))


@pytest.mark.gpu
@pytest.mark.parametrize("shape", [(33, 1, 201, 1), (40, 3, 7, 2)])
def test_fixed_rule_kernel_matches_plain_on_card(cuda_device, shape):
    """K17 against its plain version (and complex values as pairs): 1e-12
    relative, repeats bit-identical."""
    from autobzcore_torch.ops import adaptive as tad

    rng = np.random.default_rng(180)
    L, S, P, C = shape
    fx = torch.as_tensor(rng.normal(size=shape), device=cuda_device)
    w = torch.as_tensor(rng.random(P), device=cuda_device)
    half = torch.as_tensor(rng.random((L, S)), device=cuda_device)
    for v in (fx, torch.complex(fx, -fx).contiguous()):
        got, again = tad.fixed_rule_reduce(v, w, half), tad.fixed_rule_reduce(v, w, half)
        want = tad.fixed_rule_reduce_plain(v, w, half)
        assert float((got - want).abs().max()) <= 1e-12 * float(want.abs().max())
        assert torch.equal(got, again)


@pytest.mark.gpu
def test_tai_and_fixed_rules_on_card_match_cpu(cuda_device):
    """TAI (K1, K15, K16) at two frequencies and a fixed-outer IAI (K17) on
    the card against the CPU's plain path: identical counts and retcodes,
    values within 1e-12."""
    oms = np.array([-0.7, 1.9])
    out = []
    for dev in ("cpu", cuda_device):
        th = ttb.synthetic_wannier(2, nr=3, ndim=2, seed=3, device=dev)
        prob = T.IntegralProblem(tobs.dos_integrand(th, 0.8), T.load_bz(T.FBZ(), np.eye(2)))
        sw = SweepSolver(prob, T.TAI(device=dev), abstol=1e-5, chunk=2, scan=True)
        algs = (T.AuxQuadGKJL(), T.QuadratureFunction(T.trapz, npt=21))
        sw2 = SweepSolver(prob, T.IAI(algs, inner_cap=32, device=dev), abstol=1e-5, chunk=2, scan=True)
        out.append((sw(oms), sw.lane_numevals, sw.retcode, sw2(oms), sw2.lane_numevals))
    (a, b, c, d, e), (a2, b2, c2, d2, e2) = out
    assert np.array_equal(b, b2) and c is c2 is True and np.array_equal(e, e2)
    assert rel_err(a2, a) <= 1e-12 and rel_err(d2, d) <= 1e-12


# --- the transport family: K18 (velocity pairs), K19 (transport contraction), K20 (Fermi count)


def _transport_pack(rng, K, m, d, device):
    """Energies, Wmat and weights of a random pack: eigenpairs of random
    Hermitian H, random Hermitian dH, K18's plain version."""
    from autobzcore_torch.models import observables as obs

    H = torch.as_tensor(random_hermitian(rng, K, m), device=device)
    e, U = torch.linalg.eigh(H)
    dH = torch.as_tensor(np.stack([random_hermitian(rng, K, m) for _ in range(d)], axis=1), device=device)
    w = torch.as_tensor(rng.integers(1, 9, size=K).astype(np.float64), device=device)
    return e.contiguous(), U.contiguous(), dH, w, obs.velocity_pairs_plain(U.contiguous(), dH, w).contiguous()


def test_transport_wrappers_take_plain_versions_on_cpu_without_counting():
    from autobzcore_torch.models import observables as obs
    from autobzcore_torch.models import transport as tr

    rng = np.random.default_rng(150)
    e, U, dH, w, Wm = _transport_pack(rng, 40, 3, 3, "cpu")
    counts = (obs.velocity_pairs.launches, obs.transport_gamma.launches, tr.fermi_count.launches)
    assert torch.equal(obs.velocity_pairs(U, dH, w), Wm)
    out = torch.empty_like(Wm)
    assert obs.velocity_pairs(U, dH, w, out=out) is out and torch.equal(out, Wm)
    y = torch.linspace(-2, 2, 5, dtype=torch.float64)
    g = torch.full_like(y, 0.1)
    assert torch.equal(obs.transport_gamma(e, Wm, y, g, y + 0.3, g, 0.5),
                       obs.transport_gamma_plain(e, Wm, y, g, y + 0.3, g, 0.5))
    assert float(tr.fermi_count(e, w, 0.1, 7.0)) == float(tr.fermi_count_plain(e, w, 0.1, 7.0))
    assert (obs.velocity_pairs.launches, obs.transport_gamma.launches, tr.fermi_count.launches) == counts


def test_transport_wrappers_reject_what_the_kernels_do_not_take():
    from autobzcore_torch.models import observables as obs
    from autobzcore_torch.models import transport as tr

    rng = np.random.default_rng(151)
    e, U, dH, w, Wm = _transport_pack(rng, 12, 2, 2, "cpu")
    y = torch.zeros(3, dtype=torch.float64)
    with pytest.raises(ValueError):
        obs.velocity_pairs(U.to(torch.complex64), dH, w)
    with pytest.raises(ValueError):
        obs.velocity_pairs(U, dH[:, :, :1], w)
    with pytest.raises(ValueError):
        obs.velocity_pairs(U, dH, w[:5])
    with pytest.raises(ValueError):
        obs.velocity_pairs(U, dH, w, out=torch.empty(3, 3, dtype=torch.float64))
    with pytest.raises(ValueError):
        obs.transport_gamma(e, Wm[:-1], y, y + 1, y, y + 1, 1.0)
    with pytest.raises(ValueError):
        obs.transport_gamma(e, Wm, y, y[:2] + 1, y, y + 1, 1.0)
    with pytest.raises(ValueError):
        obs.transport_gamma(e.to(torch.float32), Wm, y, y + 1, y, y + 1, 1.0)
    with pytest.raises(ValueError):
        tr.fermi_count(e, w[:3], 0.0, 1.0)
    with pytest.raises(ValueError):
        tr.fermi_count(e.T, w, 0.0, 1.0)


def test_transport_plain_versions_agree_with_each_other_on_cpu():
    """K19's plain version at equal frequencies against the reference's
    per-point form Gamma_ab = sum_k w_k sum_nm Re[(v_a)_nm (v_b)_mn] A_n A_m
    written out, and K20's plain count against a direct sum."""
    from autobzcore_torch.models import observables as obs
    from autobzcore_torch.models import transport as tr

    rng = np.random.default_rng(152)
    e, U, dH, w, Wm = _transport_pack(rng, 30, 3, 2, "cpu")
    om = torch.tensor([-0.4, 0.25], dtype=torch.float64)
    g = torch.full_like(om, 0.2)
    got = obs.transport_gamma(e, Wm, om, g, om, g, 0.7).reshape(2, 2, 2)
    v = torch.einsum("kim,kdij,kjn->kdmn", U.conj(), dH, U)
    A = 0.2 / ((om[:, None, None] - e) ** 2 + 0.04) / np.pi
    want = 0.7 * torch.einsum("k,kanm,kbmn,wkn,wkm->wab", w.to(v.dtype), v, v, A.to(v.dtype), A.to(v.dtype)).real
    assert float((got - want).abs().max() / want.abs().max()) <= 1e-12
    x = (e - 0.3).numpy()
    direct = float(np.sum(w.numpy()[:, None] / (1 + np.exp(5.0 * x))))
    assert float(tr.fermi_count(e, w, 0.3, 5.0)) == pytest.approx(direct, rel=1e-13)
    assert float(tr.fermi_count(e, w, 0.3, np.inf)) == float(np.sum(w.numpy()[:, None] * (x < 0)))


@pytest.mark.gpu
@pytest.mark.parametrize("m,d", [(1, 2), (3, 3), (4, 1), (30, 3)])
def test_velocity_pairs_kernel_matches_plain_on_card(cuda_device, m, d):
    """K18 on eigenvectors of random Hermitian matrices and a strided dH view
    (as K11's output gives it): one band, the flagship's 3 x 3, a runtime m,
    and 30 bands (the staging above 48 KB)."""
    from autobzcore_torch.models import observables as obs

    rng = np.random.default_rng(160 + m)
    K = 701 if m < 30 else 45
    H = torch.as_tensor(random_hermitian(rng, K, m), device=cuda_device)
    U = torch.linalg.eigh(H)[1].contiguous()
    J = torch.as_tensor(np.stack([random_hermitian(rng, K, m) for _ in range(d + 1)], axis=1), device=cuda_device)
    dH = J[:, 1:]
    w = torch.as_tensor(rng.random(K) + 0.5, device=cuda_device)
    before = obs.velocity_pairs.launches
    got = obs.velocity_pairs(U, dH, w)
    assert obs.velocity_pairs.launches == before + 1
    want = obs.velocity_pairs_plain(U, dH, w)
    assert float((got - want).abs().max() / want.abs().max()) <= 1e-12
    assert torch.equal(got, obs.velocity_pairs(U, dH, w))
    out = torch.empty_like(got)
    obs.velocity_pairs(U[3:], dH[3:], w[3:], out=out[3 * m * m:])
    assert torch.equal(out[3 * m * m:], got[3 * m * m:])


@pytest.mark.gpu
@pytest.mark.parametrize("m,d", [(1, 2), (2, 2), (3, 3), (5, 3)])
def test_transport_gamma_kernel_matches_plain_on_card(cuda_device, m, d):
    """K19 against its plain version at a ragged node count (a partial block
    of pairs and a partial chunk of points), unequal frequencies and per-node
    widths; a node's value does not depend on the other nodes of its launch;
    bit-identical repeats; equal frequencies passed as the same tensors."""
    from autobzcore_torch.models import observables as obs

    rng = np.random.default_rng(170 + m)
    e, U, dH, w, Wm = _transport_pack(rng, 1300, m, d, cuda_device)
    B = 777
    y1 = torch.as_tensor(rng.uniform(-3, 3, B), device=cuda_device)
    y2 = y1 + torch.as_tensor(rng.uniform(0, 1, B), device=cuda_device)
    g1 = torch.as_tensor(rng.uniform(0.01, 0.3, B), device=cuda_device)
    g2 = torch.as_tensor(rng.uniform(0.01, 0.3, B), device=cuda_device)
    before = obs.transport_gamma.launches
    got = obs.transport_gamma(e, Wm, y1, g1, y2, g2, 0.37)
    assert obs.transport_gamma.launches == before + 1
    want = obs.transport_gamma_plain(e, Wm, y1, g1, y2, g2, 0.37)
    assert float((got - want).abs().max() / want.abs().max()) <= 1e-12
    assert torch.equal(got, obs.transport_gamma(e, Wm, y1, g1, y2, g2, 0.37))
    sub = obs.transport_gamma(e, Wm, y1[5:9].contiguous(), g1[5:9].contiguous(), y2[5:9].contiguous(),
                              g2[5:9].contiguous(), 0.37)
    assert torch.equal(sub, got[5:9])
    # equal frequencies: the same tensors take one Lorentzian per band, bit for
    # bit the value of equal copies (two Lorentzians per band)
    eq = obs.transport_gamma(e, Wm, y1, g1, y1, g1, 0.37)
    assert torch.equal(eq, obs.transport_gamma(e, Wm, y1, g1, y1.clone(), g1.clone(), 0.37))
    want_eq = obs.transport_gamma_plain(e, Wm, y1, g1, y1, g1, 0.37)
    assert float((eq - want_eq).abs().max() / want_eq.abs().max()) <= 1e-12


@pytest.mark.gpu
@pytest.mark.parametrize("m", [1, 2, 3, 5, 8])
@pytest.mark.parametrize("d", [1, 2, 3])
def test_transport_gamma_kernel_at_any_pair_count(cuda_device, m, d):
    """K19 against its plain version within 1e-12 at pair counts around
    its n8 tiles, 16-pair warps and 128-pair blocks, over a point count
    that is not a multiple of its 16-point stage or 512-point chunk, at
    unequal and equal frequencies; repeats bit-identical."""
    from autobzcore_torch.models import observables as obs

    rng = np.random.default_rng(1900 + 10 * m + d)
    e, U, dH, w, Wm = _transport_pack(rng, 1300, m, d, cuda_device)
    for B in (1, 15, 16, 17, 63, 64, 65, 960):
        y1 = torch.as_tensor(rng.uniform(-3, 3, B), device=cuda_device)
        y2 = y1 + torch.as_tensor(rng.uniform(0, 1, B), device=cuda_device)
        g1 = torch.as_tensor(rng.uniform(0.01, 0.3, B), device=cuda_device)
        g2 = torch.as_tensor(rng.uniform(0.01, 0.3, B), device=cuda_device)
        for args in ((y1, g1, y2, g2), (y1, g1, y1, g1)):
            got = obs.transport_gamma(e, Wm, *args, 0.37)
            want = obs.transport_gamma_plain(e, Wm, *args, 0.37)
            assert float((got - want).abs().max() / want.abs().max()) <= 1e-12, (B, args[2] is args[0])
            assert torch.equal(got, obs.transport_gamma(e, Wm, *args, 0.37))


@pytest.mark.gpu
@pytest.mark.parametrize("m", [2, 3, 5])
def test_transport_gamma_pairs_do_not_depend_on_their_place(cuda_device, m):
    """A random permutation of 200 pairs permutes K19's output bit for
    bit, at unequal and at equal frequencies, and a pair alone gives the
    bits it has in the launch."""
    from autobzcore_torch.models import observables as obs

    rng = np.random.default_rng(1950 + m)
    e, U, dH, w, Wm = _transport_pack(rng, 700, m, 3, cuda_device)
    B = 200
    y1 = torch.as_tensor(rng.uniform(-3, 3, B), device=cuda_device)
    y2 = y1 + torch.as_tensor(rng.uniform(0, 1, B), device=cuda_device)
    g1 = torch.as_tensor(rng.uniform(0.01, 0.3, B), device=cuda_device)
    g2 = torch.as_tensor(rng.uniform(0.01, 0.3, B), device=cuda_device)
    perm = torch.as_tensor(rng.permutation(B), device=cuda_device)
    for same in (False, True):
        args = (y1, g1, y1, g1) if same else (y1, g1, y2, g2)
        got = obs.transport_gamma(e, Wm, *args, 0.5)
        pa = tuple(a[perm].contiguous() for a in args[:2])
        pargs = pa + pa if same else pa + tuple(a[perm].contiguous() for a in args[2:])
        assert torch.equal(obs.transport_gamma(e, Wm, *pargs, 0.5), got[perm])
        i = 137
        one = tuple(a[i:i + 1].contiguous() for a in args[:2])
        oargs = one + one if same else one + tuple(a[i:i + 1].contiguous() for a in args[2:])
        assert torch.equal(obs.transport_gamma(e, Wm, *oargs, 0.5), got[i:i + 1])


@pytest.mark.gpu
def test_transport_gamma_entries_hold_dmma(cuda_device):
    """Every K19 entry of the built library runs its product on the FP64
    tensor cores: its SASS holds DMMA instructions."""
    from autobzcore_torch.ops import cuda_lib

    cuda_lib.load_kernels()
    counts = cuda_lib.sass_counts(cuda_lib.LIBRARY, "DMMA", "transport_gamma_partial")
    assert len(counts) >= 12 and all(counts.values()), counts


@pytest.mark.gpu
def test_fermi_count_kernel_matches_plain_on_card(cuda_device):
    """K20 at several (mu, beta), beta = inf among them, a ragged term count,
    bit-identical repeats, and an exact count of whole bands."""
    from autobzcore_torch.models import transport as tr

    rng = np.random.default_rng(180)
    K, m = 70001, 3
    e = torch.as_tensor(np.sort(rng.normal(size=(K, m)), axis=1), device=cuda_device)
    w = torch.as_tensor(rng.integers(1, 49, size=K).astype(np.float64), device=cuda_device)
    for mu, beta in ((0.0, 40.0), (-0.7, 3.0), (1.2, np.inf), (0.3, 1e4), (-9.0, np.inf)):
        before = tr.fermi_count.launches
        got = tr.fermi_count(e, w, mu, beta)
        assert tr.fermi_count.launches == before + 1
        want = tr.fermi_count_plain(e, w, mu, beta)
        assert abs(float(got) - float(want)) <= 1e-12 * float(w.sum()) * m
        assert torch.equal(got, tr.fermi_count(e, w, mu, beta))
    assert float(tr.fermi_count(e, w, 50.0, np.inf)) == m * float(w.sum())


# --- the Berry family: K21 (band-pair terms), K22 (plaquette flux), K23 (Wilson loops), K24 (zone average)


def _pair_inputs(rng, K, m, d, device):
    """Random Hermitian H (K, m, m), a strided dH view (K, d, m, m) (as the
    Jacobian's output gives it) and a Hermitian operator O (m, m)."""
    H = torch.as_tensor(random_hermitian(rng, K, m), device=device)
    J = torch.as_tensor(np.stack([random_hermitian(rng, K, m) for _ in range(d + 1)], axis=1), device=device)
    O = torch.as_tensor(random_hermitian(rng, 1, m)[0], device=device)
    return H, J[:, 1:], O


def _frames(model, npt, n2=None):
    from autobzcore_torch.models import berry as br

    u = [np.arange(npt) / npt * model.period[0], np.arange(n2 or npt) / (n2 or npt) * model.period[1]]
    return br._frames(model, u, None)


def test_berry_wrappers_take_plain_versions_on_cpu_without_counting():
    from autobzcore_torch.models import berry as br

    rng = np.random.default_rng(190)
    H, dH, O = _pair_inputs(rng, 30, 3, 2, "cpu")
    counts = (br.band_pair_terms.launches, br.zone_average.launches, br.plaquette_flux.launches,
              br.wilson_loops.launches)
    for mode in ("curvature", "metric", "operator"):
        got = br.band_pair_terms(H, dH, 1e-8, mode, O if mode == "operator" else None)
        want = br.band_pair_terms_plain(H, dH, 1e-8, mode, O if mode == "operator" else None)
        got, want = (got,) if mode == "metric" else got, (want,) if mode == "metric" else want
        assert all(torch.equal(a, b) for a, b in zip(got, want))
    e, Om, _, vd = br.band_pair_terms(H, dH, 1e-8)
    for mode in ("step", "fermi", "entropy", "dipole", "grand", "band"):
        beta = None if mode in ("step", "band") else 3.0
        assert torch.equal(br.zone_average(e, Om, mode, 0.1, beta, vd=vd),
                           br.zone_average_plain(e, Om, mode, 0.1, beta, vd=vd))
    V = _frames(ttb.tb_haldane(t2=0.1, device="cpu"), 8)
    assert torch.equal(br.plaquette_flux(V), br.plaquette_flux_plain(V))
    assert torch.equal(br.wilson_loops(V), br.wilson_loops_plain(V))
    assert (br.band_pair_terms.launches, br.zone_average.launches, br.plaquette_flux.launches,
            br.wilson_loops.launches) == counts


def test_berry_wrappers_reject_what_the_kernels_do_not_take():
    from autobzcore_torch.models import berry as br

    rng = np.random.default_rng(191)
    H, dH, O = _pair_inputs(rng, 12, 2, 2, "cpu")
    with pytest.raises(ValueError):
        br.band_pair_terms(H.to(torch.complex64), dH, 1e-8)
    with pytest.raises(ValueError):
        br.band_pair_terms(H, dH[:5], 1e-8)
    with pytest.raises(ValueError):
        br.band_pair_terms(H, dH, 1e-8, mode="spin")
    with pytest.raises(ValueError):
        br.band_pair_terms(H, dH, 1e-8, mode="operator")  # no operator
    with pytest.raises(ValueError):
        br.band_pair_terms(H, dH, 1e-8, mode="operator", O=O[:1])
    e, Om, _, vd = br.band_pair_terms(H, dH, 1e-8)
    with pytest.raises(ValueError):
        br.zone_average(e, Om, "fermi", 0.0, None)  # needs a finite beta
    with pytest.raises(ValueError):
        br.zone_average(e, Om, "dipole", 0.0, 5.0)  # needs vd
    with pytest.raises(ValueError):
        br.zone_average(e, Om[:, :, 0], "step")
    with pytest.raises(ValueError):
        br.zone_average(e.T, Om, "step")
    with pytest.raises(ValueError):
        br.zone_average(e, Om, "median")
    V = torch.zeros((4, 4, 10, 9), dtype=torch.complex128)
    with pytest.raises(ValueError):
        br.plaquette_flux(V)  # nb = 9 > 8
    with pytest.raises(ValueError):
        br.wilson_loops(V[..., :3].transpose(0, 1))  # not contiguous
    with pytest.raises(ValueError):
        br.wilson_loops(torch.zeros((4, 4, 2, 3), dtype=torch.complex128))  # nb > m


@pytest.mark.gpu
@pytest.mark.parametrize("m,d,mode", [(2, 2, "curvature"), (2, 3, "curvature"), (2, 2, "metric"),
                                      (2, 3, "operator"), (3, 3, "curvature"), (4, 2, "curvature"),
                                      (4, 2, "metric"), (4, 2, "operator"), (9, 3, "operator")])
def test_band_pair_terms_kernel_matches_plain_on_card(cuda_device, m, d, mode):
    """K21 in each mode, at m = 2 (the closed form in registers) and m > 2
    (eigh_small's chunked eigh, the same eigenvectors for the plain version),
    a ragged point count and a strided dH view: 1e-12 of each field's scale,
    bit-identical repeats."""
    from autobzcore_torch.models import berry as br

    rng = np.random.default_rng(200 + 10 * m + d)
    H, dH, O = _pair_inputs(rng, 5003 if m < 9 else 301, m, d, cuda_device)
    Oa = O if mode == "operator" else None
    before = br.band_pair_terms.launches
    got = br.band_pair_terms(H, dH, 1e-8, mode, Oa)
    assert br.band_pair_terms.launches == before + 1
    want = br.band_pair_terms_plain(H, dH, 1e-8, mode, Oa)
    again = br.band_pair_terms(H, dH, 1e-8, mode, Oa)
    got, want, again = ((x,) if mode == "metric" else x for x in (got, want, again))
    for a, b, c in zip(got, want, again):
        assert a.shape == b.shape
        assert float((a - b).abs().max()) <= 1e-12 * float(b.abs().max())
        assert torch.equal(a, c)


@pytest.mark.gpu
@pytest.mark.parametrize("mode", ["step", "fermi", "entropy", "dipole", "grand", "grand_zero_t", "band"])
def test_zone_average_kernel_matches_plain_on_card(cuda_device, mode):
    """K24 in each weight mode on a ragged point count (a partial chunk):
    1e-13 of the sum of the terms' magnitudes, bit-identical repeats."""
    from autobzcore_torch.models import berry as br

    rng = np.random.default_rng(210)
    K, m, d = 70001, 3, 3
    e = torch.as_tensor(np.sort(rng.normal(size=(K, m)), axis=1), device=cuda_device)
    F = torch.as_tensor(rng.normal(size=(K, m, d, d)), device=cuda_device)
    vd = torch.as_tensor(rng.normal(size=(K, m, d)), device=cuda_device)
    name, beta = ("grand", None) if mode == "grand_zero_t" else (mode, None if mode in ("step", "band") else 7.0)
    before = br.zone_average.launches
    got = br.zone_average(e, F, name, 0.2, beta, vd=vd)
    assert br.zone_average.launches == before + 1
    want = br.zone_average_plain(e, F, name, 0.2, beta, vd=vd)
    absF = br.zone_average_plain(e, F.abs(), name, 0.2, beta, vd=vd.abs())
    scale = float(absF.abs().max())
    assert got.shape == want.shape
    assert float((got - want).abs().max()) <= 1e-13 * scale
    assert torch.equal(got, br.zone_average(e, F, name, 0.2, beta, vd=vd))


@pytest.mark.gpu
@pytest.mark.parametrize("K,m,d,aligned", [(37, 1, 1, True), (37, 3, 3, True), (1001, 2, 3, True),
                                           (1001, 3, 1, True), (5003, 1, 3, True), (20001, 2, 3, False)],
                         ids=["below_a_chunk_m1_c1", "below_a_chunk_m3_c9", "ragged_m2_c9", "ragged_m3_c1",
                              "ragged_m1_c9", "unaligned_m2_c9"])
def test_zone_average_kernel_shapes_on_card(cuda_device, K, m, d, aligned):
    """K24 in every weight mode where its chunks are partial: fewer points
    than one chunk, a count that is no multiple of a chunk, m = 1, 2, 3
    with C = 1 and 9 columns, and fields 8 bytes off 16-byte alignment (the
    threads copy what the bulk copies cannot); 1e-13 of the terms' scale,
    bit-identical repeats."""
    from autobzcore_torch.models import berry as br

    rng = np.random.default_rng(220 + K + m + d)
    e = torch.as_tensor(np.sort(rng.normal(size=(K, m)), axis=1), device=cuda_device)

    def field(shape):
        flat = torch.as_tensor(rng.normal(size=int(np.prod(shape)) + 1), device=cuda_device)
        return (flat[:-1] if aligned else flat[1:]).view(shape)

    F, vd = field((K, m, d, d)), field((K, m, d))
    assert (F.data_ptr() % 16 == 0) == aligned
    for name, beta in (("step", None), ("fermi", 7.0), ("entropy", 7.0), ("dipole", 7.0), ("grand", 7.0),
                       ("grand", None), ("band", None)):
        got = br.zone_average(e, F, name, 0.2, beta, vd=vd)
        want = br.zone_average_plain(e, F, name, 0.2, beta, vd=vd)
        scale = float(br.zone_average_plain(e, F.abs(), name, 0.2, beta, vd=vd.abs()).abs().max())
        assert got.shape == want.shape
        assert float((got - want).abs().max()) <= 1e-13 * scale, name
        assert torch.equal(got, br.zone_average(e, F, name, 0.2, beta, vd=vd)), name


@pytest.mark.gpu
@pytest.mark.parametrize("case", ["haldane", "kane_mele", "wannier8"])
def test_link_kernels_match_plain_on_card(cuda_device, case):
    """K22 and K23 on occupied frames of a Chern band (nb = 1), a Kramers
    pair (nb = 2) and four bands of a random 8-band model (nb = 4, the
    pivoted determinant), against their plain versions (1e-12; the loop
    matrices elementwise), bit-identical on repeat."""
    from autobzcore_torch.models import berry as br

    h = {"haldane": lambda: ttb.tb_haldane(t2=0.1, device=cuda_device),
         "kane_mele": lambda: ttb.tb_kane_mele(lam_so=0.06, lam_r=0.05, device=cuda_device),
         "wannier8": lambda: ttb.synthetic_wannier(8, nr=3, ndim=2, seed=4, device=cuda_device)}[case]()
    V = _frames(h, 24, 20)
    before = (br.plaquette_flux.launches, br.wilson_loops.launches)
    F, W = br.plaquette_flux(V), br.wilson_loops(V)
    assert (br.plaquette_flux.launches, br.wilson_loops.launches) == (before[0] + 1, before[1] + 1)
    assert abs(float(F) - float(br.plaquette_flux_plain(V))) <= 1e-12 * max(1.0, abs(float(F)))
    Wp = br.wilson_loops_plain(V)
    assert W.shape == Wp.shape and float((W - Wp).abs().max()) <= 1e-12 * float(Wp.abs().max())
    assert torch.equal(F, br.plaquette_flux(V)) and torch.equal(W, br.wilson_loops(V))


@pytest.mark.gpu
def test_berry_solver_on_card_matches_cpu(cuda_device):
    """The whole Berry family on the card (K21-K24) against the CPU's plain
    versions: the Haldane pack and queries, the lattice Chern number and
    the Wilson centres, Kane-Mele's spin Hall (1e-10 of each scale)."""
    from autobzcore_torch import FBZ, load_bz
    from autobzcore_torch.models import berry as br

    bz = load_bz(FBZ(), np.eye(2))
    out = {}
    for dev in ("cpu", cuda_device):
        h = ttb.tb_haldane(t2=0.1, M=0.2, device=dev)
        s = br.BerryCurvatureSolver(h, bz, 48)
        km = br.BerryCurvatureSolver(ttb.tb_kane_mele_sz(lam_so=0.1, device=dev), bz, 24)
        out[str(dev)] = (s.pack.Om.cpu().numpy(), s.chern(), s.ahc(0.3, 20.0), s.orbital_magnetization(0.1),
                         s.berry_curvature_dipole(0.8, 40.0), s.quantum_metric().cpu().numpy(),
                         np.array([br.lattice_chern(h, bz, 16)]), br.wilson_loop_spectrum(h, 16),
                         km.operator_hall(np.diag([0.5, 0.5, -0.5, -0.5]), mu=0.0))
    for a, b in zip(out["cpu"], out[str(cuda_device)]):
        assert np.max(np.abs(a - b)) <= 1e-10 * max(1.0, np.max(np.abs(a)))


def _flux_solves(dev):
    """The Haldane flux integrand under PTR, IAI and TAI at mu = 0, an IAI
    sweep (one mu per point at the leaf) and a PTR sweep on ``dev``: the
    values, the evaluation counts and K21's launches."""
    from autobzcore_torch.models import berry as br
    from autobzcore_torch.parameters import MixedParameters

    bz = T.load_bz(T.FBZ(), np.eye(2))
    fi = br.berry_flux_integrand(ttb.tb_haldane(t2=0.1, phi=np.pi / 2, device=dev))
    before = br.band_pair_terms.launches
    sols = [T.solve(T.IntegralProblem(fi, bz, MixedParameters(mu=0.0)), T.EvalCounter(alg), **kw)
            for alg, kw in ((T.PTR(npt=48, device=dev), {}), (T.IAI(inner_cap=128, device=dev), {"abstol": 1e-5}),
                            (T.TAI(device=dev), {"abstol": 1e-4}))]
    sw = SweepSolver(T.IntegralProblem(fi, bz), T.IAI(inner_cap=64, device=dev), abstol=1e-3, chunk=2, scan=True)
    swept = sw(np.array([0.0, 0.3]))
    ptr = SweepSolver(T.IntegralProblem(fi, bz), T.PTR(npt=24, device=dev), chunk=2)(np.array([-1.5, 0.0, 1.5]))
    u = np.array([float(s.u) for s in sols] + list(swept) + list(ptr))
    return u, [s.numevals for s in sols] + list(sw.lane_numevals), br.band_pair_terms.launches - before


def test_berry_flux_takes_plain_version_on_cpu_without_counting():
    u, _, launched = _flux_solves("cpu")
    assert launched == 0
    detB = (2 * np.pi) ** 2  # the reciprocal cell of the unit square lattice
    assert np.all(np.abs(u[:5] / (detB * 2 * np.pi) + 1) < 1e-3)  # C = -1 in the gap


@pytest.mark.gpu
def test_berry_flux_integrand_on_card_matches_cpu(cuda_device):
    """The flux integrand's card route (K21 on each batch: the PTR rule, the
    IAI leaf's strided views of the Jacobian channels, TAI's trips, one mu
    per point under an IAI sweep, a PTR sweep lane by lane) against the same
    solves on the CPU: 1e-10 of each value, equal counts, K21 launched."""
    u_c, n_c, _ = _flux_solves("cpu")
    u_g, n_g, launched = _flux_solves(cuda_device)
    assert launched > 0
    assert n_g == n_c
    assert np.all(np.abs(u_g - u_c) <= 1e-10 * np.maximum(1.0, np.abs(u_c)))


@pytest.mark.gpu
def test_eigh_small_chunks_on_card(cuda_device):
    """eigh_small at m > 2 on the card feeds torch.linalg.eigh at most
    EIGH_CHUNK matrices a call: the same pairs as one call on the CPU."""
    from autobzcore_torch.ops.eigh3 import EIGH_CHUNK, eigh_small

    rng = np.random.default_rng(220)
    H = torch.as_tensor(random_hermitian(rng, 2 * EIGH_CHUNK + 7, 4), device=cuda_device)
    e, U = eigh_small(H)
    ec = torch.linalg.eigvalsh(H.cpu())
    assert float((e.cpu() - ec).abs().max()) <= 1e-12 * float(ec.abs().max())
    resid = H @ U - U * e[:, None, :]
    assert float(resid.abs().max()) <= 1e-12 * float(ec.abs().max())


# --- the Lindhard and self-energy families (K25-K28) ----------------------------------------


def _lindhard_inputs(rng, d, npt, m, device):
    """A grid of sorted random energies e (npt,)*d + (m,), their occupations
    at beta 4, mu 0.1, and eigenvectors U of random Hermitian matrices."""
    K = npt**d
    e = np.sort(rng.normal(size=(K, m)), axis=-1)
    U = np.linalg.eigh(random_hermitian(rng, K, m))[1]
    shape = (npt,) * d
    e = torch.as_tensor(e.reshape(shape + (m,)), device=device)
    f = torch.sigmoid(-4.0 * (e - 0.1)).contiguous()
    return e, f, torch.as_tensor(U.reshape(shape + (m, m)), device=device).contiguous()


def _sigma_z(rng, W, m, device):
    """W matrices Z = w I - Sigma with a general (non-Hermitian) Sigma = R -
    i Gamma, R Hermitian and Gamma Hermitian positive definite, so that Z -
    H is invertible for every Hermitian H."""
    R = random_hermitian(rng, W, m) * 0.3
    g = rng.normal(size=(W, m, m)) + 1j * rng.normal(size=(W, m, m))
    Gam = 0.05 * np.einsum("wij,wkj->wik", g, g.conj()) + 0.05 * np.eye(m)
    w = rng.uniform(-3, 3, W)
    return torch.as_tensor(w[:, None, None] * np.eye(m) - (R - 1j * Gam), device=device).contiguous()


def _sigma_inputs(rng, K, m, d, W, device):
    H = torch.as_tensor(random_hermitian(rng, K, m), device=device)
    V = torch.as_tensor(np.stack([random_hermitian(rng, K, m) for _ in range(d)], axis=1), device=device)
    w = torch.as_tensor(rng.random(K) + 0.5, device=device)
    return H, V.contiguous(), w, _sigma_z(rng, W, m, device), _sigma_z(rng, W, m, device)


def test_lindhard_wrappers_take_plain_versions_on_cpu_without_counting():
    from autobzcore_torch.models import lindhard as li

    e, f, U = _lindhard_inputs(np.random.default_rng(300), 2, 6, 2, "cpu")
    om = torch.linspace(0.0, 2.0, 5, dtype=torch.float64)
    counts = (li.chi0.launches, li.cooper_mean.launches)
    assert torch.equal(li.chi0(e, f, U, (1, 4), om, 0.05, 0.1), li.chi0_plain(e, f, U, (1, 4), om, 0.05, 0.1))
    assert torch.equal(li.cooper_mean(e, f, (2, 0), 0.1, 4.0), li.cooper_mean_plain(e, f, (2, 0), 0.1, 4.0))
    assert (li.chi0.launches, li.cooper_mean.launches) == counts


def test_lindhard_wrappers_reject_what_the_kernels_do_not_take():
    from autobzcore_torch.models import lindhard as li

    e, f, U = _lindhard_inputs(np.random.default_rng(301), 2, 4, 2, "cpu")
    om = torch.zeros(3, dtype=torch.float64)
    with pytest.raises(ValueError):
        li.chi0(e.float(), f, U, (0, 0), om, 0.1, 1.0)
    with pytest.raises(ValueError):
        li.chi0(e, f[:3], U, (0, 0), om, 0.1, 1.0)
    with pytest.raises(ValueError):
        li.chi0(e, f, U[..., :1], (0, 0), om, 0.1, 1.0)
    with pytest.raises(ValueError):
        li.chi0(e, f, U, (0, 0, 1), om, 0.1, 1.0)  # the shift's length
    with pytest.raises(ValueError):
        li.chi0(e, f, U, (0, 0), om.float(), 0.1, 1.0)
    with pytest.raises(ValueError):
        li.cooper_mean(e[:3], f[:3], (0, 0), 0.0, 1.0)  # not a square grid
    with pytest.raises(ValueError):
        li.cooper_mean(e, f.transpose(0, 1), (0, 0), 0.0, 1.0)  # not contiguous


def test_sigma_wrappers_take_plain_versions_on_cpu_without_counting():
    from autobzcore_torch.models import selfenergy as se

    rng = np.random.default_rng(302)
    H, V, w, Z1, Z2 = _sigma_inputs(rng, 40, 3, 2, 6, "cpu")
    counts = (se.sigma_trace_sum.launches, se.sigma_trace_points.launches, se.sigma_pairs_sum.launches,
              se.sigma_pairs_points.launches)
    for diagonal in (False, True):
        assert torch.equal(se.sigma_trace_sum(H, w, Z1, 0.5, diagonal), se.sigma_trace_sum_plain(H, w, Z1, 0.5, diagonal))
    Zp = _sigma_z(rng, 40, 3, "cpu")
    for Z in (Zp, Z1[0].contiguous()):
        assert torch.equal(se.sigma_trace_points(H, Z), se.sigma_trace_points_plain(H, Z))
        assert torch.equal(se.sigma_pairs_points(H, V, Z), se.sigma_pairs_points_plain(H, V, Z))
    assert torch.equal(se.sigma_pairs_sum(H, V, w, Z1, Z1, 0.5), se.sigma_pairs_sum_plain(H, V, w, Z1, Z1, 0.5))
    assert torch.equal(se.sigma_pairs_sum(H, V, w, Z1, Z2, 0.5), se.sigma_pairs_sum_plain(H, V, w, Z1, Z2, 0.5))
    assert (se.sigma_trace_sum.launches, se.sigma_trace_points.launches, se.sigma_pairs_sum.launches,
            se.sigma_pairs_points.launches) == counts


def test_sigma_wrappers_reject_what_the_kernels_do_not_take():
    from autobzcore_torch.models import selfenergy as se

    H, V, w, Z1, Z2 = _sigma_inputs(np.random.default_rng(303), 12, 2, 2, 4, "cpu")
    with pytest.raises(ValueError):
        se.sigma_trace_sum(H.to(torch.complex64), w, Z1, 1.0)
    with pytest.raises(ValueError):
        se.sigma_trace_sum(H, w[:5], Z1, 1.0)
    with pytest.raises(ValueError):
        se.sigma_trace_sum(H, w, Z1[:, :1], 1.0)
    with pytest.raises(ValueError):
        se.sigma_trace_points(H, Z1)  # 4 matrices for 12 points
    with pytest.raises(ValueError):
        se.sigma_trace_points(H, Z1[0].T)  # not contiguous
    with pytest.raises(ValueError):
        se.sigma_pairs_sum(H, V[:, :, :1], w, Z1, Z2, 1.0)
    with pytest.raises(ValueError):
        se.sigma_pairs_sum(H, V, w, Z1, Z2[:3], 1.0)
    with pytest.raises(ValueError):
        se.sigma_pairs_points(H, V[:5], Z1[0].contiguous())


@pytest.mark.gpu
@pytest.mark.parametrize("d,npt,m", [(1, 37, 1), (2, 12, 2), (3, 8, 3), (2, 9, 5)])
def test_chi0_kernel_matches_plain_on_card(cuda_device, d, npt, m):
    """K25 at a random grid shift, 130 frequencies (two lane blocks):
    1e-12 of max|chi|, bit-identical repeats, and a frequency's value the
    same bits whatever other frequencies are asked for."""
    from autobzcore_torch.models import lindhard as li

    rng = np.random.default_rng(310 + d + m)
    e, f, U = _lindhard_inputs(rng, d, npt, m, cuda_device)
    om = torch.linspace(-1.0, 3.0, 130, dtype=torch.float64, device=cuda_device)
    shift = tuple(int(s) for s in rng.integers(0, npt, d))
    before = li.chi0.launches
    got = li.chi0(e, f, U, shift, om, 0.05, 0.01)
    assert li.chi0.launches == before + 1
    want = li.chi0_plain(e, f, U, shift, om, 0.05, 0.01)
    assert float((got - want).abs().max()) <= 1e-12 * float(want.abs().max())
    assert torch.equal(got, li.chi0(e, f, U, shift, om, 0.05, 0.01))
    assert torch.equal(got[:7], li.chi0(e, f, U, shift, om[:7].contiguous(), 0.05, 0.01))


@pytest.mark.gpu
@pytest.mark.parametrize("W", [1, 9, 100, 129])
@pytest.mark.parametrize("d,npt,m", [(1, 37, 1), (2, 12, 3), (3, 13, 3), (3, 9, 5), (2, 19, 8)])
def test_chi0_kernel_frequency_widths_on_card(cuda_device, d, npt, m, W):
    """K25 at every width its blocks size themselves to (one frequency,
    certified_chi0's nine, the map's hundred, and 129: two block rows), on
    grids that are no multiple of a tile, m = 1, 3, 5, 8: 1e-12 of
    max|chi|, bit-identical repeats, and each frequency the bits it has in
    the launch of 129 (alone too)."""
    from autobzcore_torch.models import lindhard as li

    rng = np.random.default_rng(330 + d + m)
    e, f, U = _lindhard_inputs(rng, d, npt, m, cuda_device)
    shift = tuple(int(s) for s in rng.integers(0, npt, d))
    om129 = torch.linspace(-1.0, 3.0, 129, dtype=torch.float64, device=cuda_device)
    all129 = li.chi0(e, f, U, shift, om129, 0.05, 0.01)
    sel = torch.as_tensor(np.linspace(0, 128, W).round().astype(np.int64), device=cuda_device)
    om = om129[sel].contiguous()
    got = li.chi0(e, f, U, shift, om, 0.05, 0.01)
    want = li.chi0_plain(e, f, U, shift, om, 0.05, 0.01)
    assert float((got - want).abs().max()) <= 1e-12 * float(want.abs().max())
    assert torch.equal(got, li.chi0(e, f, U, shift, om, 0.05, 0.01))
    assert torch.equal(got, all129[sel])
    j = W // 2
    assert torch.equal(li.chi0(e, f, U, shift, om[j:j + 1], 0.05, 0.01), got[j:j + 1])


@pytest.mark.gpu
def test_chi0_kernel_exact_where_its_reciprocal_does_not_hold_on_card(cuda_device):
    """A frequency of 1e200 makes x^2 + eta^2 overflow, where K25's
    reciprocal by rcp.approx does not hold: its terms take a correctly
    rounded division, so chi0 there is the plain version's ~1e-200 within
    1e-12 of max|chi|, and the other frequencies keep their bits. An eta
    below 1e-150 (where the kernel's sums would overflow) raises."""
    from autobzcore_torch.models import lindhard as li

    e, f, U = _lindhard_inputs(np.random.default_rng(340), 2, 12, 3, cuda_device)
    om = torch.tensor([0.0, 1e200, 0.7, 2.0], dtype=torch.float64, device=cuda_device)
    got = li.chi0(e, f, U, (1, 3), om, 0.05, 0.01)
    want = li.chi0_plain(e, f, U, (1, 3), om, 0.05, 0.01)
    assert bool(torch.isfinite(got).all())
    assert float((got - want).abs().max()) <= 1e-12 * float(want.abs().max())
    keep = torch.tensor([0, 2, 3], device=cuda_device)
    assert torch.equal(got[keep], li.chi0(e, f, U, (1, 3), om[keep].contiguous(), 0.05, 0.01))
    with pytest.raises(ValueError):
        li.chi0(e, f, U, (1, 3), om, 1e-160, 0.01)


@pytest.mark.gpu
@pytest.mark.parametrize("d,npt,m", [(1, 40, 2), (2, 16, 1), (3, 8, 3)])
def test_cooper_kernel_matches_plain_on_card(cuda_device, d, npt, m):
    """K26 at q = 0 and a random shift, and on tb_integer at mu = 0 where
    the |den| < 1e-10 branch is taken: 1e-12 relative, bit-identical
    repeats."""
    from autobzcore_torch.models import lindhard as li

    rng = np.random.default_rng(320 + d)
    e, f, _ = _lindhard_inputs(rng, d, npt, m, cuda_device)
    for shift in ((0,) * d, tuple(int(s) for s in rng.integers(0, npt, d))):
        got = li.cooper_mean(e, f, shift, 0.1, 4.0)
        want = li.cooper_mean_plain(e, f, shift, 0.1, 4.0)
        assert abs(float(got) - float(want)) <= 1e-12 * abs(float(want))
        assert torch.equal(got, li.cooper_mean(e, f, shift, 0.1, 4.0))
    slv = li.LindhardSolver(ttb.tb_integer(d, device=cuda_device), T.load_bz(T.FBZ(), np.eye(d)), 8, 10.0)
    before = li.cooper_mean.launches
    got = li.cooper_bubble(slv)
    assert li.cooper_mean.launches == before + 1
    want = float(li.cooper_mean_plain(slv._e, slv._f, (0,) * d, 0.0, 10.0)) * slv._vol
    assert abs(got - want) <= 1e-12 * abs(want)


@pytest.mark.gpu
@pytest.mark.parametrize("m", [1, 2, 3, 4, 5, 8])
@pytest.mark.parametrize("diagonal", [False, True])
def test_sigma_trace_kernel_matches_plain_on_card(cuda_device, m, diagonal):
    """K27's sum in trace and diagonal mode over a ragged point count (a
    partial chunk and tile) and 37 lanes, and its pointwise entry with one
    Z per point and one for all: 1e-12 of the value scale, bit-identical
    repeats. At m <= 3 also at a constant Sigma = -1e-3 i with half the
    lanes on an eigenvalue of some H_k (where the m = 3 sums' guard redoes
    pairs from M formed directly), a lane's bits the same alone as in the
    launch of 37. Above three bands the kernel's Gauss-Jordan inverse meets
    the plain version's ``solve``."""
    from autobzcore_torch.models import selfenergy as se

    rng = np.random.default_rng(330 + m)
    H, _, w, Z, _ = _sigma_inputs(rng, 10_007, m, 1, 37, cuda_device)
    cases = [Z]
    if m <= 3:
        z = _pole_lanes(rng, H, 37, 1e-3)
        cases.append(torch.as_tensor(z[:, None, None] * np.eye(m), device=cuda_device).contiguous())
    for Zc in cases:
        before = se.sigma_trace_sum.launches
        got = se.sigma_trace_sum(H, w, Zc, 0.3, diagonal)
        assert se.sigma_trace_sum.launches == before + 1
        want = se.sigma_trace_sum_plain(H, w, Zc, 0.3, diagonal)
        assert got.shape == want.shape == ((37, m) if diagonal else (37,))
        assert float((got - want).abs().max()) <= 1e-12 * float(want.abs().max())
        assert torch.equal(got, se.sigma_trace_sum(H, w, Zc, 0.3, diagonal))
        assert torch.equal(got[-1:], se.sigma_trace_sum(H, w, Zc[-1:].contiguous(), 0.3, diagonal))
        for Zp in (_sigma_z(rng, 10_007, m, cuda_device), Zc[3].contiguous(),
                   Zc[torch.arange(10_007, device=cuda_device) % 37].contiguous()):
            got = se.sigma_trace_points(H, Zp)
            want = se.sigma_trace_points_plain(H, Zp)
            assert float((got - want).abs().max()) <= 1e-12 * float(want.abs().max())
            assert torch.equal(got, se.sigma_trace_points(H, Zp))


def _pole_lanes(rng, H, W, eta):
    """W lane frequencies, half at random in [-3, 3] and half on an
    eigenvalue of some H_k (numpy), each with eta: z = om + i eta."""
    Hn = H.cpu().numpy()
    ev = np.linalg.eigvalsh(Hn[rng.integers(0, Hn.shape[0], W // 2)])
    om = np.concatenate([rng.uniform(-3.0, 3.0, W - W // 2), ev[np.arange(W // 2), rng.integers(0, Hn.shape[-1],
                                                                                                 W // 2)]])
    return om + 1j * eta


@pytest.mark.gpu
@pytest.mark.parametrize("m,d", [(1, 1), (2, 2), (3, 3), (3, 2), (2, 3), (4, 3), (5, 2), (8, 3)])
def test_sigma_pairs_kernel_matches_plain_on_card(cuda_device, m, d):
    """K28's sum at equal (Z2 is Z1) and unequal frequencies over a ragged
    point count and 37 pairs, and its pointwise entry: 1e-12 relative,
    bit-identical repeats."""
    from autobzcore_torch.models import selfenergy as se

    rng = np.random.default_rng(340 + 10 * m + d)
    H, V, w, Z1, Z2 = _sigma_inputs(rng, 5_003, m, d, 37, cuda_device)
    for Zb in (Z1, Z2):
        before = se.sigma_pairs_sum.launches
        got = se.sigma_pairs_sum(H, V, w, Z1, Zb, 0.3)
        assert se.sigma_pairs_sum.launches == before + 1
        want = se.sigma_pairs_sum_plain(H, V, w, Z1, Zb, 0.3)
        assert got.shape == want.shape == (37, d, d)
        assert float((got - want).abs().max()) <= 1e-12 * float(want.abs().max())
        assert torch.equal(got, se.sigma_pairs_sum(H, V, w, Z1, Zb, 0.3))
    for Zp in (_sigma_z(rng, 5_003, m, cuda_device), Z1[0].contiguous()):
        got = se.sigma_pairs_points(H, V, Zp)
        want = se.sigma_pairs_points_plain(H, V, Zp)
        assert float((got - want).abs().max()) <= 1e-12 * float(want.abs().max())
        assert torch.equal(got, se.sigma_pairs_points(H, V, Zp))


@pytest.mark.gpu
@pytest.mark.parametrize("m,d", [(1, 1), (1, 3), (2, 1), (2, 2), (3, 1), (3, 2), (3, 3), (4, 2), (5, 3), (6, 1),
                                 (7, 2), (8, 3)])
def test_sigma_pairs_rows_do_not_depend_on_the_batch_on_card(cuda_device, m, d):
    """K28's sum over 4,099 points (a partial chunk and tile) at 45 pairs
    (not a multiple of 32), equal (Z2 is Z1) and unequal: 1e-12 of the value
    scale against the plain version, bit-identical repeats, and each pair's
    row the same bits in a reversed batch, in the batch's first 13 rows and
    alone (a one-pair launch)."""
    from autobzcore_torch.models import selfenergy as se

    rng = np.random.default_rng(360 + 10 * m + d)
    H, V, w, Z1, Z2 = _sigma_inputs(rng, 4_099, m, d, 45, cuda_device)

    def run(Za, Zb, same):
        return se.sigma_pairs_sum(H, V, w, Za, Za if same else Zb, 0.3)

    for same in (True, False):
        got = run(Z1, Z2, same)
        want = se.sigma_pairs_sum_plain(H, V, w, Z1, Z1 if same else Z2, 0.3)
        assert float((got - want).abs().max()) <= 1e-12 * float(want.abs().max())
        assert torch.equal(got, run(Z1, Z2, same))
        assert torch.equal(run(Z1.flip(0).contiguous(), Z2.flip(0).contiguous(), same).flip(0), got)
        assert torch.equal(run(Z1[:13].contiguous(), Z2[:13].contiguous(), same), got[:13])
        for b in (0, 31, 44):
            assert torch.equal(run(Z1[b:b + 1].contiguous(), Z2[b:b + 1].contiguous(), same)[0], got[b])


@pytest.mark.gpu
def test_sigma_pairs_kernel_at_a_kinetic_trip_on_card(cuda_device):
    """K28 at a kinetic trip's shape, 960 unequal pairs at m = d = 3, over
    12,345 points: 1e-12 of the value scale against the plain version,
    bit-identical repeats."""
    from autobzcore_torch.models import selfenergy as se

    rng = np.random.default_rng(370)
    H, V, w, Z1, Z2 = _sigma_inputs(rng, 12_345, 3, 3, 960, cuda_device)
    before = se.sigma_pairs_sum.launches
    got = se.sigma_pairs_sum(H, V, w, Z1, Z2, 0.3)
    assert se.sigma_pairs_sum.launches == before + 1
    want = se.sigma_pairs_sum_plain(H, V, w, Z1, Z2, 0.3)
    assert got.shape == (960, 3, 3)
    assert float((got - want).abs().max()) <= 1e-12 * float(want.abs().max())
    assert torch.equal(got, se.sigma_pairs_sum(H, V, w, Z1, Z2, 0.3))


@pytest.mark.gpu
def test_sigma_engines_above_three_bands_on_card(cuda_device):
    """A 4-band model through SigmaDOSSolver (trace and projected) and
    SigmaTransportSolver on the card: every call launches K27 or K28 (no
    plain route on the card) and matches the CPU's solve route within 1e-10
    of the value scale; a 9-band input raises."""
    from autobzcore_torch.models import selfenergy as se

    w = np.linspace(-5, 5, 41)
    vals = (0.1 * w[:, None, None] - 0.06j - 0.02j * w[:, None, None] ** 2) * np.eye(4) + 0.02 - 0.01j
    bz = T.load_bz(T.FBZ(), np.eye(2))
    om = np.linspace(-2.0, 2.0, 9)
    out = {}
    for dev in (cuda_device, "cpu"):
        h = ttb.synthetic_wannier(4, nr=3, ndim=2, seed=1, device=dev)
        S = se.SigmaInterpolant(w, vals, device=dev)
        before = (se.sigma_trace_sum.launches, se.sigma_pairs_sum.launches)
        out[str(dev)] = (se.SigmaDOSSolver(h, bz, 24, S)(om), se.SigmaDOSSolver(h, bz, 24, S, project=True)(om),
                         se.SigmaTransportSolver(h, bz, 24, S)(om))
        launched = (se.sigma_trace_sum.launches - before[0], se.sigma_pairs_sum.launches - before[1])
        assert launched == ((0, 0) if str(dev) == "cpu" else (2, 1))
    for got, want in zip(out[str(cuda_device)], out["cpu"]):
        assert np.max(np.abs(got - want)) <= 1e-10 * np.max(np.abs(want))
    H, V, wk, Z1, _ = _sigma_inputs(np.random.default_rng(350), 16, 9, 2, 3, cuda_device)
    with pytest.raises(ValueError, match="m <= 8"):
        se.sigma_trace_sum(H, wk, Z1, 1.0)
    with pytest.raises(ValueError, match="m <= 8"):
        se.sigma_pairs_sum(H, V, wk, Z1, Z1, 1.0)


def _lindhard_sigma_runs(device):
    """The families' entry points at small sizes on one device: Lindhard
    and Cooper on the flagship (npt 8), the self-energy DOS (trace and
    projected), transport and kinetic coefficients on graphene over its
    inversion wedge, and the DOS integrand under PTR and IAI. Returns the
    values, the evaluation counts and the kernels' launches."""
    from autobzcore_torch.models import lindhard as li
    from autobzcore_torch.models import selfenergy as se

    kernels = (li.chi0, li.cooper_mean, se.sigma_trace_sum, se.sigma_trace_points, se.sigma_pairs_sum)
    before = [k.launches for k in kernels]
    slv = li.LindhardSolver(ttb.flagship_series(device=device), T.load_bz(T.FBZ(), np.eye(3)), 8, 40.0, mu=0.1)
    vals = [slv([0.25, 0.125, -0.375], np.linspace(0.0, 3.0, 9)), [li.cooper_bubble(slv, [0.125, 0, 0])]]
    w = np.linspace(-4, 4, 33)
    S = se.SigmaInterpolant(w, (0.1 * w[:, None, None] - 0.08j - 0.02j * w[:, None, None] ** 2) * np.eye(2)
                            + np.array([[0.0, 0.03 - 0.01j], [0.03 - 0.01j, 0.0]]), device=device)
    h = ttb.tb_graphene(device=device)
    bzi = T.load_bz(T.InversionSymIBZ(), np.eye(2))
    om = np.linspace(-2.0, 2.0, 7)
    vals += [se.SigmaDOSSolver(h, bzi, 16, S)(om), se.SigmaDOSSolver(h, bzi, 16, S, project=True)(om).ravel(),
             se.SigmaTransportSolver(h, bzi, 16, S)(om).ravel()]
    kc = se.SigmaKineticCoefficientSolver(h, bzi, 12, S, 20.0, mu=0.3)
    vals.append(kc([0.0, 0.5], abstol=1e-6).ravel())
    fi = se.dos_integrand_sigma(h, S)
    bzf = T.load_bz(T.FBZ(), np.eye(2))
    sp = T.solve(T.IntegralProblem(fi, bzf, 0.7), T.PTR(npt=24, device=device))
    si = T.solve(T.IntegralProblem(fi, bzf, 0.7), T.IAI(inner_cap=64, device=device), abstol=1e-4)
    vals += [[float(sp.u)], [float(si.u)]]
    counts = (kc.numevals, kc.retcode, sp.numevals, si.numevals, si.retcode)
    return vals, counts, [k.launches - b for k, b in zip(kernels, before)]


def test_lindhard_and_sigma_entry_points_take_plain_versions_on_cpu():
    _, counts, launched = _lindhard_sigma_runs("cpu")
    assert launched == [0] * 5
    assert counts[1] and counts[4]


@pytest.mark.gpu
def test_lindhard_and_sigma_entry_points_on_card_match_cpu(cuda_device):
    """The families' entry points on the card (K25-K27 and K28's sum on
    their main paths) against the same calls on the CPU: 1e-10 of each
    result's scale, equal counts and retcodes, every kernel launched."""
    v_c, n_c, _ = _lindhard_sigma_runs("cpu")
    v_g, n_g, launched = _lindhard_sigma_runs(cuda_device)
    assert min(launched) > 0
    assert n_g == n_c
    for a, b in zip(v_g, v_c):
        a, b = np.asarray(a), np.asarray(b)
        assert np.max(np.abs(a - b)) <= 1e-10 * max(1.0, float(np.max(np.abs(b))))


# --- K29-K31 and K27's matrix mode ----------------------------------------------------------------------

from autobzcore_torch.models.kpath import band_expect, band_expect_plain, spectral_map, spectral_map_plain  # noqa: E402


def _kpath_inputs(rng, K, m, W, device):
    e = torch.as_tensor(np.sort(rng.uniform(-3, 3, (K, m)), axis=1), device=device)
    om = torch.linspace(-4.0, 4.0, W, dtype=torch.float64, device=device)
    return e, om


def _eigen_inputs(rng, N, m, d, device):
    """Eigenpairs of random Hermitian H and random Hermitian gradients, as
    ``eigh_chunked`` and K11 hand them over (dH a view with contiguous
    blocks)."""
    from autobzcore_torch.ops.eigh3 import eigh_chunked

    H = torch.as_tensor(random_hermitian(rng, N, m), device=device)
    J = torch.as_tensor(np.stack([random_hermitian(rng, N, m) for _ in range(d + 1)], axis=1), device=device)
    e, U = eigh_chunked(H)
    om = torch.as_tensor(rng.uniform(-2, 2, N), device=device)
    eta = torch.as_tensor(rng.uniform(0.05, 0.5, N), device=device)
    return e, U.contiguous(), J[:, 1:], om, eta


def test_slice_wrappers_take_plain_versions_on_cpu_without_counting():
    rng = np.random.default_rng(400)
    e, om = _kpath_inputs(rng, 30, 3, 17, "cpu")
    H = torch.as_tensor(random_hermitian(rng, 30, 3))
    O = torch.as_tensor(random_hermitian(rng, 1, 3)[0])
    H2 = torch.as_tensor(random_hermitian(rng, 30, 2))
    Z = torch.as_tensor(random_hermitian(rng, 5, 3)) + 0.3j * torch.eye(3, dtype=torch.complex128)
    w = torch.ones(30, dtype=torch.float64)
    eig = _eigen_inputs(rng, 30, 3, 2, "cpu")
    kernels = (spectral_map, band_expect, tobs.transport_points, tobs.spectral_weighted_sum,
               tobs.spectral_points)
    counts = [k.launches for k in kernels]
    assert torch.equal(spectral_map(e, om, 0.1), spectral_map_plain(e, om, 0.1))
    assert torch.equal(band_expect(H, O), band_expect_plain(H, O))
    assert torch.equal(band_expect(H2, O[:2, :2].contiguous(), fused=True),
                       band_expect_plain(H2, O[:2, :2].contiguous(), fused=True))
    assert torch.equal(tobs.transport_points(*eig), tobs.transport_points_plain(*eig))
    assert torch.equal(tobs.spectral_weighted_sum(H, w, Z, 0.5), tobs.spectral_weighted_sum_plain(H, w, Z, 0.5))
    assert torch.equal(tobs.spectral_points(H, Z[0].contiguous()), tobs.spectral_points_plain(H, Z[0]))
    assert [k.launches for k in kernels] == counts


def test_slice_wrappers_reject_what_the_kernels_do_not_take():
    rng = np.random.default_rng(401)
    e, om = _kpath_inputs(rng, 8, 3, 5, "cpu")
    H = torch.as_tensor(random_hermitian(rng, 8, 3))
    O = torch.as_tensor(random_hermitian(rng, 1, 3)[0])
    w = torch.ones(8, dtype=torch.float64)
    eig = _eigen_inputs(rng, 8, 3, 2, "cpu")
    with pytest.raises(ValueError):
        spectral_map(e.to(torch.float32), om, 0.1)
    with pytest.raises(ValueError):
        spectral_map(e, om[None], 0.1)
    with pytest.raises(ValueError):
        band_expect(H, O[:2, :2].contiguous())
    with pytest.raises(ValueError):
        band_expect(H, O.to(torch.complex64))
    with pytest.raises(ValueError):
        band_expect(H, O, fused=True)  # the fused eigh2 form is 2x2 only
    with pytest.raises(ValueError):
        tobs.transport_points(eig[0], eig[1], eig[2][:5], eig[3], eig[4])
    with pytest.raises(ValueError):
        tobs.transport_points(eig[0], eig[1], eig[2], eig[3][:7], eig[4])
    with pytest.raises(ValueError):
        tobs.transport_points(eig[0].to(torch.float32), *eig[1:])
    with pytest.raises(ValueError):
        tobs.spectral_weighted_sum(H, w[:7], H[:2].contiguous(), 1.0)
    with pytest.raises(ValueError):
        tobs.spectral_points(H, H[:3].contiguous())  # 3 matrices for 8 points
    meta = torch.device("meta")  # neither the CPU nor a card
    with pytest.raises(ValueError):
        spectral_map(e.to(meta), om.to(meta), 0.1)
    with pytest.raises(ValueError):
        spectral_map(e, om.to(meta), 0.1)
    with pytest.raises(ValueError):
        band_expect(H.to(meta), O.to(meta))
    with pytest.raises(ValueError):
        tobs.transport_points(*(t.to(meta) for t in eig))
    with pytest.raises(ValueError):
        tobs.spectral_weighted_sum(H.to(meta), w.to(meta), H[:2].to(meta), 1.0)
    with pytest.raises(ValueError):
        tobs.spectral_points(H.to(meta), H[0].to(meta))


@pytest.mark.gpu
@pytest.mark.parametrize("m", [1, 3, 30])
def test_spectral_map_kernel_matches_plain_on_card(cuda_device, m):
    """K29 over a ragged row and point count: 1e-12 relative, bit-identical
    repeats, one launch."""
    e, om = _kpath_inputs(np.random.default_rng(410 + m), 1_037, m, 301, cuda_device)
    before = spectral_map.launches
    got = spectral_map(e, om, 0.05)
    assert spectral_map.launches == before + 1
    want = spectral_map_plain(e, om, 0.05)
    assert float((got - want).abs().max()) <= 1e-12 * float(want.abs().max())
    assert torch.equal(got, spectral_map(e, om, 0.05))


@pytest.mark.gpu
@pytest.mark.parametrize("m", [1, 2, 3, 4, 30])
def test_band_expect_kernel_matches_plain_on_card(cuda_device, m):
    """K30 on shared eigenvectors (and at m = 2 fused with eigh2 from H):
    1e-12 of the operator's scale, bit-identical repeats."""
    from autobzcore_torch.ops.eigh3 import eigh_chunked

    rng = np.random.default_rng(420 + m)
    H = torch.as_tensor(random_hermitian(rng, 2_049, m), device=cuda_device)
    O = torch.as_tensor(random_hermitian(rng, 1, m)[0], device=cuda_device)
    _, U = eigh_chunked(H)
    U = U.contiguous()
    scale = float(O.abs().max())
    for V, fused in ((U, False),) + (((H, True),) if m == 2 else ()):
        got = band_expect(V, O, fused)
        want = band_expect_plain(V, O, fused)
        assert float((got - want).abs().max()) <= 1e-12 * scale
        assert torch.equal(got, band_expect(V, O, fused))


@pytest.mark.gpu
@pytest.mark.parametrize("m,d", [(1, 1), (2, 2), (3, 3), (4, 2), (8, 3)])
def test_transport_points_kernel_matches_plain_on_card(cuda_device, m, d):
    """K31 on one eigh output: 1e-12 relative, a symmetric result,
    bit-identical repeats."""
    args = _eigen_inputs(np.random.default_rng(430 + m), 3_001, m, d, cuda_device)
    before = tobs.transport_points.launches
    got = tobs.transport_points(*args)
    assert tobs.transport_points.launches == before + 1
    want = tobs.transport_points_plain(*args)
    assert float((got - want).abs().max()) <= 1e-12 * float(want.abs().max())
    assert torch.equal(got, got.transpose(1, 2))
    assert torch.equal(got, tobs.transport_points(*args))


@pytest.mark.gpu
@pytest.mark.parametrize("m", [1, 2, 3, 4, 8])
def test_spectral_sum_kernel_matches_plain_on_card(cuda_device, m):
    """K27's matrix mode over a ragged point count and 37 lanes, and its
    pointwise entry with one Z per point and one for all: 1e-12 of the value
    scale, exactly Hermitian, bit-identical repeats; its trace against K27's
    trace mode on the same inputs. Then on the lanes' z (Z = z I, as
    spectral_function and the PTR rule pass it) at eta 1e-3 and 0.1, half
    the lanes on an eigenvalue of some H_k, against the plain versions at Z
    = z I, a lane's bits the same alone."""
    from autobzcore_torch.models import selfenergy as se

    rng = np.random.default_rng(440 + m)
    H, _, w, Z, _ = _sigma_inputs(rng, 10_007, m, 1, 37, cuda_device)
    before = tobs.spectral_weighted_sum.launches
    got = tobs.spectral_weighted_sum(H, w, Z, 0.3)
    assert tobs.spectral_weighted_sum.launches == before + 1
    want = tobs.spectral_weighted_sum_plain(H, w, Z, 0.3)
    scale = float(want.abs().max())
    assert float((got - want).abs().max()) <= 1e-12 * scale
    assert torch.equal(got, got.conj().transpose(1, 2))
    assert torch.equal(got, tobs.spectral_weighted_sum(H, w, Z, 0.3))
    trace = torch.diagonal(got, dim1=1, dim2=2).sum(-1)
    assert float((trace.real - se.sigma_trace_sum(H, w, Z, 0.3)).abs().max()) <= 1e-12 * scale
    for Zp in (_sigma_z(rng, 10_007, m, cuda_device), Z[3].contiguous()):
        got = tobs.spectral_points(H, Zp)
        want = tobs.spectral_points_plain(H, Zp)
        assert float((got - want).abs().max()) <= 1e-12 * float(want.abs().max())
        assert torch.equal(got, tobs.spectral_points(H, Zp))
    eye = torch.eye(m, dtype=torch.complex128, device=cuda_device)
    for eta in (1e-3, 0.1):
        z = torch.as_tensor(_pole_lanes(rng, H, 37, eta), device=cuda_device)
        before = tobs.spectral_weighted_sum.launches
        got = tobs.spectral_weighted_sum(H, w, z, 0.3)
        assert tobs.spectral_weighted_sum.launches == before + 1
        want = tobs.spectral_weighted_sum_plain(H, w, (z[:, None, None] * eye).contiguous(), 0.3)
        assert float((got - want).abs().max()) <= 1e-12 * float(want.abs().max())
        assert torch.equal(got, got.conj().transpose(1, 2))
        assert torch.equal(got, tobs.spectral_weighted_sum(H, w, z, 0.3))
        assert torch.equal(got[-1:], tobs.spectral_weighted_sum(H, w, z[-1:].contiguous(), 0.3))
        for zp in (z[torch.arange(10_007, device=cuda_device) % 37].contiguous(), z[-1].contiguous()):
            got = tobs.spectral_points(H, zp)
            want = tobs.spectral_points_plain(H, zp)
            assert float((got - want).abs().max()) <= 1e-12 * float(want.abs().max())
            assert torch.equal(got, tobs.spectral_points(H, zp))


@pytest.mark.gpu
def test_spectral_function_on_card_runs_k27_or_raises(cuda_device):
    """spectral_function on the card runs K27 and nothing else: under PTR its
    matrix mode, under IAI in the batched form its pointwise entry, each
    against the same solve on the CPU (1e-10, equal counts); the unbatched
    form under IAI, which would call it under vmap, raises."""
    from autobzcore_torch.models.tight_binding import tb_graphene

    bz = T.load_bz(T.FBZ(), np.eye(2))

    def solves(dev):
        h = tb_graphene(device=dev)
        ptr = T.solve(T.IntegralProblem(T.FourierIntegrand(tobs.spectral_function, h, eta=0.2), bz, 0.5),
                      T.PTR(npt=40, device=dev))
        iai = T.solve(T.IntegralProblem(T.FourierIntegrand(tobs.spectral_function, h, eta=0.2, batched=True),
                                        bz, 0.5), T.IAI(device=dev), abstol=1e-4)
        return ptr, iai

    n_sum, n_pts = tobs.spectral_weighted_sum.launches, tobs.spectral_points.launches
    card = solves(cuda_device)
    assert tobs.spectral_weighted_sum.launches > n_sum and tobs.spectral_points.launches > n_pts
    for g, c in zip(card, solves("cpu")):
        assert float((g.u.cpu() - c.u).abs().max()) <= 1e-10 * float(c.u.abs().max())
        assert g.numevals == c.numevals
    with pytest.raises(ValueError, match="batched=True"):
        T.solve(T.IntegralProblem(T.FourierIntegrand(tobs.spectral_function, tb_graphene(device=cuda_device),
                                                     eta=0.2), bz, 0.5), T.IAI(device=cuda_device), abstol=1e-4)


@pytest.mark.gpu
def test_slice_wrappers_refuse_more_bands_on_card(cuda_device):
    rng = np.random.default_rng(450)
    H, _, w, Z, _ = _sigma_inputs(rng, 16, 9, 1, 3, cuda_device)
    with pytest.raises(ValueError):
        tobs.spectral_weighted_sum(H, w, Z, 1.0)
    with pytest.raises(ValueError):
        tobs.transport_points(*_eigen_inputs(rng, 16, 9, 2, cuda_device))
    U = torch.as_tensor(random_hermitian(rng, 4, 33), device=cuda_device)
    with pytest.raises(ValueError):
        band_expect(U, U[0].contiguous())


def _hard_hermitian(rng, K, m, scale=1.0):
    """K Hermitian m x m matrices: random ones, then (m > 1) exactly
    degenerate pairs, pairs 1e-9 apart, scalar matrices and zeros, rotated by
    random unitaries, at ``scale``."""
    parts = [random_hermitian(rng, K, m)]
    if m > 1:
        Q, _ = np.linalg.qr(rng.normal(size=(K, m, m)) + 1j * rng.normal(size=(K, m, m)))
        for gap in (0.0, 1e-9):
            e = np.sort(rng.uniform(-1, 1, size=(K, m)), axis=1)
            e[:, 1] = e[:, 0] + gap
            parts.append(np.einsum("kij,kj,klj->kil", Q, e, Q.conj()))
    parts.append(np.eye(m)[None] * rng.normal(size=(K, 1, 1)) + 0j)
    parts.append(np.zeros((K // 10, m, m), complex))
    return np.concatenate(parts) * scale


def _cluster_check(e, v, pv, scale, vmax):
    """Per-band velocities v against pv where a band's gap to its nearest
    neighbour g (over the energy scale) is at least 1e-6: within 1e-13 /
    min(g, 1) of max|v|; below, the sums over each cluster of such bands within 1e-12 of
    max|v|. e (K, m) ascending; v, pv (K, d, m) numpy."""
    K, m = e.shape
    de = np.diff(e, axis=1) / scale if m > 1 else np.zeros((K, 0))
    g = np.full((K, m), np.inf)
    if m > 1:
        g[:, 1:] = de
        g[:, :-1] = np.minimum(g[:, :-1], de)
    sep = g >= 1e-6
    tol = 1e-13 / np.minimum(np.where(sep, g, 1.0), 1.0) * vmax
    assert np.all((np.abs(v - pv) <= tol[:, None, :]) | ~sep[:, None, :])
    label = np.concatenate([np.zeros((K, 1), int), np.cumsum(de >= 1e-6, axis=1)], axis=1)
    for c in range(m):
        mask = (label == c)[:, None, :]
        assert np.abs((v * mask).sum(-1) - (pv * mask).sum(-1)).max() <= 1e-12 * vmax


@pytest.mark.gpu
@pytest.mark.parametrize("m,d", [(1, 1), (1, 3), (2, 2), (2, 3), (3, 1), (3, 3)])
def test_band_velocity_eigh_kernel_matches_plain_on_card(cuda_device, m, d):
    """K12's fused entry on hard H (degenerate, 1e-9 gaps, scalar, zero) and
    random dH in one contiguous J: the energies bit-equal to the register
    solver's mirror and within 1e-12 of the scale of cuSOLVER's, the
    velocities within 1e-13 of max|v| of the mirror's eigenvectors' and
    against cuSOLVER's by each band's gap (or its cluster's sum), bit-identical
    repeats, one launch."""
    from autobzcore_torch.dos import ggr as tggr
    from autobzcore_torch.ops.eigh3 import eigh3_jacobi

    rng = np.random.default_rng(150 + 10 * m + d)
    H = _hard_hermitian(rng, 1_500, m, 2.5)
    K = H.shape[0]
    J = torch.as_tensor(np.stack([H] + [random_hermitian(rng, K, m) for _ in range(d)], axis=1), device=cuda_device)
    before = tggr.band_velocity_eigh.launches
    e, v = tggr.band_velocity_eigh(J)
    assert tggr.band_velocity_eigh.launches == before + 1
    e2, v2 = tggr.band_velocity_eigh(J)
    assert torch.equal(e, e2) and torch.equal(v, v2)
    me, mU = eigh3_jacobi(J[:, 0])
    assert torch.equal(e, me)
    mv = tggr.band_velocity_plain(mU, J[:, 1:])
    vmax = float(mv.abs().max())
    assert float((v - mv).abs().max()) <= 1e-13 * vmax
    pe, pv = tggr.band_velocity_eigh_plain(J)
    scale = float(pe.abs().max())
    assert float((e - pe).abs().max()) <= 1e-12 * scale
    _cluster_check(pe.cpu().numpy(), v.cpu().numpy(), pv.cpu().numpy(), scale, vmax)


@pytest.mark.gpu
@pytest.mark.parametrize("m,d", [(1, 1), (2, 2), (2, 3), (3, 2), (3, 3)])
def test_transport_points_eigh_kernel_matches_plain_on_card(cuda_device, m, d):
    """K31's fused entry on hard H and random dH as views of one K11-shaped
    tensor, om and eta as numbers, one-value tensors and one a point: 1e-12
    relative against eigh + K31's plain version, symmetric, bit-identical
    repeats, one launch a call."""
    rng = np.random.default_rng(160 + 10 * m + d)
    H = _hard_hermitian(rng, 900, m)
    K = H.shape[0]
    J = torch.as_tensor(np.stack([H] + [random_hermitian(rng, K, m) for _ in range(d)], axis=1), device=cuda_device)
    om = torch.as_tensor(rng.uniform(-2, 2, K), device=cuda_device)
    one = torch.tensor(0.4, dtype=torch.float64, device=cuda_device)
    for w, g in ((0.4, 0.2), (om, 0.2), (one, om.abs() + 0.05), (om, one)):
        before = tobs.transport_points_eigh.launches
        got = tobs.transport_points_eigh(J[:, 0], J[:, 1:], w, g)
        assert tobs.transport_points_eigh.launches == before + 1
        want = tobs.transport_points_eigh_plain(J[:, 0], J[:, 1:], w, g)
        assert float((got - want).abs().max()) <= 1e-12 * float(want.abs().max())
        assert torch.equal(got, got.transpose(1, 2))
        assert torch.equal(got, tobs.transport_points_eigh(J[:, 0], J[:, 1:], w, g))


@pytest.mark.gpu
@pytest.mark.parametrize("m", [1, 2, 3])
@pytest.mark.parametrize("scale", [1e-8, 1e8])
def test_band_velocity_eigh_kernel_matches_mirror_across_scales_on_card(cuda_device, m, scale):
    """K12's fused entry on hard H at scales 1e-8 and 1e8 (dH at unit
    scale) against the register solver's mirror on the same card tensors:
    the energies bit-equal, the velocities within 1e-13 of max|v| of the
    mirror's eigenvectors'."""
    from autobzcore_torch.dos import ggr as tggr
    from autobzcore_torch.ops.eigh3 import eigh3_jacobi

    rng = np.random.default_rng(170 + m)
    H = _hard_hermitian(rng, 2_000, m, scale)
    K = H.shape[0]
    J = torch.as_tensor(np.stack([H] + [random_hermitian(rng, K, m) for _ in range(3)], axis=1), device=cuda_device)
    e, v = tggr.band_velocity_eigh(J)
    me, mU = eigh3_jacobi(J[:, 0])
    assert torch.equal(e, me)
    mv = tggr.band_velocity_plain(mU, J[:, 1:])
    assert float((v - mv).abs().max()) <= 1e-13 * float(mv.abs().max())


@pytest.mark.gpu
def test_fused_routes_make_no_eigh_call_on_card(cuda_device, monkeypatch):
    """At m <= 3 spectral_grid is one K11 and one fused K12 launch (the
    plain route within 1e-12 of the energy scale, the velocities per band by
    its gap or by its cluster's sum) and a batched transport
    integrand call one fused K31 launch (the CPU's route within 1e-12), with
    no torch.linalg.eigh call."""
    from autobzcore_torch.dos import ggr as tggr

    calls = []
    real = torch.linalg.eigh
    h = ttb.flagship_series(device=cuda_device)
    bz = T.load_bz(T.FBZ(), np.eye(3))
    pe, pv, _ = tggr.spectral_grid(h, bz, 12, velocities=tggr.band_velocity_plain)
    monkeypatch.setattr(torch.linalg, "eigh", lambda *a, **k: calls.append(1) or real(*a, **k))
    before = (tggr.band_velocity_eigh.launches, tggr.band_velocity.launches)
    e, v, _ = tggr.spectral_grid(h, bz, 12)
    assert (tggr.band_velocity_eigh.launches, tggr.band_velocity.launches) == (before[0] + 1, before[1])
    assert float((e - pe).abs().max()) <= 1e-12 * float(pe.abs().max())
    _cluster_check(pe.cpu().numpy(), v.cpu().numpy(), pv.cpu().numpy(), float(pe.abs().max()),
                   float(pv.abs().max()))
    g = ttb.tb_graphene(device=cuda_device)
    X = torch.rand(700, 2, dtype=torch.float64, generator=torch.Generator().manual_seed(3))
    Hv = T.JacobianSeries(g).eval_points(X.to(cuda_device))
    before = tobs.transport_points_eigh.launches
    G = tobs.transport_distribution_points(T.FourierValue(X, Hv), 0.5, eta=0.3)
    assert tobs.transport_points_eigh.launches == before + 1 and not calls
    gc = ttb.tb_graphene(device="cpu")
    Gc = tobs.transport_distribution_points(T.FourierValue(X, T.JacobianSeries(gc).eval_points(X)), 0.5, eta=0.3)
    assert float((G.cpu() - Gc).abs().max()) <= 1e-12 * float(Gc.abs().max())


@pytest.mark.gpu
def test_transport_integrand_broadcasts_as_the_cpu_route_on_card(cuda_device):
    """The batched transport integrand on a (20, 35) batch of graphene
    points: om and eta broadcast to the batch as on the CPU (the card's fused
    route within 1e-12 of the CPU's), and an om the CPU route refuses is
    refused on the card too."""
    g, gc = ttb.tb_graphene(device=cuda_device), ttb.tb_graphene(device="cpu")
    X = torch.rand(700, 2, dtype=torch.float64, generator=torch.Generator().manual_seed(4))
    rng = np.random.default_rng(5)
    cases = ((torch.as_tensor(rng.uniform(-1, 1, 35)), 0.3), (torch.as_tensor(rng.uniform(-1, 1, (20, 1))), 0.3),
             (0.5, torch.as_tensor(rng.uniform(0.1, 0.5, (20, 35)))), (torch.tensor(0.5, dtype=torch.float64), 0.3))

    def run(dev, series):
        H, V = T.JacobianSeries(series).eval_points(X.to(dev))
        hv = T.FourierValue(X, (H.reshape(20, 35, 2, 2), V.reshape(20, 35, 2, 2, 2)))
        with pytest.raises(RuntimeError):
            tobs.transport_distribution_points(hv, torch.zeros((700, 1), dtype=torch.float64, device=dev), eta=0.3)
        return [tobs.transport_distribution_points(hv, *(x.to(dev) if isinstance(x, torch.Tensor) else x for x in c))
                for c in cases]

    for G, Gc in zip(run(cuda_device, g), run("cpu", gc)):
        assert G.shape == Gc.shape == (20, 35, 2, 2)
        assert float((G.cpu() - Gc).abs().max()) <= 1e-12 * float(Gc.abs().max())
