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


@pytest.mark.gpu
@pytest.mark.parametrize("build", [
    lambda dev: ttb.tb_integer(1, device=dev),
    lambda dev: ttb.tb_graphene(device=dev),
    # an 11^3 box of 4x4 values: several coefficient tiles and value passes
    lambda dev: ttb.synthetic_wannier(4, nr=11, seed=3, device=dev),
], ids=["1d", "2d", "3d_m4_nr11"])
def test_fourier_kernel_matches_plain_on_card(cuda_device, build):
    s = build(cuda_device)
    X = torch.rand(5001, s.sndim, dtype=torch.float64, device=cuda_device)  # a ragged last block
    before = fourier_points.launches
    got = fourier_points(s.c, X, s.offset, s.period)
    assert fourier_points.launches == before + 1
    want = fourier_points_plain(s.c, X, s.offset, s.period)
    assert float((got - want).abs().max() / want.abs().max()) <= 1e-12


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
    H = torch.as_tensor(random_hermitian(np.random.default_rng(0), 8, 4), device=cuda_device)
    w = torch.ones(8, dtype=torch.float64, device=cuda_device)
    om = torch.zeros(3, dtype=torch.float64, device=cuda_device)
    with pytest.raises(NotImplementedError, match="B2"):
        tobs.dos_trace_weighted_sum(H, w, om, om + 0.1, 1.0)


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
    with pytest.raises(NotImplementedError, match="B2"):
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
    return tad.GKPool(**{k: (v.clone() if isinstance(v, torch.Tensor) else v)
                         for k, v in pool.__dict__.items()})


@pytest.mark.gpu
@pytest.mark.parametrize("nb", [1, 2, 4])
@pytest.mark.parametrize("V,complex_vals", [((), False), ((3,), True)], ids=["real", "complex3"])
def test_pool_kernels_match_plain_on_card(cuda_device, nb, V, complex_vals):
    rng = np.random.default_rng(30 + nb)
    pool = _random_pool(rng, cuda_device, nb=nb, V=V, complex_vals=complex_vals)
    ref = _clone_pool(pool)
    before = dict(tad.gk_pool_launches)
    idx, ca, cb = tad.gk_pool_select(pool, nb)
    ridx, rca, rcb = tad.gk_pool_select_plain(ref, nb)
    assert torch.equal(pool.active, ref.active)
    live = ref.active
    assert 0 < int(live.sum()) < live.numel()
    assert torch.equal(idx[live], ridx[live])
    assert torch.equal(ca, rca) and torch.equal(cb, rcb)
    L = pool.nlanes
    cval = torch.as_tensor(rng.normal(size=(L, 2 * nb) + V), device=cuda_device).to(pool.val.dtype)
    cerr = torch.as_tensor(rng.random((L, 2 * nb)), device=cuda_device)
    cl1 = cerr * 3
    count = torch.full((L,), 2.0 * nb * 15, dtype=torch.float64, device=cuda_device)
    tad.gk_pool_update(pool, nb, idx, ca, cb, cval, cerr, cl1, count)
    tad.gk_pool_update_plain(ref, nb, ridx, rca, rcb, cval, cerr, cl1, count)
    for name in ("a", "b", "err", "l1", "val", "n", "evals"):
        assert torch.equal(getattr(pool, name), getattr(ref, name)), name
    assert float(((pool.tot_err - ref.tot_err).abs() / ref.tot_err.abs().clamp_min(1e-300)).max()) <= 1e-14
    tv, rv = pool.tot_val.reshape(L, -1), ref.tot_val.reshape(L, -1)
    assert float(((tv - rv).abs().amax(1) / rv.abs().amax(1).clamp_min(1e-300)).max()) <= 1e-14
    assert torch.allclose(pool.tol, ref.tol, rtol=1e-14, atol=0)
    assert tad.gk_pool_launches["select"] == before["select"] + 1
    assert tad.gk_pool_launches["update"] == before["update"] + 1


@pytest.mark.gpu
def test_pool_select_breaks_the_collision_as_the_reference(cuda_device):
    """One live slot of n = 1 and nbisect = 2: the second pick is the dead
    slot 1 (error 0, the lowest such index), which the fresh right child
    of slot 0 must overwrite."""
    dev = cuda_device
    z = lambda *s: torch.zeros(s, dtype=torch.float64, device=dev)  # noqa: E731
    a, b, err = z(1, 8), z(1, 8), z(1, 8)
    b[0, 0], err[0, 0] = 1.0, 0.5
    pool = tad.GKPool(a=a, b=b, err=err, l1=err.clone(), val=z(1, 8), n=torch.ones(1, dtype=torch.int64, device=dev),
                      evals=z(1), atol=z(1) + 1e-9, rtol=0.0, max_evals=1e9,
                      active=torch.ones(1, dtype=torch.bool, device=dev))
    tad.gk_pool_totals(pool)
    idx, ca, cb = tad.gk_pool_select(pool, 2)
    assert idx.tolist() == [[0, 1]]
    cval = torch.tensor([[1.0, 2.0, 3.0, 4.0]], dtype=torch.float64, device=dev)
    tad.gk_pool_update(pool, 2, idx, ca, cb, cval, cval / 10, cval, z(1) + 60)
    assert pool.n.tolist() == [3]
    assert pool.a[0, :3].tolist() == [0.0, 0.5, 0.0] and pool.b[0, :3].tolist() == [0.5, 1.0, 0.0]
    assert pool.val[0, :3].tolist() == [1.0, 3.0, 4.0]


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
    and an update with a pick outside the pool, or without room, writes
    nothing and sets the lane's totals to NaN (K5)."""
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
    pool = _random_pool(rng, dev, L=3, cap=8, nb=1)
    pool.active[:] = True
    pool.n[:] = torch.tensor([2, 2, 8], device=dev)  # lane 2 has no room
    before = _clone_pool(pool)
    idx = torch.tensor([[0], [9], [1]], dtype=torch.int64, device=dev)  # lane 1 picks past cap
    ch = torch.ones((3, 2), dtype=torch.float64, device=dev)
    tad.gk_pool_update(pool, 1, idx, ch, ch, ch.clone(), ch.clone(), ch.clone(),
                       torch.ones(3, dtype=torch.float64, device=dev))
    assert torch.isfinite(pool.tot_err[0]) and torch.isnan(pool.tot_err[1:]).all()
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
    before = tad.gk_pool_launches["seed"]
    tad.gk_pool_seed(pool, 12, ch, ch, ch.clone(), ch.clone(), ch.clone(), ch[:, 0].clone(),
                     pool.n.clone(), seeding)
    assert tad.gk_pool_launches["seed"] == before
    with pytest.raises(ValueError, match="does not fit"):
        tad.gk_pool_seed(pool, 13, ch, ch, ch, ch, ch, ch[:, 0], pool.n, seeding)


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
    """K5's seed entry against its plain version: a chunk written to the
    seeding lanes' contiguous slots, n = n0, evals += count, the totals."""
    rng = np.random.default_rng(70)
    pool = _random_pool(rng, cuda_device, L=300, cap=64, nb=1, V=V, complex_vals=complex_vals)
    ref = _clone_pool(pool)
    L, C, start = pool.nlanes, 8, 56
    ca = torch.as_tensor(rng.random((L, C)), device=cuda_device)
    cb = ca + torch.as_tensor(rng.random((L, C)), device=cuda_device)
    cval = torch.as_tensor(rng.normal(size=(L, C) + V), device=cuda_device).to(pool.val.dtype)
    cerr = torch.as_tensor(rng.random((L, C)), device=cuda_device)
    count = torch.full((L,), 8.0 * 15, dtype=torch.float64, device=cuda_device)
    n0 = torch.as_tensor(rng.integers(50, 64, L), device=cuda_device)
    seeding = torch.as_tensor(rng.random(L) > 0.2, device=cuda_device)
    before = tad.gk_pool_launches["seed"]
    tad.gk_pool_seed(pool, start, ca, cb, cval, cerr, cerr * 3, count, n0, seeding)
    assert tad.gk_pool_launches["seed"] == before + 1
    tad.gk_pool_seed_plain(ref, start, ca, cb, cval, cerr, cerr * 3, count, n0, seeding)
    for name in ("a", "b", "err", "l1", "val", "n", "evals"):
        assert torch.equal(getattr(pool, name), getattr(ref, name)), name
    assert float(((pool.tot_err - ref.tot_err).abs() / ref.tot_err.abs().clamp_min(1e-300)).max()) <= 1e-14
    tv, rv = pool.tot_val.reshape(L, -1), ref.tot_val.reshape(L, -1)
    assert float(((tv - rv).abs().amax(1) / rv.abs().amax(1).clamp_min(1e-300)).max()) <= 1e-14


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
