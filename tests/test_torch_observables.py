"""Parity of the port's DOS observables (plain PyTorch and the plain version
of kernel K2) with the JAX package, on the same seeded Hamiltonians."""
import math

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from autobzcore_tpu.fourier import FourierValue as JValue
from autobzcore_tpu.models import observables as jobs
from autobzcore_tpu.utils.tree import tree_weighted_sum

from autobzcore_torch.fourier import FourierValue as TValue
from autobzcore_torch.models import observables as tobs
from torch_parity import random_hermitian, rel_err

torch.set_num_threads(2)

ETA = 0.1
OMEGAS = np.linspace(-2.5, 2.5, 7)


def _jax_per_k(fn, H, om):
    """The JAX kernel at each k with frequencies ``om`` (scalar or block)."""
    return np.asarray(jax.vmap(lambda h: fn(JValue(None, h), jnp.asarray(om), eta=ETA))(jnp.asarray(H)))


def _port_per_k(fn, H, om):
    return torch.func.vmap(lambda h: fn(TValue(None, h), torch.as_tensor(om, dtype=torch.float64), eta=ETA))(
        torch.as_tensor(H)).numpy()


@pytest.mark.parametrize("m", [1, 2, 3, 4])
@pytest.mark.parametrize("block", [False, True], ids=["scalar_omega", "omega_block"])
@pytest.mark.parametrize("name", ["greens_function_trace", "dos_trace"])
def test_trace_matches_reference(name, block, m):
    H = random_hermitian(np.random.default_rng(m), 40, m)
    om = OMEGAS if block else 0.37
    want = _jax_per_k(getattr(jobs, name), H, om)
    got = _port_per_k(getattr(tobs, name), H, om)
    assert got.shape == want.shape
    assert rel_err(got, want) <= 1e-12


@pytest.mark.parametrize("m", [1, 2, 3, 4])
def test_plain_weighted_sum_matches_reference(m):
    rng = np.random.default_rng(10 + m)
    H = random_hermitian(rng, 300, m)
    w = rng.random(300) + 0.5
    scale = 0.0123
    fx = jax.vmap(lambda h: jobs.dos_trace(JValue(None, h), jnp.asarray(OMEGAS), eta=ETA))(jnp.asarray(H))
    want = scale * np.asarray(tree_weighted_sum(jnp.asarray(w), fx, axis=0))
    om = torch.as_tensor(OMEGAS)
    got = tobs.dos_trace_weighted_sum(torch.as_tensor(H), torch.as_tensor(w), om,
                                      torch.full_like(om, ETA), scale).numpy()
    assert rel_err(got, want) <= 1e-12


def _near_degenerate(rng, K, m, center=0.7, split=1e-9):
    """K Hermitian matrices with one m-fold eigenvalue ``center`` split by
    ``split`` (center, center + split, ...), in random unitary bases."""
    a = rng.normal(size=(K, m, m)) + 1j * rng.normal(size=(K, m, m))
    Q = np.linalg.qr(a)[0]
    ev = center + split * np.arange(m)
    return Q @ (ev[:, None] * np.swapaxes(Q.conj(), 1, 2))


@pytest.mark.parametrize("m,kind", [(1, "non_hermitian"), (2, "non_hermitian"), (3, "non_hermitian"),
                                    (2, "near_degenerate"), (3, "near_degenerate")])
def test_plain_weighted_sum_matches_reference_on_hard_matrices(m, kind):
    """The PTR rule's sum (the reference's ``tree_weighted_sum`` of
    ``dos_trace``) on the matrices K2's form must keep: general complex H
    (not Hermitian, its eigenvalues off the real axis) at eta 0.1, and an
    m-fold eigenvalue split by 1e-9 at eta 1e-3 with frequencies on and
    beside it."""
    rng = np.random.default_rng(20 + m)
    if kind == "non_hermitian":
        H = rng.normal(size=(300, m, m)) + 1j * rng.normal(size=(300, m, m))
        om, eta = OMEGAS, ETA
    else:
        H = _near_degenerate(rng, 300, m)
        om, eta = 0.7 + np.array([-3e-3, -1e-3, 0.0, 5e-10, 1e-3, 2e-2]), 1e-3
    w = rng.random(300) + 0.5
    scale = 0.0123
    fx = jax.vmap(lambda h: jobs.dos_trace(JValue(None, h), jnp.asarray(om), eta=eta))(jnp.asarray(H))
    want = scale * np.asarray(tree_weighted_sum(jnp.asarray(w), fx, axis=0))
    omt = torch.as_tensor(om)
    got = tobs.dos_trace_weighted_sum_plain(torch.as_tensor(H), torch.as_tensor(w), omt,
                                            torch.full_like(omt, eta), scale).numpy()
    assert rel_err(got, want) <= 1e-12


def test_plain_weighted_sum_chunks_over_k():
    """Enough k-points and lanes that the plain version takes several
    chunks; the sum must not depend on the chunking."""
    rng = np.random.default_rng(3)
    H = torch.as_tensor(random_hermitian(rng, 5000, 3))
    w = torch.ones(5000, dtype=torch.float64)
    om = torch.linspace(-3, 3, 200, dtype=torch.float64)
    eta = torch.full_like(om, 0.05)
    got = tobs.dos_trace_weighted_sum_plain(H, w, om, eta, 1.0)
    want = sum(tobs.dos_trace_weighted_sum_plain(H[i:i + 50], w[i:i + 50], om, eta, 1.0)
               for i in range(0, 5000, 50))
    assert float((got - want).abs().max() / want.abs().max()) <= 1e-12


def test_dos_integrand_declares_trivial_rep():
    from autobzcore_torch import TrivialRep
    from autobzcore_torch.models.tight_binding import tb_integer

    fi = tobs.dos_integrand(tb_integer(2, device="cpu"), 0.1)
    assert isinstance(fi.rep, TrivialRep)
    assert fi.pf.f is tobs.dos_trace and fi.p.eta == 0.1
    # one k-point through the pointwise fallback equals the closed form
    x = torch.tensor([0.1, 0.3], dtype=torch.float64)
    e = 2 * (math.cos(2 * math.pi * 0.1) + math.cos(2 * math.pi * 0.3))
    assert abs(float(fi(x, 0.2)) - 0.1 / ((0.2 - e) ** 2 + 0.01) / math.pi) <= 1e-12


# --- spectral_function and the batched transport integrand ----------------------------------------


def _bzs(kind, d):
    import autobzcore_torch as T
    import autobzcore_tpu as J

    return J.load_bz(getattr(J, kind)(), np.eye(d)), T.load_bz(getattr(T, kind)(), np.eye(d))


def _flagship_pair():
    import __graft_entry__ as g
    from autobzcore_torch.models.tight_binding import flagship_series

    return g._flagship_series(jnp.complex128), flagship_series(device="cpu")


@pytest.mark.parametrize("m", [1, 2, 3, 4])
@pytest.mark.parametrize("block", [False, True], ids=["scalar_omega", "omega_block"])
def test_spectral_function_matches_reference(m, block):
    """Pointwise, under vmap as a nest evaluates it, and on a batch of points
    (K27's matrix pointwise entry, here its plain version): the
    reference's value at each point and frequency, Hermitian, with trace
    dos_trace."""
    H = random_hermitian(np.random.default_rng(20 + m), 30, m)
    oms = OMEGAS if block else [0.37]
    want = np.stack([_jax_per_k(jobs.spectral_function, H, om) for om in oms], axis=1)
    if block:
        got = _port_per_k(tobs.spectral_function, H, OMEGAS)
    else:
        got = tobs.spectral_function(TValue(None, torch.as_tensor(H)), 0.37, eta=ETA).numpy()[:, None]
    assert got.shape == want.shape
    assert rel_err(got, want) <= 1e-12
    assert np.abs(got - got.conj().swapaxes(-1, -2)).max() <= 1e-15 * np.abs(got).max()
    tr = np.trace(got, axis1=-2, axis2=-1).real
    dos = _port_per_k(tobs.dos_trace, H, oms if block else 0.37)
    assert rel_err(tr, dos if block else dos[:, None]) <= 1e-12


def test_spectral_function_trace_matches_dos():
    """The reference's test_spectral_function_trace_matches_dos on the port."""
    from autobzcore_torch.models.tight_binding import tb_integer

    s = tb_integer(2, device="cpu")
    hv = TValue(None, s(np.array([0.13, 0.41])))
    A = tobs.spectral_function(hv, 0.5, eta=0.1)
    assert float(torch.trace(A).real) == pytest.approx(float(tobs.dos_trace(hv, 0.5, eta=0.1)), rel=1e-10)


@pytest.mark.parametrize("model,kind", [("integer", "FBZ"), ("integer", "InversionSymIBZ"), ("flagship", "FBZ")])
def test_spectral_function_under_ptr_matches_reference(model, kind):
    """The PTR route (K27's matrix mode, its plain version) at a lane vector
    of frequencies against the reference's per-frequency solves, and its
    trace against the DOS route (K2's plain version). The one-band model's
    1 x 1 spectral function transforms trivially, which lets it run on the
    inversion wedge; the flagship has no point symmetry."""
    import autobzcore_torch as T
    import autobzcore_tpu as J
    from autobzcore_torch.models.tight_binding import tb_integer
    from autobzcore_torch.parallel.sweep import sweep_solve
    from autobzcore_tpu.models.tight_binding import tb_integer as jtb_integer

    hj, ht = (jtb_integer(2), tb_integer(2, device="cpu")) if model == "integer" else _flagship_pair()
    d = 2 if model == "integer" else 3
    npt = 12 if model == "integer" else 6
    bzj, bzt = _bzs(kind, d)
    oms = np.linspace(-2.0, 2.5, 5)
    fi = T.FourierIntegrand(tobs.spectral_function, ht, eta=0.2)
    fj = J.FourierIntegrand(jobs.spectral_function, hj, eta=0.2)
    if kind != "FBZ":
        fi.rep, fj.rep = T.TrivialRep(), J.TrivialRep()
    u, _, conv, ne = sweep_solve(T.IntegralProblem(fi, bzt), T.PTR(npt=npt, device="cpu"), T.MixedParameters(oms))
    want = np.stack([np.asarray(J.solve(J.IntegralProblem(fj, bzj, float(o)), J.PTR(npt=npt)).u) for o in oms])
    m = ht.valshape[0]
    assert u.shape == (5, m, m) and conv.all()
    assert rel_err(u.numpy(), want) <= 1e-12
    dos, *_ = sweep_solve(T.IntegralProblem(tobs.dos_integrand(ht, 0.2), bzt), T.PTR(npt=npt, device="cpu"),
                          T.MixedParameters(oms))
    assert rel_err(torch.diagonal(u, dim1=1, dim2=2).sum(-1).real.numpy(), dos.numpy()) <= 1e-12
    one = T.solve(T.IntegralProblem(fi, bzt, float(oms[1])), T.PTR(npt=npt, device="cpu"))
    assert rel_err(one.u.numpy(), want[1]) <= 1e-12 and one.numevals == ne[1]


@pytest.mark.parametrize("batched", [False, True], ids=["vmap", "batched"])
@pytest.mark.parametrize("model", ["integer", "flagship"])
def test_spectral_function_under_iai_matches_reference(model, batched):
    """Under IAI the nest evaluates the integrand under vmap (on CPU tensors
    the plain arithmetic; on the card this form raises) or, batched, once a
    leaf trip (K27's pointwise entry, here its plain version): the
    reference's value, count and retcode either way."""
    import autobzcore_torch as T
    import autobzcore_tpu as J
    from autobzcore_torch.models.tight_binding import tb_integer
    from autobzcore_tpu.models.tight_binding import tb_integer as jtb_integer

    if model == "integer":
        hj, ht, d, tol, eta = jtb_integer(2), tb_integer(2, device="cpu"), 2, 1e-4, 0.3
        jalg, talg = J.IAI(), T.IAI(device="cpu")
    else:
        hj, ht = _flagship_pair()
        d, tol, eta = 3, 5e-2, 1.0
        jalg = J.IAI(J.AuxQuadGKJL(cap=64, nbisect=2), inner_cap=32)
        talg = T.IAI(T.AuxQuadGKJL(cap=64, nbisect=2), inner_cap=32, device="cpu")
    bzj, bzt = _bzs("FBZ", d)
    got = T.solve(T.IntegralProblem(T.FourierIntegrand(tobs.spectral_function, ht, eta=eta, batched=batched), bzt,
                                    0.4), talg, abstol=tol)
    want = J.solve(J.IntegralProblem(J.FourierIntegrand(jobs.spectral_function, hj, eta=eta), bzj, 0.4), jalg,
                   abstol=tol)
    assert rel_err(got.u.numpy(), np.asarray(want.u)) <= 1e-12
    assert got.numevals == want.numevals and bool(got.retcode) == bool(want.retcode)


def test_transport_integrand_is_batched_and_matches_pointwise():
    """The batched integrand at a batch of points (eigh, then K31's plain
    version) against transport_distribution at each point, with one
    frequency and one per point."""
    from autobzcore_torch.fourier import JacobianSeries
    from autobzcore_torch.models.tight_binding import flagship_series

    fi = tobs.transport_integrand(flagship_series(device="cpu"), eta=0.1)
    assert fi.batched
    X = torch.rand(40, 3, dtype=torch.float64, generator=torch.Generator().manual_seed(1))
    H, V = JacobianSeries(flagship_series(device="cpu")).eval_points(X)
    for om in (0.3, torch.linspace(-1, 1, 40, dtype=torch.float64)):
        got = tobs.transport_distribution_points(TValue(X, (H, V)), om, eta=0.1)
        oms = torch.broadcast_to(torch.as_tensor(om, dtype=torch.float64), (40,))
        want = torch.stack([tobs.transport_distribution(TValue(X[i], (H[i], V[i])), oms[i], eta=0.1)
                            for i in range(40)])
        assert rel_err(got.numpy(), want.numpy()) <= 1e-12


@pytest.mark.parametrize("kind", ["FBZ", "InversionSymIBZ"])
@pytest.mark.parametrize("alg", ["PTR", "IAI", "TAI"])
def test_transport_integrand_matches_reference(kind, alg):
    """The batched transport integrand under PTR (the velocity pack and K19,
    their plain versions), IAI (K31 at each leaf trip) and TAI (K31 at each
    trip) against the reference's per-point integrand: 1e-12, identical
    counts and retcodes."""
    import autobzcore_torch as T
    import autobzcore_tpu as J
    from autobzcore_torch.models.tight_binding import tb_graphene, tb_integer
    from autobzcore_tpu.models.tight_binding import tb_graphene as jtb_graphene
    from autobzcore_tpu.models.tight_binding import tb_integer as jtb_integer

    bzj, bzt = _bzs(kind, 2)
    if alg == "PTR":
        hj, ht, talg, jalg, kw = jtb_graphene(), tb_graphene(device="cpu"), T.PTR(npt=20, device="cpu"), \
            J.PTR(npt=20), {}
    else:
        hj, ht = jtb_integer(2), tb_integer(2, device="cpu")
        talg, jalg = (T.IAI(device="cpu"), J.IAI()) if alg == "IAI" else (T.TAI(device="cpu"), J.TAI())
        kw = dict(abstol=1e-4)
    got = T.solve(T.IntegralProblem(tobs.transport_integrand(ht, eta=0.5), bzt, T.MixedParameters(0.4)), talg, **kw)
    want = J.solve(J.IntegralProblem(jobs.transport_integrand(hj, eta=0.5), bzj, J.MixedParameters(0.4)), jalg,
                   **kw)
    assert got.u.shape == (2, 2)
    assert rel_err(got.u.numpy(), np.asarray(want.u)) <= 1e-12
    assert got.numevals == want.numevals and bool(got.retcode) == bool(want.retcode)


def test_transport_ptr_sweep_equals_transport_solver():
    """A PTR sweep of the transport integrand (one K19 launch over the lane
    vector on the card) equals TransportSolver on the same grid."""
    import autobzcore_torch as T
    from autobzcore_torch.models.tight_binding import tb_haldane
    from autobzcore_torch.parallel.sweep import SweepSolver, sweep_solve

    h = tb_haldane(t2=0.1, M=0.3, device="cpu")
    _, bzt = _bzs("FBZ", 2)
    oms = np.linspace(-2.0, 2.0, 9)
    u, _, conv, ne = sweep_solve(T.IntegralProblem(tobs.transport_integrand(h, eta=0.1), bzt),
                                 T.PTR(npt=24, device="cpu"), T.MixedParameters(oms))
    want = tobs.TransportSolver(h, bzt, 24, 0.1)(oms)
    assert rel_err(u.numpy(), want) <= 1e-12 and conv.all() and (ne == 24**2).all()
    got = SweepSolver(T.IntegralProblem(tobs.transport_integrand(h, eta=0.1), bzt), T.PTR(npt=24, device="cpu"),
                      chunk=4)(oms)
    assert rel_err(got, want) <= 1e-12


# --- K27's matrix mode on the z form (Z = z I) --------------------------------------------------------


def _z_lanes(rng, H, W, eta):
    """W lanes z = om + i eta, half at random om and half on an eigenvalue of
    some H_k (a pole at small eta)."""
    ev = np.linalg.eigvalsh(H[rng.integers(0, H.shape[0], W // 2)])
    om = np.concatenate([rng.uniform(-4.0, 4.0, W - W // 2),
                         ev[np.arange(W // 2), rng.integers(0, H.shape[-1], W // 2)]])
    return om + 1j * eta


@pytest.mark.parametrize("eta", [1e-3, 0.1])
@pytest.mark.parametrize("m", [1, 2, 3])
def test_k27_spectral_z_form_matches_plain(m, eta):
    """K27's matrix mode on the lanes' z (csrc/sigma_trace.cu): det in
    diagonal shifts, c_k = w_k / det, and G = z^2 S0 I + z S1 + S2 from the
    lanes' three sums (Cayley-Hamilton), in numpy, against
    spectral_weighted_sum_plain at Z = z I (relative 1e-12); the z form of
    spectral_weighted_sum equal to its Z-matrix form."""
    from torch_parity import k27_spectral_sum_z

    rng = np.random.default_rng(31 + m)
    K, W, scale = 300, 16, 0.21
    H = random_hermitian(rng, K, m)
    w = rng.random(K) + 0.5
    z = _z_lanes(rng, H, W, eta)
    Zm = torch.as_tensor(z[:, None, None] * np.eye(m))
    Ht, wt, zt = torch.as_tensor(H), torch.as_tensor(w), torch.as_tensor(z)
    want = tobs.spectral_weighted_sum_plain(Ht, wt, Zm, scale).numpy()
    assert rel_err(k27_spectral_sum_z(H, w, z, scale), want) <= 1e-12
    assert np.array_equal(tobs.spectral_weighted_sum(Ht, wt, zt, scale).numpy(), want)
    assert np.array_equal(tobs.spectral_weighted_sum_plain(Ht, wt, zt, scale).numpy(), want)


@pytest.mark.parametrize("m", [1, 2, 3, 4])
@pytest.mark.parametrize("per_point", [False, True], ids=["one_z", "z_per_point"])
def test_spectral_points_z_form(m, per_point):
    """spectral_points on z (() or (N,)) equals it on Z = z I, and (m <= 3)
    the kernel's direct form in numpy: the adjugate of M = z I - (H + H^H) /
    2 and one reciprocal of det (relative 1e-12)."""
    from torch_parity import k27_direct_inverse

    rng = np.random.default_rng(41 + m)
    N = 150
    H = random_hermitian(rng, N, m)
    z = _z_lanes(rng, H, N, 1e-3) if per_point else np.asarray(0.3 + 0.05j)
    zt = torch.as_tensor(z)
    got = tobs.spectral_points(torch.as_tensor(H), zt).numpy()
    Zm = (zt[..., None, None] * torch.eye(m, dtype=torch.complex128)).contiguous()
    assert np.array_equal(got, tobs.spectral_points(torch.as_tensor(H), Zm).numpy())
    if m <= 3:
        G = k27_direct_inverse(H, z)
        assert rel_err(got, (G - np.conj(np.swapaxes(G, -1, -2))) / (-2j * np.pi)) <= 1e-12


@pytest.mark.parametrize("m", [1, 2, 3])
def test_spectral_weighted_sum_z_form_matches_reference(m):
    """The z form of spectral_weighted_sum (the PTR rule's sum of
    spectral_function) against the reference's spectral_function summed by
    its ``tree_weighted_sum`` at each lane's (om, eta)."""
    rng = np.random.default_rng(51 + m)
    K, scale = 200, 0.013
    H = random_hermitian(rng, K, m)
    w = rng.random(K) + 0.5
    etas = np.linspace(0.05, 0.2, len(OMEGAS))
    want = np.stack([scale * np.asarray(tree_weighted_sum(jnp.asarray(w), jax.vmap(
        lambda h: jobs.spectral_function(JValue(None, h), jnp.asarray(om), eta=eta))(jnp.asarray(H)), axis=0))
        for om, eta in zip(OMEGAS, etas)])
    got = tobs.spectral_weighted_sum(torch.as_tensor(H), torch.as_tensor(w), torch.as_tensor(OMEGAS + 1j * etas),
                                     scale).numpy()
    assert rel_err(got, want) <= 1e-12
