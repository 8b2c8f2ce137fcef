"""Parity of the port's series derivatives (kernel K11's plain version
``fourier_points_derivs_plain``, the derivative forms of ``evaluate_grid``
and ``contract``, ``evaluate_points_jacobian`` and ``JacobianSeries``) with
the JAX package's ``ops/fourier_eval.py`` and ``fourier.py`` on the CPU.

Values agree within 1e-12 of max|value|: the two packages sum the same
products in another order. PTR and IAI over a JacobianSeries integrand give
the reference's values within 1e-10 and its ``numevals`` (and, for IAI, its
error estimate and retcode)."""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import autobzcore_torch as T
import autobzcore_tpu as J
from autobzcore_torch.models import tight_binding as ttb
from autobzcore_torch.ops import fourier_eval as tfe
from autobzcore_tpu.models import tight_binding as jtb
from autobzcore_tpu.ops import fourier_eval as jfe

torch.set_num_threads(2)

# (d, value shape, offsets, periods): 1-, 2- and 3-D, scalar and matrix
# values, offsets other than centred and periods other than 1
CASES = [
    (1, (), (-2,), (1.0,)),
    (1, (2, 2), (1,), (2.5,)),
    (2, (), (-1, 0), (1.0, 0.5)),
    (2, (2, 2), (-2, -1), (2.0, 1.0)),
    (3, (), (-1, -1, -1), (1.0, 1.0, 1.0)),
    (3, (3, 3), (0, -2, 1), (1.7, 1.0, 0.6)),
]
IDS = [f"d{c[0]}-{'x'.join(map(str, c[1])) or 'scalar'}" for c in CASES]


def _series(d, vshape, seed=0):
    rng = np.random.default_rng(seed)
    shape = tuple(rng.integers(3, 6, size=d)) + vshape
    return rng.normal(size=shape) + 1j * rng.normal(size=shape)


def _points(d, periods, K=37, seed=1):
    return np.random.default_rng(seed).random((K, d)) * np.asarray(periods) * 1.3 - 0.2


def _derivs(d):
    """One-hot orders along each dimension, a second order and a mixed one."""
    out = [tuple(int(i == j) for i in range(d)) for j in range(d)]
    out.append((2,) + (0,) * (d - 1))
    if d > 1:
        out.append((1,) * (d - 1) + (2,))
    return out


def _close(got, want):
    got, want = np.asarray(got), np.asarray(want)
    assert got.shape == want.shape
    assert np.max(np.abs(got - want)) <= 1e-12 * np.max(np.abs(want))


@pytest.mark.parametrize("d,vshape,off,per", CASES, ids=IDS)
def test_evaluate_points_derivs_matches_reference(d, vshape, off, per):
    c = _series(d, vshape)
    X = _points(d, per)
    for derivs in _derivs(d):
        got = tfe.evaluate_points(torch.as_tensor(c), d, torch.as_tensor(X), off, per, derivs)
        want = jfe.evaluate_points(jnp.asarray(c), d, jnp.asarray(X), off, per, derivs)
        _close(got.numpy(), want)


@pytest.mark.parametrize("d,vshape,off,per", CASES, ids=IDS)
def test_evaluate_grid_derivs_matches_reference(d, vshape, off, per):
    c = _series(d, vshape, seed=2)
    rng = np.random.default_rng(3)
    nodes = [rng.random(4 + j) * per[j] for j in range(d)]
    for derivs in _derivs(d):
        got = tfe.evaluate_grid(torch.as_tensor(c), d, nodes, off, per, derivs)
        want = jfe.evaluate_grid(jnp.asarray(c), d, [jnp.asarray(x) for x in nodes], off, per, derivs)
        _close(got.numpy(), want)


@pytest.mark.parametrize("d,vshape,off,per", CASES, ids=IDS)
def test_contract_derivs_matches_reference(d, vshape, off, per):
    """The reference reads only the last entry of ``derivs``: it scales the
    contracted axis."""
    c = _series(d, vshape, seed=4)
    for derivs in _derivs(d) + [(0,) * d]:
        got = tfe.contract(torch.as_tensor(c), d, 0.37 * per[-1], off, per, derivs)
        want = jfe.contract(jnp.asarray(c), d, jnp.asarray(0.37 * per[-1]), off, per, derivs)
        _close(got.numpy(), want)


@pytest.mark.parametrize("d,vshape,off,per", CASES, ids=IDS)
def test_jacobian_matches_reference(d, vshape, off, per):
    c = _series(d, vshape, seed=5)
    X = _points(d, per, K=53)
    h, v = tfe.evaluate_points_jacobian(torch.as_tensor(c), d, torch.as_tensor(X), off, per)
    jh, jv = jfe.evaluate_points_jacobian(jnp.asarray(c), d, jnp.asarray(X), off, per)
    assert v.shape == (53, d) + vshape
    _close(h.numpy(), jh)
    _close(v.numpy(), jv)


@pytest.mark.parametrize("d,vshape,off,per", CASES, ids=IDS)
def test_jacobian_series_matches_reference(d, vshape, off, per):
    """``JacobianSeries.eval_points`` and ``__call__`` give the reference's
    (H, V), with V the gradient with respect to z = x/period."""
    c = _series(d, vshape, seed=6)
    ts = T.JacobianSeries(T.FourierSeries(c, period=per, offset=off, ndim=d, device="cpu"))
    js = J.JacobianSeries(J.FourierSeries(c, period=per, offset=off, ndim=d))
    assert ts.ndim == ts.sndim == d and ts.period == per
    X = _points(d, per, K=11)
    h, v = ts.eval_points(torch.as_tensor(X))
    jh, jv = js.eval_points(jnp.asarray(X))
    _close(h.numpy(), jh)
    _close(v.numpy(), jv)
    h1, v1 = ts(X[3])
    jh1, jv1 = js(jnp.asarray(X[3]))
    _close(h1.numpy(), jh1)
    _close(v1.numpy(), jv1)


def test_stored_series_values_join_like_reference():
    """``StoredSeriesValues`` (kept for API parity) joins its (re, im) pairs
    into the complex values, the (H, V) pair for a Jacobian."""
    rng = np.random.default_rng(8)
    h, v = rng.normal(size=(2, 5, 2, 2)), rng.normal(size=(2, 5, 3, 2, 2))
    got = T.fourier.StoredSeriesValues(((torch.as_tensor(h[0]), torch.as_tensor(h[1])),
                                        (torch.as_tensor(v[0]), torch.as_tensor(v[1]))), True).join()
    want = J.fourier.StoredSeriesValues(((h[0], h[1]), (v[0], v[1])), True).join()
    assert all(np.array_equal(g.numpy(), np.asarray(w)) for g, w in zip(got, want))
    single = T.fourier.StoredSeriesValues((torch.as_tensor(h[0]), torch.as_tensor(h[1])), False).join()
    assert np.array_equal(single.numpy(), h[0] + 1j * h[1])


def test_k11_plain_at_order_zero_is_k1_plain():
    """R = 1 at order zero through K11's wrapper is K1's result, bit for bit
    (the derivative coefficients at order zero are the coefficients)."""
    s = ttb.flagship_series(device="cpu")
    X = torch.rand(64, 3, dtype=torch.float64)
    before = tfe.fourier_points_derivs.launches
    got = tfe.fourier_points_derivs(s.c, X, s.offset, s.period, ((0, 0, 0),))
    assert got.shape == (64, 1, 3, 3)
    assert torch.equal(got[:, 0], tfe.fourier_points(s.c, X, s.offset, s.period))
    assert tfe.fourier_points_derivs.launches == before  # CPU: the plain version, no launch


def test_k11_wrapper_rejects_what_the_kernel_does_not_take():
    s = ttb.flagship_series(device="cpu")
    X = torch.rand(4, 3, dtype=torch.float64)
    for orders in [(), ((0, 0, 0),) * 5, ((1, 0),), ((0, -1, 0),)]:
        with pytest.raises(ValueError):
            tfe.fourier_points_derivs(s.c, X, s.offset, s.period, orders)
    with pytest.raises(ValueError):
        tfe.fourier_points_derivs(s.c, X.to(torch.float32), s.offset, s.period, ((1, 0, 0),))
    with pytest.raises(ValueError):
        tfe.evaluate_points_jacobian(s.c, 2, X, s.offset, s.period)


def _velocity_square(hv):
    """Tr V_x V_x of the (H, V) pair: real for Hermitian H."""
    h, v = hv.s
    vx = v[0]
    return (vx @ vx).diagonal(dim1=-2, dim2=-1).sum(-1).real if isinstance(vx, torch.Tensor) \
        else jnp.real(jnp.trace(vx @ vx))


@pytest.mark.parametrize("kind,npt", [("FBZ", 24), ("InversionSymIBZ", 30)])
def test_ptr_over_jacobian_integrand_matches_reference(kind, npt):
    """PTR of Tr V_x V_x on tb_graphene: the (H, V) pair at the rule's points
    through K11's plain version, the reference's value and ``numevals``."""
    ts = T.JacobianSeries(ttb.tb_graphene(device="cpu"))
    js = J.JacobianSeries(jtb.tb_graphene())
    tbz = T.load_bz(getattr(T, kind)(), np.eye(2))
    jbz = J.load_bz(getattr(J, kind)(), np.eye(2))
    got = T.solve(T.IntegralProblem(T.FourierIntegrand(_velocity_square, ts), tbz), T.PTR(npt=npt, device="cpu"))
    want = J.solve(J.IntegralProblem(J.FourierIntegrand(_velocity_square, js), jbz), J.PTR(npt=npt))
    w = float(np.asarray(want.u))
    assert abs(float(got.u) - w) <= 1e-10 * abs(w)
    assert got.numevals == want.numevals


def test_iai_over_jacobian_integrand_matches_reference():
    """IAI of a broadened velocity-weighted DOS on the 2-D integer lattice:
    the JacobianSeries rides the nest as d + 1 value channels contracted by
    K3's plain version. Value, error, retcode and ``numevals`` as the
    reference's."""
    def vdos(hv, om=None, eta=None):
        h, v = hv.s
        g = 1.0 / ((om + 1j * eta) - h[..., 0, 0])
        return -(g.imag * (v[0][..., 0, 0].real ** 2 + 1.0)) / np.pi

    ts = T.JacobianSeries(ttb.tb_integer(2, device="cpu"))
    js = J.JacobianSeries(jtb.tb_integer(2))
    tbz = T.load_bz(T.FBZ(), np.eye(2))
    jbz = J.load_bz(J.FBZ(), np.eye(2))
    got = T.solve(T.IntegralProblem(T.FourierIntegrand(vdos, ts, eta=0.3), tbz, T.MixedParameters(om=0.4)),
                  T.IAI(inner_cap=64, device="cpu"), abstol=1e-4)
    want = J.solve(J.IntegralProblem(J.FourierIntegrand(vdos, js, eta=0.3), jbz, J.MixedParameters(om=0.4)),
                   J.IAI(inner_cap=64), abstol=1e-4)
    w = float(np.asarray(want.u))
    assert abs(float(got.u) - w) <= 1e-10 * abs(w)
    assert float(got.resid) == pytest.approx(float(np.asarray(want.resid)), rel=1e-6)
    assert got.retcode == want.retcode and got.numevals == want.numevals
