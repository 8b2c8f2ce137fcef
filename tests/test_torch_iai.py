"""Parity of the port's cold IAI (``brillouin.IAI`` over
``algorithms/nested.NestedQuad``) with the JAX package on the CPU: the same
values, ``numevals`` and retcodes on the documentation anchors, the
``nest_presplit`` case and 3-D densities of states on the full zone and on
the cubic irreducible wedge (per-lane segments and tolerances)."""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import autobzcore_torch as T
import autobzcore_tpu as J
from autobzcore_torch.models import observables as tobs
from autobzcore_torch.models import tight_binding as ttb
from autobzcore_tpu.models import tight_binding as jtb
from autobzcore_tpu.models.observables import dos_trace as jdos

torch.set_num_threads(2)

C2 = np.array([[0.0, 0.5, 0.0], [0.5, 0.0, 0.5], [0.0, 0.5, 0.0]])


def _gloc(P, xp, **alg):
    """The 2-D integer-lattice Green's function at om = 0 through IAI (the
    reference documentation's anchor)."""
    def gl(hk, eta=None, om=None):
        return 1.0 / ((om + 1j * eta) - hk.s)

    kw = {"device": "cpu"} if P is T else {}
    h = P.FourierSeries(C2, period=1.0, offset=(-1, -1), **kw)
    bz = P.load_bz(P.FBZ(), 2 * np.pi * np.eye(2))
    prob = P.IntegralProblem(P.FourierIntegrand(gl, h, eta=0.1), bz, P.MixedParameters(om=0.0))
    return P.solve(prob, P.IAI(**alg, **kw), abstol=1e-3)


@pytest.fixture(scope="module")
def gloc_ref():
    return _gloc(J, jnp)


def test_gloc_2d_anchor_matches_reference(gloc_ref):
    got = _gloc(T, torch)
    val = complex(got.u)
    assert abs(val.imag + 1.3941704019631334) <= 1e-3 and abs(val.real) < 1e-8
    assert abs(val - complex(np.asarray(gloc_ref.u))) <= 1e-10 * abs(val)
    assert got.numevals == gloc_ref.numevals and got.retcode is gloc_ref.retcode is True


@pytest.mark.parametrize("alg", [dict(precision="split"), dict(precision="guided"),
                                 dict(host_outer=True), dict(plain_kernels=True)],
                         ids=["split", "guided", "host_outer", "plain_kernels"])
def test_knobs_that_map_onto_the_complex128_tier(gloc_ref, alg):
    """``split``/``guided`` were the reference's emulated-f64 tiers and
    ``host_outer`` its host-side outer loop: here all run the complex128
    nest on the device and give its result."""
    got = _gloc(T, torch, **alg)
    assert abs(complex(got.u) - complex(np.asarray(gloc_ref.u))) <= 1e-10 * abs(complex(got.u))
    assert got.numevals == gloc_ref.numevals


def test_nest_presplit_matches_reference():
    """The 2-D DOS case of the reference's nest_presplit test: plain IAI is
    deceived by aliasing, nest_presplit=3 lands within the certificate of
    the dense PTR value, both with the reference's counts."""
    om = 0.9047619047619049
    jfi = J.FourierIntegrand(jdos, jtb.tb_integer(2), eta=0.1)
    tfi = T.FourierIntegrand(tobs.dos_trace, ttb.tb_integer(2, device="cpu"), eta=0.1)
    jbz = J.load_bz(J.FBZ(), 2 * np.pi * np.eye(2))
    tbz = T.load_bz(T.FBZ(), 2 * np.pi * np.eye(2))
    truth = float(T.solve(T.IntegralProblem(tfi, tbz, om), T.PTR(npt=256, device="cpu")).u)
    for kw in (dict(), dict(nest_presplit=3)):
        want = J.solve(J.IntegralProblem(jfi, jbz, om), J.IAI(inner_cap=64, inner_nbisect=2, **kw),
                       abstol=1e-4)
        got = T.solve(T.IntegralProblem(tfi, tbz, om),
                      T.IAI(inner_cap=64, inner_nbisect=2, device="cpu", **kw), abstol=1e-4)
        w = float(np.asarray(want.u))
        assert abs(float(got.u) - w) <= 1e-10 * abs(w)
        assert got.numevals == want.numevals and got.retcode == want.retcode
        if kw:
            assert got.retcode and abs(float(got.u) - truth) < 2e-4
        else:
            assert abs(float(got.u) - truth) > 1e-3


@pytest.mark.parametrize("kind", ["FBZ", "CubicSymIBZ", "InversionSymIBZ"])
def test_dos_3d_matches_reference(kind):
    """tb_integer(3) at eta = 0.3 with small inner pools: the fused leaf
    (K4's plain version) under two contracted levels (K3's), on the full
    zone, the wedge (per-lane segments [0, x]) and the half cube."""
    jfi = J.FourierIntegrand(jdos, jtb.tb_integer(3), eta=0.3)
    tfi = T.FourierIntegrand(tobs.dos_trace, ttb.tb_integer(3, device="cpu"), eta=0.3)
    jbz, tbz = J.load_bz(getattr(J, kind)(), np.eye(3)), T.load_bz(getattr(T, kind)(), np.eye(3))
    want = J.solve(J.IntegralProblem(jfi, jbz, 0.4), J.IAI(inner_cap=32, inner_nbisect=2), abstol=1e-3)
    got = T.solve(T.IntegralProblem(tfi, tbz, 0.4),
                  T.IAI(inner_cap=32, inner_nbisect=2, device="cpu"), abstol=1e-3)
    w = float(np.asarray(want.u))
    assert abs(float(got.u) - w) <= 1e-10 * abs(w)
    assert got.numevals == want.numevals and got.retcode == want.retcode is True


def test_flagship_dos_matches_reference():
    """The flagship's 3-band series on the full zone, the main path's model
    and knobs (inner_cap, inner_nbisect=4) at a loose tolerance: the fused
    leaf at m = 3."""
    import __graft_entry__
    from autobzcore_torch.interop import series_from_arrays

    js = __graft_entry__._flagship_series(jnp.complex128)
    ts = series_from_arrays(np.asarray(js.c), js.offset, js.period, js.sndim, device="cpu")
    want = J.solve(J.IntegralProblem(J.FourierIntegrand(jdos, js, eta=0.2), J.load_bz(J.FBZ(), np.eye(3)),
                                     0.5), J.IAI(inner_cap=32, inner_nbisect=4), abstol=0.1)
    got = T.solve(T.IntegralProblem(T.FourierIntegrand(tobs.dos_trace, ts, eta=0.2),
                                    T.load_bz(T.FBZ(), np.eye(3)), 0.5),
                  T.IAI(inner_cap=32, inner_nbisect=4, device="cpu"), abstol=0.1)
    w = float(np.asarray(want.u))
    assert abs(float(got.u) - w) <= 1e-10 * abs(w)
    assert got.numevals == want.numevals and got.retcode == want.retcode is True


def test_generic_integrands_match_reference():
    """A user FourierIntegrand (K3 at the leaf nodes, the user function, K5's
    reduction) and a plain function of the point over a 2-D zone."""
    def kern_j(hv, om):
        return jnp.real(hv.s[0, 0]) ** 2 * om + jnp.cos(hv.x[0])

    def kern_t(hv, om):
        return hv.s[0, 0].real ** 2 * om + torch.cos(hv.x[0])

    js, ts = jtb.tb_graphene(), ttb.tb_graphene(device="cpu")
    jbz, tbz = J.load_bz(J.FBZ(), np.eye(2)), T.load_bz(T.FBZ(), np.eye(2))
    cases = [
        (J.FourierIntegrand(kern_j, js, rep=J.TrivialRep()), T.FourierIntegrand(kern_t, ts, rep=T.TrivialRep())),
        (lambda x, p: jnp.exp(jnp.sin(x[0]) * jnp.cos(x[1])) * p,
         lambda x, p: torch.exp(torch.sin(x[0]) * torch.cos(x[1])) * p),
    ]
    for jf, tf in cases:
        want = J.solve(J.IntegralProblem(jf, jbz, 1.3), J.IAI(inner_cap=64), abstol=1e-6)
        got = T.solve(T.IntegralProblem(tf, tbz, 1.3), T.IAI(inner_cap=64, device="cpu"), abstol=1e-6)
        w = float(np.asarray(want.u))
        assert abs(float(got.u) - w) <= 1e-10 * abs(w)
        assert got.numevals == want.numevals and got.retcode == want.retcode is True


def test_quadgk_levels_take_their_own_knobs():
    """A tuple of per-level rules (innermost first): order and caps per level,
    as the reference's NestedQuad reads them."""
    algs_j = (J.QuadGKJL(order=9), J.AuxQuadGKJL(nbisect=2), J.QuadGKJL(order=5, nbisect=1))
    algs_t = (T.QuadGKJL(order=9), T.AuxQuadGKJL(nbisect=2), T.QuadGKJL(order=5, nbisect=1))
    jfi = J.FourierIntegrand(jdos, jtb.tb_integer(3), eta=0.4)
    tfi = T.FourierIntegrand(tobs.dos_trace, ttb.tb_integer(3, device="cpu"), eta=0.4)
    want = J.solve(J.IntegralProblem(jfi, J.load_bz(J.CubicSymIBZ(), np.eye(3)), -1.1),
                   J.IAI(algs_j, inner_cap=16, inner_nbisect=2), abstol=1e-3)
    got = T.solve(T.IntegralProblem(tfi, T.load_bz(T.CubicSymIBZ(), np.eye(3)), -1.1),
                  T.IAI(algs_t, inner_cap=16, inner_nbisect=2, device="cpu"), abstol=1e-3)
    assert abs(float(got.u) - float(np.asarray(want.u))) <= 1e-10 * abs(float(got.u))
    assert got.numevals == want.numevals and got.retcode == want.retcode


def test_unported_knobs_raise():
    with pytest.raises(NotImplementedError, match="warm slice"):
        T.IAI(warm_start=True, device="cpu")
    with pytest.raises(NotImplementedError, match="A5"):
        T.IAI(checkpoint="heap.npz", device="cpu")
    with pytest.raises(ValueError):
        T.IAI(precision="half", device="cpu")
    with pytest.raises(NotImplementedError, match="complex64"):
        T.FourierIntegrand(tobs.dos_trace, ttb.tb_integer(2, device="cpu")).nest_carrier(downcast=True)


def test_entry_points_default_to_the_card():
    """Without device= every entry point places its data on the CUDA card;
    where there is none it raises and does not fall back to the CPU."""
    if torch.cuda.is_available():
        assert T.FourierSeries(C2, offset=(-1, -1)).c.device.type == "cuda"
        assert T.PTR().device.type == "cuda" and T.IAI().device.type == "cuda"
        return
    for make in (lambda: T.FourierSeries(C2, offset=(-1, -1)), lambda: T.PTR(), lambda: T.IAI(),
                 lambda: ttb.tb_integer(2), lambda: T.MonkhorstPack(npt=4)):
        with pytest.raises(RuntimeError, match="CUDA"):
            make()
