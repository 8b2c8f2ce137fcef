"""Parity of the port's omega-block sweeps (``SweepSolver(scan=True,
block=W)``) with the JAX package on the CPU: the reference's
``tests/test_parallel.py:702-810`` through both packages (block against
scalar, cold and warm; exact ``block_certificates`` with pad blocks; the
ValueErrors; the non-broadcasting integrand), the fixed rule under blocks,
the generic leaf (m > 3) under blocks, and the plain fused leaf over a block
against the JAX leaf rule.

Values agree within 1e-10 (far inside abstol), ``numevals``, retcodes and
``block_certificates`` are identical. The frequencies stay off the
integer lattice's symmetry points (ROADMAP C3)."""
import os
import subprocess
import sys
from pathlib import Path

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import autobzcore_torch as T
import autobzcore_tpu as J
from autobzcore_torch.models import observables as tobs
from autobzcore_torch.models import tight_binding as ttb
from autobzcore_torch.ops import adaptive as tad
from autobzcore_torch.parallel.sweep import SweepSolver
from autobzcore_tpu.models import tight_binding as jtb
from autobzcore_tpu.models.observables import dos_eig as jdos_eig
from autobzcore_tpu.models.observables import dos_trace as jdos
from autobzcore_tpu.ops import adaptive as jad
from autobzcore_tpu.ops import quad_rules as jqr
from autobzcore_tpu.parallel.sweep import SweepSolver as JSweepSolver

torch.set_num_threads(2)

REPO = Path(__file__).resolve().parents[1]
OMS = np.linspace(0.4, 0.7, 8)


def _probs(f=(jdos, tobs.dos_trace), model=None):
    jm, tm = model or (jtb.tb_integer(2), ttb.tb_integer(2, device="cpu"))
    B = 2 * np.pi * np.eye(2)
    return (J.IntegralProblem(J.FourierIntegrand(f[0], jm, eta=0.1), J.load_bz(J.FBZ(), B)),
            T.IntegralProblem(T.FourierIntegrand(f[1], tm, eta=0.1), T.load_bz(T.FBZ(), B)))


def _both(kw, oms=OMS, probs=None, jalg=None, talg=None, **skw):
    jprob, tprob = probs or _probs()
    js = JSweepSolver(jprob, jalg or J.IAI(**kw), chunk=8, scan=True, **skw)
    ts = SweepSolver(tprob, talg or T.IAI(device="cpu", **kw), chunk=8, scan=True, **skw)
    return js, np.asarray(js(oms)), ts, ts(oms)


def _same(js, uj, ts, ut):
    assert ut.shape == uj.shape and np.max(np.abs(ut - uj)) <= 1e-10
    assert ts.numevals == js.numevals and ts.retcode == js.retcode is True
    if js.block > 1:
        for g, w in zip(ts.block_certificates, js.block_certificates):
            np.testing.assert_array_equal(g, np.asarray(w))


@pytest.mark.parametrize("precision,warm", [("complex", False), ("complex", True), ("split", False)],
                         ids=["cold", "warm", "split"])
def test_block_sweep_matches_scalar_and_reference(precision, warm):
    """block=4 against the reference's block sweep (values, numevals,
    retcodes, certificates) and against the port's scalar sweep within the
    certificate (the block's error is the 2-norm over its channels); the
    reference's split tier runs as the complex128 tier here."""
    kw = dict(precision=precision)
    js, uj, ts, ut = _both(kw, abstol=1e-4, block=4, warm=warm)
    _same(js, uj, ts, ut)
    ref = SweepSolver(_probs()[1], T.IAI(device="cpu"), abstol=1e-4, chunk=8, scan=True)
    assert np.max(np.abs(ut - ref(OMS))) < 2e-4
    if warm:
        assert ts.chunk_evals == js.chunk_evals and len(ts._pool) == 5


def test_block_sweep_refuses_what_the_reference_refuses():
    jprob, tprob = _probs()
    for kw in (dict(chunk=8, block=4), dict(chunk=9, scan=True, block=4),
               dict(chunk=8, scan=True, group=2, block=4)):
        with pytest.raises(ValueError):
            JSweepSolver(jprob, J.IAI(), **kw)
        with pytest.raises(ValueError):
            SweepSolver(tprob, T.IAI(device="cpu"), **kw)


@pytest.mark.parametrize("warm", [False, True], ids=["cold", "warm"])
def test_block_certificates_exact_counts(warm):
    """n = 6 with block = 4: the final block holds two real lanes and two
    pads, the chunk's second half is a pure-pad block; per-block counts sum
    to numevals (warm: plus the harvests)."""
    oms = np.linspace(0.4, 0.7, 6)
    js, uj, ts, ut = _both({}, oms=oms, abstol=1e-4, block=4, warm=warm)
    _same(js, uj, ts, ut)
    convs, nes = ts.block_certificates
    assert ut.shape == (6,) and convs.shape == nes.shape == (2,) and np.all(nes > 0)
    if warm:
        assert ts.numevals >= int(np.sum(nes)) and ts.chunk_evals == js.chunk_evals
    else:
        assert ts.numevals == int(np.sum(nes))
    assert ts.lane_numevals.shape == (6,) and ts.lane_numevals[0] == nes[0] / 4


def test_block_requires_broadcasting_integrand():
    """A reducing integrand (dos_eig sums over the omega block too) cannot
    run blocked: both packages raise the actionable ValueError."""
    jprob, tprob = _probs(f=(jdos_eig, tobs.dos_eig))
    for sw in (JSweepSolver(jprob, J.IAI(), abstol=1e-3, chunk=8, scan=True, block=4),
               SweepSolver(tprob, T.IAI(device="cpu"), abstol=1e-3, chunk=8, scan=True, block=4)):
        with pytest.raises(ValueError, match="broadcast"):
            sw(OMS)


def test_fixed_rule_under_blocks():
    """PTR under block=4: the chunk's values, one rule count per real block."""
    jprob, tprob = _probs()
    js, uj, ts, ut = _both({}, oms=np.linspace(0.4, 0.7, 6), jalg=J.PTR(npt=20),
                           talg=T.PTR(npt=20, device="cpu"), block=4)
    _same(js, uj, ts, ut)
    assert ts.numevals == 2 * 400


def test_generic_leaf_under_blocks():
    """m = 4 bands: the nest's generic leaf (the series at the nodes, then
    dos_trace broadcast over the block) under block=2."""
    model = (jtb.synthetic_wannier(4, nr=3, ndim=2), ttb.synthetic_wannier(4, nr=3, ndim=2, device="cpu"))
    probs = _probs(model=model)
    js, uj, ts, ut = _both(dict(inner_cap=32, inner_nbisect=2), oms=np.array([-0.7, -0.45, 0.3, 0.8]),
                           probs=probs, abstol=1e-2, block=2)
    _same(js, uj, ts, ut)


def test_wide_block_takes_the_fused_leaf():
    """A block wider than one of K4's channel groups (8) still runs the fused
    leaf, with the reference's results."""
    oms = np.linspace(0.4, 0.7, 10)
    jprob, tprob = _probs()
    js = JSweepSolver(jprob, J.IAI(), abstol=1e-4, chunk=10, scan=True, block=10)
    ts = SweepSolver(tprob, T.IAI(device="cpu"), abstol=1e-4, chunk=10, scan=True, block=10)
    _same(js, np.asarray(js(oms)), ts, ts(oms))
    om, eta = tobs.dos_lanes(T.parameters.LaneParams(tprob.f.p, torch.zeros(3, 10)), 3, "cpu")
    assert om.shape == eta.shape == (3, 10)


@pytest.mark.parametrize("W", [2, 5, 11])
def test_leaf_rule_over_a_block_matches_reference(W):
    """The plain fused leaf (K4's plain version) over an omega
    block against JAX's gk_rule_eval of dos_trace with a (W,) frequency
    vector: val (I, W), err and l1 the 2-norms over the channels."""
    import __graft_entry__

    rng = np.random.default_rng(W)
    x3, x2 = rng.random(2)
    js1 = __graft_entry__._flagship_series(jnp.complex128).contract(x3).contract(x2)
    ts1 = ttb.flagship_series(device="cpu").contract(x3).contract(x2)
    om = 0.7 + rng.uniform(-0.5, 0.5, W)
    a = np.sort(rng.random(6))
    aa, bb = a[:3], a[3:]
    bb[1] = aa[1]  # a dead (zero-width) interval
    xk, wk, wg = (jnp.asarray(t) for t in jqr.kronrod(7))
    jfi, jp = J.FourierIntegrand(jdos, js1, eta=0.05).with_parameters(jnp.asarray(om))
    jcar = jfi.nest_carrier()
    want = jad.gk_rule_eval(lambda xs, p: jcar.eval_batch(xs, (), p), jp,
                            jnp.asarray(aa), jnp.asarray(bb), xk, wk, wg, lambda x: x)
    want = [np.asarray(w) for w in want]
    txk, twk, twg = tad.gk_rule(7, "cpu")
    c1 = ts1.c.reshape(1, ts1.c.shape[0], 9).contiguous()
    omt = torch.as_tensor(om)[None].contiguous()
    got = tobs.gk_leaf_dos(c1, torch.zeros(1, dtype=torch.int64), ts1.offset[0], ts1.period[0],
                           torch.as_tensor(aa)[None], torch.as_tensor(bb)[None], omt,
                           torch.full_like(omt, 0.05), torch.ones(1, dtype=torch.bool), txk, twk, twg)
    assert got[0].shape == (1, 3, W) and want[0].shape == (3, W)
    scale = np.max(want[2])
    for g, w in zip(got[:3], want[:3]):
        assert np.max(np.abs(g[0].numpy() - w)) <= 1e-12 * scale
    assert float(got[3][0]) == 3 * 15 and np.all(got[0][0, 1].numpy() == 0.0)


def test_example_runs_blocked_iai_leg_on_cpu(tmp_path):
    env = dict(os.environ, JAX_PLATFORMS="cpu", OMP_NUM_THREADS="2")
    args = [sys.executable, str(REPO / "examples" / "aps_example_torch.py"), "--flagship", "--device", "cpu",
            "--skip-ptr", "--with-iai", "--iai-block", "2", "--iai-chunk", "34", "--eta", "0.5",
            "--abstol", "1.0", "--iai-inner-cap", "16", "--atol-interp", "5"]
    for extra, tier in (([], "warm, block 2"), (["--cold-iai"], "cold, block 2")):
        out = subprocess.run(args + extra, capture_output=True, text=True, timeout=300, env=env, cwd=tmp_path)
        assert out.returncode == 0, out.stderr[-2000:]
        assert f"IAI interpolant ({tier}, complex128)" in out.stderr and "retcode True" in out.stderr
        assert out.stdout.startswith("IAI DOS(0.5 eV) = ")
