"""Parity of the port's series contraction (``ops/fourier_eval.contract``,
the lane-batched ``fourier_contract`` of kernel K3 in its plain version, and
``FourierCarrier``) with the JAX package's ``contract`` /
``FourierSeries.contract`` / ``FourierCarrier`` on the CPU."""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import __graft_entry__
import autobzcore_torch as T
import autobzcore_tpu as J
from autobzcore_torch.interop import series_from_arrays
from autobzcore_torch.models import tight_binding as ttb
from autobzcore_torch.ops import fourier_eval as tfe
from autobzcore_tpu.models import tight_binding as jtb
from autobzcore_tpu.ops import fourier_eval as jfe

torch.set_num_threads(2)

MODELS = {
    "tb_integer3": lambda: jtb.tb_integer(3),
    "synthetic_wannier3": lambda: jtb.synthetic_wannier(3),
    "flagship": lambda: __graft_entry__._flagship_series(jnp.complex128),
}


def _pair(name):
    js = MODELS[name]()
    return js, series_from_arrays(np.asarray(js.c), js.offset, js.period, js.sndim, device="cpu")


def _rel(got, want):
    want = np.asarray(want)
    return float(np.max(np.abs(np.asarray(got) - want)) / np.max(np.abs(want)))


def test_phase_matrix_matches_reference():
    x = np.random.default_rng(0).uniform(-1, 2, 17)
    got = tfe.phase_matrix(torch.as_tensor(x), 5, -2, 1.5).numpy()
    want = np.asarray(jfe.phase_matrix(jnp.asarray(x), 5, -2, 1.5))
    assert np.max(np.abs(got - want)) <= 1e-14


@pytest.mark.parametrize("name", sorted(MODELS))
def test_contract_matches_reference(name):
    js, ts = _pair(name)
    for x in np.random.default_rng(1).uniform(-0.5, 1.5, 3):
        want = jfe.contract(js.c, js.sndim, jnp.asarray(x), js.offset, js.period)
        got = tfe.contract(ts.c, ts.sndim, x, ts.offset, ts.period)
        assert got.shape == want.shape
        assert _rel(got.numpy(), want) <= 1e-12
        # the series method, twice: down to the 1-D series of the leaf
        jw, tw = js.contract(x).contract(x / 3), ts.contract(x).contract(x / 3)
        assert (tw.sndim, tw.offset, tw.period) == (jw.sndim, jw.offset, jw.period)
        assert _rel(tw.c.numpy(), jw.c) <= 1e-12


@pytest.mark.parametrize("name", sorted(MODELS))
def test_lane_batched_contract_matches_reference(name):
    """Per-lane tensors, a lane map with repeats, per-lane nodes: every
    (lane, node) output equals the reference's contract of that lane's
    tensor at that node."""
    js, ts = _pair(name)
    rng = np.random.default_rng(2)
    d = js.sndim
    cj = [np.asarray(js.c) * s for s in (1.0, -0.5j)]
    c = torch.stack([torch.as_tensor(v) for v in cj]).reshape((2,) + tuple(js.c.shape[:d]) + (-1,))
    cmap = torch.tensor([1, 0, 1], dtype=torch.int64)
    x = torch.as_tensor(rng.uniform(-1, 2, (3, 4)))
    got = tfe.fourier_contract(c.contiguous(), cmap, x, js.offset[-1], js.period[-1])
    assert got.shape == (3, 4) + tuple(js.c.shape[:d - 1]) + (c.shape[-1],)
    for lane in range(3):
        for j in range(4):
            want = jfe.contract(jnp.asarray(cj[int(cmap[lane])]), d, jnp.asarray(x[lane, j].item()),
                                js.offset, js.period)
            g = got[lane, j].reshape(want.shape).numpy()
            assert _rel(g, want) <= 1e-12


@pytest.mark.parametrize("name", sorted(MODELS))
def test_carrier_fix_and_eval_batch_match_reference(name):
    """The nest's carrier: fix the last variable at per-lane nodes, twice,
    then the user kernel at 1-D points, against the reference's carrier of
    one vmapped lane."""
    js, ts = _pair(name)
    rng = np.random.default_rng(3)

    def kernel_j(hv, om):
        return jnp.trace(hv.s.reshape(hv.s.shape[-2:] if hv.s.ndim > 1 else (1, 1))) * om + hv.x[0]

    def kernel_t(hv, om):
        return torch.trace(hv.s.reshape(hv.s.shape[-2:] if hv.s.ndim > 1 else (1, 1))) * om + hv.x[0]

    jfi, jp = J.FourierIntegrand(kernel_j, js).with_parameters(0.7)
    tfi, tp = T.FourierIntegrand(kernel_t, ts).with_parameters(0.7)
    x3 = torch.as_tensor(rng.random((1, 2)))
    x2 = torch.as_tensor(rng.random((2, 3)))
    x1 = torch.as_tensor(rng.random((6, 5)))
    tcar = tfi.nest_carrier().fix(x3).fix(x2)
    assert tcar.sndim == 1 and tcar.nlanes == 6
    coords = (x3.reshape(-1).repeat_interleave(3), x2.reshape(-1))
    got = tcar.eval_batch(x1, coords, T.parameters.LaneParams(tp)).numpy()
    for lane in range(6):
        a, b = lane // 3, lane % 3
        jcar = jfi.nest_carrier().fix(jnp.asarray(x3[0, a].item())).fix(jnp.asarray(x2[a, b].item()))
        want = jcar.eval_batch(jnp.asarray(x1[lane].numpy()),
                               (jnp.asarray(x3[0, a].item()), jnp.asarray(x2[a, b].item())), jp)
        assert _rel(got[lane], want) <= 1e-12


def test_contract_refuses_unported_forms():
    """Derivative contraction is ported (it scales the contracted axis, as
    the reference); K3's wrapper still refuses a malformed call."""
    s = ttb.tb_integer(2, device="cpu")
    got = tfe.contract(s.c, 2, 0.3, s.offset, s.period, derivs=(0, 1)).numpy()
    want = np.asarray(jfe.contract(jnp.asarray(s.c.numpy()), 2, jnp.asarray(0.3), s.offset, s.period,
                                   derivs=(0, 1)))
    assert np.max(np.abs(got - want)) <= 1e-12 * np.max(np.abs(want))
    with pytest.raises(ValueError):
        tfe.fourier_contract(s.c, torch.zeros(1, dtype=torch.int64), torch.zeros(1, 2), -1, 1.0)
