"""Parity of the port's Fourier layer (kernel K1 and its plain version)
with the JAX package, on the same coefficients and points."""
import numpy as np
import pytest
import torch

import jax.numpy as jnp

import __graft_entry__
from autobzcore_tpu.models import tight_binding as jtb
from autobzcore_tpu.ops.fourier_eval import evaluate_grid, evaluate_points

from autobzcore_torch.interop import series_from_arrays
from autobzcore_torch.models import tight_binding as ttb
from autobzcore_torch.ops.fourier_eval import fourier_points_plain
from torch_parity import rel_err

torch.set_num_threads(2)

# (JAX builder, port builder) pairs of every in-repo model
MODELS = {
    "tb_integer1": (lambda: jtb.tb_integer(1), lambda: ttb.tb_integer(1, device="cpu")),
    "tb_integer2": (lambda: jtb.tb_integer(2), lambda: ttb.tb_integer(2, device="cpu")),
    "tb_integer3": (lambda: jtb.tb_integer(3), lambda: ttb.tb_integer(3, device="cpu")),
    "tb_graphene": (lambda: jtb.tb_graphene(), lambda: ttb.tb_graphene(device="cpu")),
    "synthetic_wannier3": (lambda: jtb.synthetic_wannier(3), lambda: ttb.synthetic_wannier(3, device="cpu")),
    "flagship": (lambda: __graft_entry__._flagship_series(jnp.complex128), lambda: ttb.flagship_series(device="cpu")),
}


@pytest.mark.parametrize("name", sorted(MODELS))
def test_builders_match_reference_coefficients(name):
    js, ts = MODELS[name][0](), MODELS[name][1]()
    np.testing.assert_array_equal(ts.c.numpy(), np.asarray(js.c))
    assert (ts.sndim, ts.offset, ts.period) == (js.sndim, js.offset, js.period)


@pytest.mark.parametrize("name", sorted(MODELS))
def test_points_match_evaluate_points(name):
    js = MODELS[name][0]()
    ts = series_from_arrays(np.asarray(js.c), js.offset, js.period, js.sndim, device="cpu")
    X = np.random.default_rng(7).uniform(-1.0, 2.0, size=(300, js.sndim))
    want = np.asarray(evaluate_points(js.c, js.sndim, jnp.asarray(X), js.offset, js.period))
    got = ts.eval_points(torch.as_tensor(X)).numpy()
    assert got.shape == want.shape
    assert rel_err(got, want) <= 1e-12


@pytest.mark.parametrize("name", sorted(MODELS))
def test_points_match_evaluate_grid(name):
    js = MODELS[name][0]()
    d = js.sndim
    npt = 6
    nodes = [np.arange(npt) / npt * js.period[j] for j in range(d)]
    want = np.asarray(evaluate_grid(js.c, d, nodes, js.offset, js.period))
    want = want.reshape((-1,) + want.shape[d:])
    X = np.stack(np.meshgrid(*nodes, indexing="ij"), axis=-1).reshape(-1, d)
    c = torch.as_tensor(np.asarray(js.c))
    got = fourier_points_plain(c, torch.as_tensor(X), js.offset, js.period).numpy()
    assert rel_err(got, want) <= 1e-12


def test_chunked_plain_version_matches_one_chunk(monkeypatch):
    from autobzcore_torch.ops import fourier_eval

    s = ttb.synthetic_wannier(2, nr=4, device="cpu")
    X = torch.rand(50, 3, dtype=torch.float64)
    whole = fourier_points_plain(s.c, X, s.offset, s.period)
    monkeypatch.setattr(fourier_eval, "_PLAIN_CHUNK", 7)
    assert torch.allclose(fourier_points_plain(s.c, X, s.offset, s.period), whole,
                          rtol=0, atol=1e-14)
