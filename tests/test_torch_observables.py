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

    fi = tobs.dos_integrand(tb_integer(2), 0.1)
    assert isinstance(fi.rep, TrivialRep)
    assert fi.pf.f is tobs.dos_trace and fi.p.eta == 0.1
    # one k-point through the pointwise fallback equals the closed form
    x = torch.tensor([0.1, 0.3], dtype=torch.float64)
    e = 2 * (math.cos(2 * math.pi * 0.1) + math.cos(2 * math.pi * 0.3))
    assert abs(float(fi(x, 0.2)) - 0.1 / ((0.2 - e) ** 2 + 0.01) / math.pi) <= 1e-12
