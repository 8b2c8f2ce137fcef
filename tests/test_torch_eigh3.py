"""Parity of the port's closed-form small Hermitian eigenvalues
(``autobzcore_torch/ops/eigh3.py``, kernel K9's plain version) with the JAX
package's ``ops/eigh3.py``."""
import numpy as np
import pytest
import torch

import jax.numpy as jnp

from autobzcore_tpu.ops import eigh3 as J

from autobzcore_torch.ops import eigh3 as T
from torch_parity import random_hermitian

torch.set_num_threads(2)

TOL = 1e-12  # absolute, on matrices with entries of order 1: rounding only


def _cases(m, seed):
    """Seeded Hermitian batches plus scalar, degenerate and diagonal cases
    (the Gamma-point matrices that trip the degeneracy guard)."""
    H = random_hermitian(np.random.default_rng(seed), 300, m)
    eye = np.eye(m)
    special = [eye * 0.0, eye * 1.7, eye * -3.2 + 1e-14 * random_hermitian(np.random.default_rng(1), 1, m)[0],
               np.diag(np.arange(m, dtype=float))[::-1, ::-1].copy()]
    if m >= 2:
        d = np.ones(m)
        d[-1] = 2.0
        special.append(np.diag(d))  # a doubly degenerate pair
    return np.concatenate([H, np.stack(special).astype(complex)])


def _both(fn_t, fn_j, H):
    got = fn_t(torch.as_tensor(H))
    want = fn_j(jnp.asarray(H))
    return got, want


@pytest.mark.parametrize("m", [1, 2, 3, 4, 5])
def test_eigvalsh_small_matches_reference(m):
    H = _cases(m, seed=m)
    got, want = _both(T.eigvalsh_small, J.eigvalsh_small, H)
    assert got.dtype == torch.float64 and got.shape == (H.shape[0], m)
    assert np.max(np.abs(got.numpy() - np.asarray(want))) <= TOL
    # and the LAPACK eigenvalues: to 1e-12 on the random batch, and on the
    # degenerate cases to the reference's own 1e-7 (tests/test_eigh3.py:34;
    # arccos near +-1 loses digits there, in both packages alike)
    lapack = np.abs(got.numpy() - np.linalg.eigvalsh(H))
    assert np.max(lapack[:300]) <= TOL and np.max(lapack) <= 1e-7


@pytest.mark.parametrize("m, fn", [(2, "eigvalsh2"), (3, "eigvalsh3")])
def test_closed_forms_match_reference(m, fn):
    H = _cases(m, seed=10 + m)
    got, want = _both(getattr(T, fn), getattr(J, fn), H)
    assert np.max(np.abs(got.numpy() - np.asarray(want))) <= TOL


def test_reference_test_cases():
    """The cases of the reference's tests/test_eigh3.py, at its tolerances
    and against the JAX package to 1e-12."""
    rng = np.random.default_rng(0)
    H = rng.normal(size=(500, 3, 3)) + 1j * rng.normal(size=(500, 3, 3))
    H = (H + H.conj().swapaxes(1, 2)) / 2
    got = T.eigvalsh3(torch.as_tensor(H)).numpy()
    assert np.allclose(got, np.linalg.eigvalsh(H), atol=1e-12)
    assert np.max(np.abs(got - np.asarray(J.eigvalsh3(jnp.asarray(H))))) <= TOL
    D = np.stack([np.diag([1.0, 1.0, 2.0]), np.eye(3), np.diag([3.0, 1.0, 2.0])]).astype(complex)
    got = T.eigvalsh3(torch.as_tensor(D)).numpy()
    assert np.allclose(got, np.linalg.eigvalsh(D), atol=1e-7)
    assert np.max(np.abs(got - np.asarray(J.eigvalsh3(jnp.asarray(D))))) <= TOL


def test_eigvalsh3_rows_matches_reference():
    H = _cases(3, seed=7)
    planes = [H[:, 0, 0].real, H[:, 1, 1].real, H[:, 2, 2].real, H[:, 0, 1].real, H[:, 0, 1].imag,
              H[:, 0, 2].real, H[:, 0, 2].imag, H[:, 1, 2].real, H[:, 1, 2].imag]
    got = T.eigvalsh3_rows(*(torch.as_tensor(p) for p in planes))
    want = J.eigvalsh3_rows(*(jnp.asarray(p) for p in planes))
    for g, w in zip(got, want):
        assert np.max(np.abs(g.numpy() - np.asarray(w))) <= TOL
    # the rows form agrees with the AoS form
    aos = T.eigvalsh3(torch.as_tensor(H)).numpy()
    assert np.max(np.abs(np.stack([g.numpy() for g in got], axis=1) - aos)) <= TOL


def test_eigh2_matches_reference_and_diagonalises():
    H = _cases(2, seed=3)
    H[:5, 0, 1] = H[:5, 1, 0] = 0.0  # diagonal matrices, both orderings of d
    (e, U), (ej, Uj) = _both(T.eigh2, J.eigh2, H)
    e, U = e.numpy(), U.numpy()
    assert np.max(np.abs(e - np.asarray(ej))) <= TOL
    assert np.max(np.abs(U - np.asarray(Uj))) <= TOL
    eye = np.eye(2)[None]
    assert np.max(np.abs(U.conj().swapaxes(1, 2) @ U - eye)) <= TOL  # unitary
    D = U.conj().swapaxes(1, 2) @ H @ U
    assert np.max(np.abs(D - e[:, :, None] * eye)) <= TOL  # diagonalises, ascending
    # the identity fallback at exact degeneracy: upper vector e_2, lower -e_1
    S = np.eye(2, dtype=complex)[None] * 2.5
    (e0, U0), (_, U0j) = _both(T.eigh2, J.eigh2, S)
    assert np.array_equal(U0.numpy(), np.asarray(U0j))
    assert torch.equal(U0[0], torch.tensor([[-1, 0], [0, 1]], dtype=torch.complex128))
    assert torch.equal(e0[0], torch.tensor([2.5, 2.5], dtype=torch.float64))


@pytest.mark.parametrize("m", [2, 4])
def test_eigh_small_dispatch(m):
    H = _cases(m, seed=20 + m)
    e, U = T.eigh_small(torch.as_tensor(H))
    ej, _ = J.eigh_small(jnp.asarray(H))
    assert np.max(np.abs(e.numpy() - np.asarray(ej))) <= TOL
    Hu = torch.as_tensor(H) @ U
    assert torch.max(torch.abs(Hu - U * e[:, None, :])) <= TOL


def test_eigvalsh_small_keeps_batch_shape_and_refuses_non_square():
    H = torch.as_tensor(random_hermitian(np.random.default_rng(4), 12, 3)).reshape(3, 4, 3, 3)
    assert T.eigvalsh_small(H).shape == (3, 4, 3)
    with pytest.raises(ValueError):
        T.eigvalsh_small(torch.zeros((4, 3, 2), dtype=torch.complex128))
