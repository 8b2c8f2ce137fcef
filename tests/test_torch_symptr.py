"""The port's copy of the host symmetry reduction gives the JAX package's
rule arrays exactly."""
import numpy as np
import pytest

from autobzcore_tpu.ops import symptr as jsym

from autobzcore_torch.ops import symptr as tsym


@pytest.mark.parametrize("group", ["inversion", "cubic"])
@pytest.mark.parametrize("d", [2, 3])
@pytest.mark.parametrize("npt", [4, 7, 10])
def test_symptr_rule_identical(npt, d, group):
    syms = jsym.inversion_syms(d) if group == "inversion" else jsym.cube_automorphism_syms(d)
    np.testing.assert_array_equal(
        syms, tsym.inversion_syms(d) if group == "inversion" else tsym.cube_automorphism_syms(d))
    jr, jw = jsym.symptr_rule(npt, d, syms)
    tr, tw = tsym.symptr_rule(npt, d, syms)
    assert tr.dtype == jr.dtype and tw.dtype == jw.dtype
    np.testing.assert_array_equal(tr, jr)
    np.testing.assert_array_equal(tw, jw)
    assert tw.sum() == npt**d


@pytest.mark.parametrize("npt", [5, 8])
def test_orbit_map_identical(npt):
    syms = jsym.cube_automorphism_syms(3)
    for a, b in zip(jsym.symptr_orbit_map(npt, 3, syms), tsym.symptr_orbit_map(npt, 3, syms)):
        np.testing.assert_array_equal(a, b)


def test_native_and_numpy_canonicalization_agree():
    syms = tsym.as_integer_syms(tsym.inversion_syms(3))
    npt = 6
    strides = npt ** np.arange(2, -1, -1, dtype=np.int64)
    want = tsym._canonicalize_numpy(npt, 3, syms, strides, npt**3, 1 << 20)
    got = tsym._canonicalize_native(npt, 3, syms)  # g++ builds the library at first use
    assert got is not None
    np.testing.assert_array_equal(got, want)
