"""Shared pieces of the DOS parity tests (tests/test_torch_dos_*.py): the
reference test's series in both packages, a record of the rungs each
package's engines run, and the comparison of two curves."""
import numpy as np
import pytest

from autobzcore_tpu import FBZ as JFBZ
from autobzcore_tpu import dos as jdos
from autobzcore_tpu import load_bz as jload_bz
from autobzcore_tpu.fourier import FourierSeries as JFourierSeries
from autobzcore_tpu.ops.grid_sweep import FullGridSpectralSweep as JSweep

import autobzcore_torch as T
from autobzcore_torch import dos as tdos
from autobzcore_torch.interop import series_from_arrays
from autobzcore_torch.ops.grid_sweep import FullGridSpectralSweep as TSweep
from torch_parity import hermitian_series_arrays

JAX_RTOL = 3e-6  # the JAX engine's two-float f32 Lorentzian tier

# The JAX engine's rungs by (coefficients, eta, omegas, npt): a rung is a
# pure function of these, and on the CPU each JAX rung compiles for seconds,
# so a ladder that repeats a rung on the same grid reads it from here.
_JAX_RUNGS = {}


def both_series(C, off):
    return (JFourierSeries(C, period=1.0, offset=off, ndim=3),
            series_from_arrays(C, off, 1.0, 3, device="cpu"))


@pytest.fixture(scope="module")
def setup():
    """The reference test's series (seed 11) and the full zone, in both packages."""
    C, off = hermitian_series_arrays(seed=11)
    js, ts = both_series(C, off)
    return {"C": C, "off": off, "j": (js, jload_bz(JFBZ(), np.eye(3))),
            "t": (ts, T.load_bz(T.FBZ(), np.eye(3)))}


@pytest.fixture
def rungs(monkeypatch):
    """The npt of every rung each package's engines run, in order."""
    seen = {"j": [], "t": []}
    j_rung, t_rung = JSweep.rung, TSweep.rung

    def jrec(self, npt, progress=None):
        seen["j"].append(npt)
        key = (np.asarray(self.c6_re).tobytes(), np.asarray(self.c6_im).tobytes(), self.eta,
               self.omegas.tobytes(), npt)
        if key not in _JAX_RUNGS:
            _JAX_RUNGS[key] = j_rung(self, npt, progress)
        return _JAX_RUNGS[key].copy()

    def trec(self, npt, progress=None):
        seen["t"].append(npt)
        return t_rung(self, npt, progress)

    monkeypatch.setattr(JSweep, "rung", jrec)
    monkeypatch.setattr(TSweep, "rung", trec)
    return seen


def algs(eta, **kw):
    return jdos.LorentzianFullGrid(eta, **kw), tdos.LorentzianFullGrid(eta, device="cpu", **kw)


def close(got, want, abstol):
    """Within the JAX tier (3e-6 relative) or the case's abstol, whichever
    is larger, pointwise."""
    got, want = np.asarray(got, np.float64), np.asarray(want, np.float64)
    assert got.shape == want.shape
    assert np.all(np.abs(got - want) <= np.maximum(JAX_RTOL * np.abs(want), abstol))


def same_solution(sj, st, abstol):
    assert st.retcode is sj.retcode and st.numevals == sj.numevals
    close(st.u, sj.u, abstol)
