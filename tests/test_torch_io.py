"""The port's Wannier90 readers and ``load_bz`` from a ``.wout`` file give
the JAX package's data on the same files."""
import os
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest
import torch

import autobzcore_tpu as J
from autobzcore_tpu.io import wannier90 as jw

import autobzcore_torch as T
from autobzcore_torch.io import wannier90 as tw

REPO = Path(__file__).resolve().parents[1]

HR_DAT = """ written by hand
           2
           3
    1    1    1
    0    0   -1    1    1    0.000000    0.000000
    0    0   -1    2    1    0.700000    0.100000
    0    0   -1    1    2    0.000000    0.000000
    0    0   -1    2    2    0.000000    0.000000
    0    0    0    1    1   11.000000    0.000000
    0    0    0    2    1    0.000000    0.000000
    0    0    0    1    2    0.000000    0.000000
    0    0    0    2    2   12.000000    0.000000
    0    0    1    1    1    0.000000    0.000000
    0    0    1    2    1    0.000000    0.000000
    0    0    1    1    2    0.700000   -0.100000
    0    0    1    2    2    0.000000    0.000000
"""

WOUT = """ header lines of a Wannier90 run
                                 Lattice Vectors (Ang)
                    a_1     3.840000   0.000000   0.000000
                    a_2     0.000000   3.840000   0.000000
                    a_3     0.000000   0.000000   3.840000

                   Reciprocal-Space Vectors (Ang^-1)
                    b_1     1.636246   0.000000   0.000000
                    b_2     0.000000   1.636246   0.000000
                    b_3     0.000000   0.000000   1.636246

 *----------------------------------------------------------------------------*
 |   Site       Fractional Coordinate          Cartesian Coordinate (Ang)     |
 +----------------------------------------------------------------------------+
| Sr   1   0.00000   0.00000   0.00000   |    0.00000   0.00000   0.00000    |
| V    1   0.50000   0.50000   0.50000   |    1.92000   1.92000   1.92000    |
 *----------------------------------------------------------------------------*
"""


@pytest.fixture
def files(tmp_path):
    hr, wout = tmp_path / "toy_hr.dat", tmp_path / "toy.wout"
    hr.write_text(HR_DAT)
    wout.write_text(WOUT)
    return str(hr), str(wout)


def test_hrdat_and_series_match_reference(files):
    hr = files[0]
    want, got = jw.read_w90_hrdat(hr), tw.read_w90_hrdat(hr)
    for key in ("Rvectors", "Rdegens", "H"):
        np.testing.assert_array_equal(got[key], want[key])
    js, ts = jw.hamiltonian_fourier_series(want), tw.hamiltonian_fourier_series(got, device="cpu")
    np.testing.assert_array_equal(ts.c.numpy(), np.asarray(js.c))
    assert (ts.offset, ts.period, ts.sndim) == (js.offset, js.period, js.sndim)


def test_wout_and_load_bz_match_reference(files):
    wout = files[1]
    want, got = jw.read_wout(wout), tw.read_wout(wout)
    np.testing.assert_array_equal(got["lattice"], want["lattice"])
    np.testing.assert_array_equal(got["recip_lattice"], want["recip_lattice"])
    assert got["atom_labels"] == want["atom_labels"] == ["Sr", "V"]
    np.testing.assert_array_equal(got["atom_positions_frac"], want["atom_positions_frac"])
    jbz, tbz = J.load_bz(J.CubicSymIBZ(), wout), T.load_bz(T.CubicSymIBZ(), wout)
    np.testing.assert_array_equal(tbz.B, jbz.B)
    assert tbz.nsyms == jbz.nsyms == 48


def test_wannier_dos_solve_matches_reference(files):
    from autobzcore_tpu.models.observables import dos_integrand as jdos
    from autobzcore_torch.models.observables import dos_integrand as tdos

    hr, wout = files
    js = jw.hamiltonian_fourier_series(jw.read_w90_hrdat(hr))
    ts = tw.hamiltonian_fourier_series(tw.read_w90_hrdat(hr), device="cpu")
    om = np.linspace(10.5, 12.5, 4)
    want = J.solve(J.IntegralProblem(jdos(js, 0.1), J.load_bz(J.CubicSymIBZ(), wout), om), J.PTR(npt=8))
    got = T.solve(T.IntegralProblem(tdos(ts, 0.1), T.load_bz(T.CubicSymIBZ(), wout), om), T.PTR(npt=8, device="cpu"))
    np.testing.assert_allclose(got.u.numpy(), np.asarray(want.u), rtol=1e-10, atol=0)
    assert got.numevals == want.numevals


def test_example_runs_wannier_files_on_cpu(files, tmp_path):
    hr, wout = files
    out = subprocess.run(
        [sys.executable, str(REPO / "examples" / "aps_example_torch.py"), "--hr", hr, "--wout", wout,
         "--device", "cpu", "--npt", "6", "--eta", "0.3"],
        capture_output=True, text=True, timeout=240, cwd=tmp_path,
        env=dict(os.environ, OMP_NUM_THREADS="2"))
    assert out.returncode == 0, out.stderr[-2000:]
    assert "2-band Wannier model" in out.stderr
    assert out.stdout.startswith("PTR DOS(12.5 eV) = ")
    assert torch.isfinite(torch.tensor(float(out.stdout.split("=")[1])))
