"""Wannier90 file parsers (reference ``autobzcore_tpu/io/wannier90.py``):
``seedname_hr.dat`` (real-space Hamiltonian) and ``seedname.wout`` (lattice
vectors and atoms). The parsers are numpy only and are shared in content
with the JAX package."""
from __future__ import annotations

import re

import numpy as np

from .._device import COMPLEX


def read_w90_hrdat(path):
    """Parse a Wannier90 ``_hr.dat`` file.

    Returns dict with ``Rvectors`` (nrpts, 3) int, ``Rdegens`` (nrpts,),
    ``H`` (nrpts, num_wann, num_wann) complex.
    """
    with open(path) as fh:
        fh.readline()  # header comment
        num_wann = int(fh.readline())
        nrpts = int(fh.readline())
        degens = []
        while len(degens) < nrpts:
            degens.extend(int(t) for t in fh.readline().split())
        degens = np.array(degens[:nrpts])
        data = np.loadtxt(fh)
    expected = nrpts * num_wann * num_wann
    if data.shape[0] != expected:
        raise ValueError(f"hr.dat: expected {expected} matrix-element rows, got {data.shape[0]}")
    R = data[::num_wann * num_wann, 0:3].astype(np.int64)
    H = np.empty((nrpts, num_wann, num_wann), dtype=np.complex128)
    i = data[:, 3].astype(np.int64) - 1
    j = data[:, 4].astype(np.int64) - 1
    r = np.repeat(np.arange(nrpts), num_wann * num_wann)
    # the (i, j) labels on each line are row/column of H_mn(R) = <m0|H|nR>
    H[r, i, j] = data[:, 5] + 1j * data[:, 6]
    return {"Rvectors": R, "Rdegens": degens, "H": H, "num_wann": num_wann}


def hamiltonian_fourier_series(hrdat, period=1.0, dtype=COMPLEX, device="cuda"):
    """The coefficient tensor of ``H(k) = sum_R H_R/degen_R e^{2 pi i R.k}``
    on the bounding R-box, as a :class:`FourierSeries` on ``device``."""
    from ..fourier import FourierSeries

    R = hrdat["Rvectors"]
    H = hrdat["H"] / hrdat["Rdegens"][:, None, None]
    m = hrdat["num_wann"]
    rmin = R.min(axis=0)
    rmax = R.max(axis=0)
    C = np.zeros(tuple(rmax - rmin + 1) + (m, m), dtype=np.complex128)
    C[tuple((R - rmin).T)] = H
    return FourierSeries(C, period=period, offset=tuple(int(x) for x in rmin), ndim=3,
                         dtype=dtype, device=device)


def read_wout(path):
    """Parse lattice vectors, reciprocal vectors, and atom sites from a
    Wannier90 ``.wout`` file. Vectors are returned as *columns* of the
    ``lattice``/``recip_lattice`` matrices."""
    with open(path) as fh:
        text = fh.read()

    def parse_vec_block(header, prefix):
        m = re.search(re.escape(header) + r".*?\n((?:\s*" + prefix + r"_\d.*\n){3})", text)
        if m is None:
            raise ValueError(f"could not find block {header!r} in {path}")
        rows = []
        for line in m.group(1).strip().splitlines():
            parts = line.split()
            rows.append([float(x) for x in parts[1:4]])
        return np.array(rows).T  # rows in file are the vectors -> columns

    A = parse_vec_block("Lattice Vectors", "a")
    Bm = parse_vec_block("Reciprocal-Space Vectors", "b")

    labels = []
    fracs = []
    site_block = re.search(
        r"Site\s+Fractional Coordinate.*?\n.?[-+]+.?\n((?:\|.*\n)+)", text
    )
    if site_block:
        for line in site_block.group(1).strip().splitlines():
            parts = line.replace("|", " ").split()
            if len(parts) >= 5:
                labels.append(parts[0])
                fracs.append([float(parts[2]), float(parts[3]), float(parts[4])])
    return {
        "lattice": A,
        "recip_lattice": Bm,
        "atom_labels": labels,
        "atom_positions_frac": np.array(fracs) if fracs else np.zeros((0, 3)),
    }
