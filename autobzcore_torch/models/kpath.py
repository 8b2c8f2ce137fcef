"""Band structures, band expectations and spectral maps along k-paths
(reference ``autobzcore_tpu/models/kpath.py``, kernel family B15).

``KPath`` and ``kpath`` are host numpy. The path's Hamiltonians come from
kernel K1 (``fourier_points``) at the path points; then

- ``band_structure``: ``eigvalsh_small`` (K9 for m <= 3, cuSOLVER's
  ``eigvalsh`` in the batches it takes above);
- ``expectation_path``: ``<u_n|O|u_n>`` by kernel K30 (:func:`band_expect`,
  ``csrc/band_expect.cu``), after ``eigh_small`` (the closed form ``eigh2``
  at m = 2, which K30 fuses and so reads H itself; chunked ``eigh`` above);
- ``spectral_path``: the (K, W) Lorentzian map by kernel K29
  (:func:`spectral_map`, ``csrc/spectral_path.cu``).

Results are float64 tensors on the series' device. There is no cache of
compiled programs: the reference's ``_KPATH_CACHE`` holds XLA executables,
and the kernels here are built once per process.
"""
from __future__ import annotations

import math
from typing import NamedTuple

import numpy as np
import torch

from .._device import COMPLEX, REAL, check_tensor
from ..fourier import FourierSeries
from ..ops.cuda_lib import check_launch, load_kernels, stream_handle
from ..ops.eigh3 import eigh2, eigh_small, eigvalsh_small
from ..ops.fourier_eval import fourier_points


class KPath(NamedTuple):
    """A sampled polyline through the zone in FRACTIONAL coordinates.

    ``X``: (K, d) path points; ``s``: (K,) cumulative arclength (Cartesian
    when built with ``B``, fractional otherwise), the plot abscissa;
    ``ticks``: indices into ``X`` of the input vertices (high-symmetry
    points); ``labels``: optional vertex labels."""

    X: object
    s: object
    ticks: object
    labels: object


def kpath(vertices, npts=50, B=None, labels=None) -> KPath:
    """Sample the polyline through ``vertices`` ((P, d) fractional corners)
    with ~``npts`` points per unit arclength segment (at least 2 per
    segment), duplicating no corner. ``B`` (reciprocal basis, columns)
    makes ``s`` a Cartesian arclength so segments plot with true relative
    lengths."""
    V = np.asarray(vertices, dtype=np.float64)
    if V.ndim != 2 or len(V) < 2:
        raise ValueError("vertices must be (P >= 2, d)")
    M = np.eye(V.shape[1]) if B is None else np.asarray(B, dtype=np.float64)
    lens = np.linalg.norm((V[1:] - V[:-1]) @ M.T, axis=1)
    scale = npts / max(lens.max(), 1e-300)
    xs, ticks = [V[0][None]], [0]
    for j, L in enumerate(lens):
        n = max(2, int(round(L * scale)) + 1)  # points incl. both corners
        t = np.linspace(0.0, 1.0, n)[1:, None]
        xs.append(V[j] * (1 - t) + V[j + 1] * t)
        ticks.append(ticks[-1] + n - 1)
    X = np.concatenate(xs, axis=0)
    ds = np.linalg.norm((X[1:] - X[:-1]) @ M.T, axis=1)
    s = np.concatenate([[0.0], np.cumsum(ds)])
    return KPath(X, s, np.asarray(ticks), labels)


def path_hamiltonians(h: FourierSeries, path):
    """H (K, m, m) complex128 at the points of ``path`` (a :class:`KPath` or
    a raw (K, d) array of fractional points), by K1 on the series' device."""
    X = path.X if isinstance(path, KPath) else path
    X = torch.as_tensor(np.asarray(X.cpu() if isinstance(X, torch.Tensor) else X, dtype=np.float64),
                        device=h.device)
    return fourier_points(h.c, X.reshape(X.shape[0], -1).contiguous(), h.offset, h.period)


def band_structure(h: FourierSeries, path):
    """Band energies along a path: (K, m) ascending eigenvalues, float64 on
    the series' device. ``path`` is a :class:`KPath` or a raw (K, d)
    fractional array."""
    return eigvalsh_small(path_hamiltonians(h, path)).contiguous()


def band_expect_plain(V, O, fused=False):
    """Plain PyTorch version of K30, the reference's operations: with
    ``fused`` the eigenvectors of the 2x2 H ``V`` by the closed form
    ``eigh2``, else V are the eigenvectors U; then ``Re einsum("kin,ij,kjn->kn",
    conj(U), O, U)`` in chunks of points. Returns (K, m) float64."""
    U = eigh2(V)[1] if fused else V
    out = [torch.einsum("kin,ij,kjn->kn", U[s:s + 65536].conj(), O, U[s:s + 65536]).real
           for s in range(0, U.shape[0], 65536)]
    return torch.cat(out) if out else torch.empty((0, U.shape[-1]), dtype=REAL, device=U.device)


def band_expect(V, O, fused=False):
    """``out[k, n] = Re <u_n(k)| O |u_n(k)>`` for eigenvectors U = V (K, m, m)
    complex128 (columns), or with ``fused`` (m = 2 only) the Hamiltonians H
    = V themselves, whose eigenvectors are the closed form ``eigh2``'s, and
    an (m, m) complex128 operator O. Returns (K, m) float64.

    CPU tensors take the plain version; CUDA tensors launch K30
    (``csrc/band_expect.cu``), and anything the kernel does not take
    raises."""
    check_tensor(V, "V", dtype=COMPLEX, ndim=3)
    K, m = V.shape[0], V.shape[-1]
    check_tensor(V, "V", shape=(K, m, m))
    check_tensor(O, "O", device=V.device, dtype=COMPLEX, ndim=2, shape=(m, m))
    if fused and m != 2:
        raise ValueError(f"the fused eigh2 form takes m = 2, got m = {m}")
    if V.device.type == "cpu":
        return band_expect_plain(V, O, fused)
    if V.device.type != "cuda":
        raise ValueError(f"band_expect runs on cpu or cuda tensors, got {V.device}")
    lib = load_kernels()
    if m > lib.band_expect_max_bands():
        raise ValueError(f"K30 takes m <= {lib.band_expect_max_bands()}, got {m}")
    out = torch.empty((K, m), dtype=REAL, device=V.device)
    if K == 0:
        return out
    stream = stream_handle(V.device)
    check_launch(lib.band_expect_launch(V.data_ptr(), O.data_ptr(), out.data_ptr(), K, m, int(bool(fused)), stream),
                 "band_expect")
    band_expect.launches += 1
    return out


band_expect.launches = 0


def expectation_path(h: FourierSeries, path, O):
    """Band-resolved operator expectations along a path: (K, m) values
    ``<u_n(k)| O |u_n(k)>`` for an (m, m) Hermitian ``O`` (spin textures,
    orbital characters, sublattice polarizations), float64 on the series'
    device. Only non-degenerate bands give gauge-free values; over a
    degenerate pair only the pair's sum is."""
    H = path_hamiltonians(h, path)
    m = H.shape[-1]
    Ot = torch.as_tensor(np.asarray(O.cpu() if isinstance(O, torch.Tensor) else O, dtype=np.complex128),
                         device=H.device)
    if m == 2:
        return band_expect(H.contiguous(), Ot, fused=True)
    _, U = eigh_small(H)
    return band_expect(U.contiguous(), Ot)


def spectral_map_plain(e, omegas, eta):
    """Plain PyTorch version of K29, the reference's operations (``eta /
    ((om - e)^2 + eta^2) / pi``, summed over the bands) in chunks of
    points. Returns (K, W) float64."""
    K, m = e.shape
    W = omegas.shape[0]
    chunk = max(1, (1 << 22) // max(1, W * m))
    out = [torch.sum(eta / ((omegas[None, :, None] - e[s:s + chunk, None, :]) ** 2 + eta**2) / math.pi, dim=-1)
           for s in range(0, K, chunk)]
    return torch.cat(out) if out else torch.empty((0, W), dtype=REAL, device=e.device)


def spectral_map(e, omegas, eta):
    """``A[k, j] = (1/pi) sum_n eta / ((omegas[j] - e[k, n])^2 + eta^2)`` for
    band energies e (K, m) and frequencies omegas (W,) float64 and one
    broadening eta. Returns (K, W) float64.

    CPU tensors take the plain version; CUDA tensors launch K29
    (``csrc/spectral_path.cu``), and anything the kernel does not take
    raises."""
    check_tensor(e, "e", dtype=REAL, ndim=2)
    K, m = e.shape
    check_tensor(omegas, "omegas", device=e.device, dtype=REAL, ndim=1)
    W = omegas.shape[0]
    eta = float(eta)
    if e.device.type == "cpu":
        return spectral_map_plain(e, omegas, eta)
    if e.device.type != "cuda":
        raise ValueError(f"spectral_map runs on cpu or cuda tensors, got {e.device}")
    lib = load_kernels()
    if m > lib.spectral_path_max_bands():
        raise ValueError(f"K29 takes m <= {lib.spectral_path_max_bands()}, got {m}")
    out = torch.empty((K, W), dtype=REAL, device=e.device)
    if K == 0 or W == 0:
        return out
    stream = stream_handle(e.device)
    check_launch(lib.spectral_path_launch(e.data_ptr(), omegas.data_ptr(), out.data_ptr(), K, m, W, eta,
                                          1.0 / math.pi, stream), "spectral_map")
    spectral_map.launches += 1
    return out


spectral_map.launches = 0


def spectral_path(h: FourierSeries, path, omegas, eta):
    """Momentum-resolved spectral function map ``A(k, omega) = (1/pi) sum_n
    eta / ((omega - e_n(k))^2 + eta^2)``, the band-basis trace of ``-Im G /
    pi`` with constant broadening: (K, W) float64 on the series' device; it
    satisfies the sum rule ``int A domega = m`` per k-point."""
    e = band_structure(h, path)
    om = torch.as_tensor(np.asarray(omegas.cpu() if isinstance(omegas, torch.Tensor) else omegas,
                                    dtype=np.float64), device=e.device).reshape(-1).contiguous()
    return spectral_map(e, om, eta)
