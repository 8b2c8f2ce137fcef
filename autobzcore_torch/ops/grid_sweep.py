"""Full-grid spectral sweeps: slab-streamed H(k), eigenvalues and broadened
DOS over a complete npt^3 PTR grid (reference
``autobzcore_tpu/ops/grid_sweep.py``, kernel families B6, B1 grid, B2, B4).

Streaming structure, as the reference: only dimension 3 is pre-contracted
per rung (``I3``: (n1, n2 * ne * npt), megabytes), and each slab of S rows
of dimension 1 runs two contraction stages on the device:

  stage A: slab phases (S, n1)   x I3                -> J (S, n2, ne, npt)
  stage B: phase table (npt, n2) x J, per entry e    -> H (ne, npt, S * npt)

over the ne = m(m+1)/2 independent Hermitian entries (the m diagonals, then
the upper off-diagonals). Both stages are plain complex128 products
(``torch.matmul``); the reference's Ozaki bf16 slicing and Karatsuba split
exist only because the TPU has no FP64, so ``ndiag`` is accepted and
ignored. The tail takes stage B's entry planes:

- m <= 3: kernel K7 (``csrc/fullgrid_tail.cu``, :func:`fullgrid_tail`):
  closed-form eigenvalues in registers and the weighted Lorentzian sum over
  all omegas, added to the rung's accumulator on the device;
- m > 3: ``torch.linalg.eigvalsh`` in batches the card's solver accepts,
  then kernel K8 (``csrc/lorentzian_sum.cu``, :func:`lorentzian_sum`).

The accumulator stays on the device and is read on the host once per rung.
Every value is native FP64: the reference's two-float f32 Lorentzian floor
(~1e-6 relative) does not apply, and rungs match a dense FP64 reference to
rounding.
"""
from __future__ import annotations

import math

import numpy as np
import torch

from .._device import COMPLEX, REAL, as_device, check_tensor
from .cuda_lib import check_launch, load_kernels, stream_handle
from .eigh3 import eigvalsh3_rows, eigvalsh_chunked

_PLAIN_TERMS = 1 << 22  # (omega, point) terms per pass of the plain Lorentzian sum


def _entries(m):
    """Hermitian entry order: the ``m`` real diagonals first, then the
    ``m (m-1) / 2`` complex upper off-diagonals (row-major)."""
    return tuple((i, i) for i in range(m)) + tuple(
        (i, j) for i in range(m) for j in range(i + 1, m)
    )


def _phase_table(npt, nfreq, offset):
    """Host-f64 (cos, sin) tables for the fractional PTR nodes."""
    freqs = offset + np.arange(nfreq)
    ang = 2 * np.pi * np.outer(np.arange(npt) / npt, freqs)
    return np.cos(ang), np.sin(ang)


def _phases(npt, nfreq, offset, device):
    """(npt, nfreq) complex128 phases exp(2 pi i f u) from the host tables."""
    c, s = _phase_table(npt, nfreq, offset)
    return torch.complex(torch.as_tensor(c), torch.as_tensor(s)).to(device)


# --- B4: the Lorentzian omega x k sum (kernel K8) ------------------------------


def lorentzian_sum_plain(e, w, omegas, eta, scale=1.0):
    """Plain PyTorch version of K8: ``scale * sum_k w_k sum_b eta / ((omegas
    - e[k, b])^2 + eta^2)`` for eigenvalues e (K, nb), weights w (K,) or None
    (unit weights) and omegas (W,); returns (W,) float64. Chunked over the
    (k, band) pairs so that the (W, chunk) intermediate stays near 32 MB."""
    K, nb = e.shape
    W = omegas.shape[0]
    flat = e.reshape(-1)
    wf = None if w is None else w[:, None].expand(K, nb).reshape(-1)
    chunk = max(1, _PLAIN_TERMS // max(W, 1))
    out = torch.zeros(W, dtype=REAL, device=e.device)
    for s in range(0, K * nb, chunk):
        t = omegas[:, None] - flat[None, s:s + chunk]
        lor = eta / (t * t + eta * eta)
        out += lor.sum(1) if wf is None else lor @ wf[s:s + chunk]
    return scale * out


def lorentzian_sum(e, w, omegas, eta, scale=1.0):
    """``D[j] = scale * sum_k w[k] sum_b eta / ((omegas[j] - e[k, b])^2 +
    eta^2)`` for e (K, nb) float64, w (K,) float64 or None, omegas (W,)
    float64: (W,) float64.

    CPU tensors take the plain version; CUDA tensors launch K8, and anything
    the kernel does not take raises."""
    check_tensor(e, "e", dtype=REAL, ndim=2)
    K, nb = e.shape
    if nb < 1:
        raise ValueError("lorentzian_sum needs at least one band")
    dev = e.device
    if w is not None:
        check_tensor(w, "w", device=dev, dtype=REAL, ndim=1, shape=(K,))
    check_tensor(omegas, "omegas", device=dev, dtype=REAL, ndim=1)
    eta, scale = float(eta), float(scale)
    if dev.type == "cpu":
        return lorentzian_sum_plain(e, w, omegas, eta, scale)
    if dev.type != "cuda":
        raise ValueError(f"lorentzian_sum runs on cpu or cuda tensors, got {dev}")
    W = omegas.shape[0]
    out = torch.empty(W, dtype=REAL, device=dev)
    lib = load_kernels()
    partials = torch.empty((lib.lorentz_num_blocks(K * nb, W), W), dtype=REAL, device=dev)
    stream = stream_handle(dev)
    rc = lib.lorentzian_sum_launch(e.data_ptr(), None if w is None else w.data_ptr(), K, nb,
                                   omegas.data_ptr(), W, eta, scale, partials.data_ptr(),
                                   out.data_ptr(), stream)
    check_launch(rc, "lorentzian_sum")
    lorentzian_sum.launches += 1
    return out


lorentzian_sum.launches = 0


# --- B2 rows + B4: the fused slab tail (kernel K7) ------------------------------


def slab_eigvalsh_plain(planes, m):
    """Eigenvalues (N, m), ascending, of the points of entry planes (ne, N)
    complex128 (the m diagonals' real parts, then the upper off-diagonals):
    the diagonal for m = 1, the 2x2 closed form for m = 2, ``eigvalsh3_rows``
    for m = 3."""
    d = [planes[i].real for i in range(m)]
    if m == 1:
        return d[0][:, None]
    if m == 2:
        b = planes[2]
        mean, h = (d[0] + d[1]) / 2, (d[0] - d[1]) / 2
        rad = torch.sqrt(h * h + (b.real * b.real + b.imag * b.imag))
        return torch.stack([mean - rad, mean + rad], dim=1)
    if m == 3:
        o = [planes[i] for i in range(3, 6)]
        return torch.stack(eigvalsh3_rows(d[0], d[1], d[2], o[0].real, o[0].imag,
                                          o[1].real, o[1].imag, o[2].real, o[2].imag), dim=1)
    raise ValueError(f"the closed forms take m <= 3 bands, got {m}")


def _point_weights(wrow, N, inner):
    """Per-point weights of slab points: point p lies in row (p // inner) % R."""
    rows = (torch.arange(N, device=wrow.device) // inner) % wrow.shape[0]
    return wrow[rows]


def fullgrid_tail_plain(planes, m, wrow, inner, omegas, eta, acc, scale=1.0):
    """Plain PyTorch version of K7: ``acc += scale * sum_p w_p sum_b eta /
    ((omegas - e_b(p))^2 + eta^2)`` over the N points of the entry planes
    (ne, N), point p weighted by ``wrow[(p // inner) % len(wrow)]``.
    Returns ``acc``."""
    N = planes.shape[1]
    e = slab_eigvalsh_plain(planes, m)
    acc += lorentzian_sum_plain(e, _point_weights(wrow, N, inner), omegas, eta, scale)
    return acc


def fullgrid_tail(planes, m, wrow, inner, omegas, eta, acc, scale=1.0):
    """One slab's tail: closed-form eigenvalues of the m <= 3 band Hermitian
    matrices whose entry planes are ``planes`` (m(m+1)/2, N) complex128, and
    ``acc (W,) += scale * sum_p w_p sum_b eta / ((omegas - e_b(p))^2 +
    eta^2)`` with the weight of point p ``wrow[(p // inner) % len(wrow)]``
    (0 on pad rows). Returns ``acc``.

    CPU tensors take the plain version; CUDA tensors launch K7, and anything
    the kernel does not take raises."""
    ne = m * (m + 1) // 2
    check_tensor(planes, "planes", dtype=COMPLEX, ndim=2, shape=(ne, None))
    N = planes.shape[1]
    dev = planes.device
    check_tensor(wrow, "wrow", device=dev, dtype=REAL, ndim=1)
    check_tensor(omegas, "omegas", device=dev, dtype=REAL, ndim=1)
    W = omegas.shape[0]
    check_tensor(acc, "acc", device=dev, dtype=REAL, ndim=1, shape=(W,))
    inner, eta, scale = int(inner), float(eta), float(scale)
    if inner < 1 or wrow.shape[0] < 1:
        raise ValueError("fullgrid_tail needs inner >= 1 and at least one row weight")
    if dev.type == "cpu":
        return fullgrid_tail_plain(planes, m, wrow, inner, omegas, eta, acc, scale)
    if dev.type != "cuda":
        raise ValueError(f"fullgrid_tail runs on cpu or cuda tensors, got {dev}")
    if not 1 <= m <= 3:
        raise ValueError(f"the CUDA tail kernel takes m <= 3 bands, got m = {m}")
    lib = load_kernels()
    partials = torch.empty((lib.lorentz_num_blocks(N, W), W), dtype=REAL, device=dev)
    stream = stream_handle(dev)
    rc = lib.fullgrid_tail_launch(planes.data_ptr(), wrow.data_ptr(), N, inner, wrow.shape[0], m,
                                  omegas.data_ptr(), W, eta, scale, partials.data_ptr(),
                                  acc.data_ptr(), stream)
    check_launch(rc, "fullgrid_tail")
    fullgrid_tail.launches += 1
    return acc


fullgrid_tail.launches = 0


# --- B6: the engine --------------------------------------------------------------


class FullGridSpectralSweep:
    """Broadened-DOS sweep engine for m-band Hermitian Fourier series.

    Parameters
    ----------
    series : a 3-D series of square Hermitian matrices (``.c`` of shape
        (n1, n2, n3, m, m), ``.offset``); a port ``FourierSeries``.
    omegas : (W,) frequency grid.
    eta : Lorentzian broadening.
    ndiag : the reference's Ozaki slice count; accepted and ignored (the
        stages are native complex128 products).
    slab : grid rows of the outer dimension per streamed step. Stage B's
        output is ne * npt^2 * slab complex128 values: 6.1 GB at npt = 2000
        and the default 16 for m = 3.
    slabs_per_dispatch : slabs between ``progress`` calls.
    omega_batch : the reference's omegas per Lorentzian pass, kept with its
        divisor rule (``omega_batch=0`` gives 1); the tail kernels take every
        omega in one pass.
    device : where the engine computes; the card unless the CPU is named.
    plain_kernels : run the tail's plain PyTorch versions instead of K7/K8
        on any device (the card's check of the kernels).
    """

    def __init__(self, series, omegas, eta, ndiag=6, slab=16, slabs_per_dispatch=32,
                 omega_batch=100, device="cuda", plain_kernels=False):
        self.device = as_device(device)
        c = series.c
        c = c.detach().cpu().numpy() if isinstance(c, torch.Tensor) else np.asarray(c)
        if c.ndim != 5 or c.shape[-2] != c.shape[-1]:
            raise ValueError(
                "FullGridSpectralSweep requires a 3D series of square matrices"
            )
        m = int(c.shape[-1])
        self.m = m
        self.n1, self.n2, self.n3 = c.shape[:3]
        self.offset = tuple(int(o) for o in series.offset)
        # the engine keeps only the independent Hermitian entries (real
        # diagonals), so a non-Hermitian series would silently be
        # "hermitianized": verify H(k) = H(k)^H densely at a few k-points
        rng = np.random.default_rng(7)
        for k in rng.uniform(size=(2, 3)):
            ph = [np.exp(2j * np.pi * k[d] * (self.offset[d] + np.arange(c.shape[d])))
                  for d in range(3)]
            hk = np.einsum("a,b,c,abcij->ij", ph[0], ph[1], ph[2], c)
            if not np.allclose(hk, hk.conj().T, rtol=1e-10,
                               atol=1e-10 * max(1.0, np.abs(hk).max())):
                raise ValueError(
                    "FullGridSpectralSweep requires a Hermitian series "
                    "(c(-R) = c(R)^H); H(k) at a test point is not Hermitian"
                )
        self.entries = _entries(m)
        self.ne = len(self.entries)
        c6 = np.stack([c[..., i, j] for (i, j) in self.entries], axis=-1)  # (n1, n2, n3, ne)
        # (n1, n2, ne, n3): dimension 3 last, for the per-rung pre-contraction
        self.c6 = torch.as_tensor(np.ascontiguousarray(c6.transpose(0, 1, 3, 2)),
                                  dtype=COMPLEX, device=self.device)
        # gather map for the general-m matrix assembly: entry index of
        # (min(i,j), max(i,j)) and the conjugation sign of the imaginary part
        idx = np.zeros((m, m), np.int64)
        sgn = np.zeros((m, m))
        for e, (i, j) in enumerate(self.entries):
            idx[i, j] = idx[j, i] = e
            if i != j:
                sgn[i, j], sgn[j, i] = 1.0, -1.0
        self._idx_mat = torch.as_tensor(idx.reshape(-1), device=self.device)
        self._sgn_mat = torch.as_tensor(sgn.reshape(-1), dtype=REAL, device=self.device)
        self.omegas = np.asarray(omegas, np.float64)
        self._om = torch.as_tensor(self.omegas, device=self.device)
        self.eta = float(eta)
        self.ndiag = ndiag
        self.slab = int(slab)
        self.spd = int(slabs_per_dispatch)
        self.plain_kernels = bool(plain_kernels)
        W = self.omegas.size
        ob = max(1, min(int(omega_batch), W))
        while W % ob:
            ob -= 1
        self.omega_batch = ob

    def set_omegas(self, omegas):
        """Swap the frequency grid of the same width: one engine serves any
        energy grid of its width (the interval-domain DOS driver reuses one
        engine across chebinterp refinement rounds this way)."""
        omegas = np.asarray(omegas, np.float64)
        if omegas.size != self.omegas.size:
            raise ValueError(
                f"set_omegas needs the compiled width {self.omegas.size}, got {omegas.size}"
            )
        self.omegas = omegas
        self._om = torch.as_tensor(omegas, device=self.device)

    # -- per-rung preparation ------------------------------------------------

    def _prepare(self, npt):
        """Pre-contract dimension 3: I3 (n1, n2 * ne * npt) complex128, the
        phases of dimension 1 padded to whole slabs, dimension 2's phase
        table and the row weights (1, 0 on pad rows). All O(npt) memory."""
        dev = self.device
        S = self.slab
        I3 = torch.matmul(self.c6, _phases(npt, self.n3, self.offset[2], dev).T)
        nslab = -(-npt // S)
        P1 = torch.zeros((nslab * S, self.n1), dtype=COMPLEX, device=dev)
        P1[:npt] = _phases(npt, self.n1, self.offset[0], dev)
        wrow = torch.zeros(nslab * S, dtype=REAL, device=dev)
        wrow[:npt] = 1.0
        return {"I3": I3.reshape(self.n1, -1), "P1": P1, "P2": _phases(npt, self.n2, self.offset[1], dev),
                "wrow": wrow, "nslab": nslab, "npt": npt}

    def slab_planes(self, prep, i):
        """Stages A and B of slab ``i``: the entry planes (ne, npt * S * npt)
        complex128, point (k2, s, k3) at k2 * S * npt + s * npt + k3, and the
        slab's row weights (S,)."""
        S, npt, ne = self.slab, prep["npt"], self.ne
        J = torch.matmul(prep["P1"][i * S:(i + 1) * S], prep["I3"])  # (S, n2 * ne * npt)
        J = J.reshape(S, self.n2, ne, npt).permute(2, 1, 0, 3).reshape(ne, self.n2, S * npt)
        H = torch.matmul(prep["P2"], J)  # (ne, npt, S * npt)
        return H.reshape(ne, -1), prep["wrow"][i * S:(i + 1) * S]

    def _tail(self, planes, wrow, npt, acc):
        m, om, eta = self.m, self._om, self.eta
        if m <= 3:
            tail = fullgrid_tail_plain if self.plain_kernels else fullgrid_tail
            return tail(planes, m, wrow, npt, om, eta, acc)
        # general m: assemble the (N, m, m) matrices from the entry planes
        N = planes.shape[1]
        re = planes.real[self._idx_mat]
        im = planes.imag[self._idx_mat] * self._sgn_mat[:, None]
        mats = torch.complex(re, im).T.reshape(N, m, m)
        e = torch.linalg.eigvalsh(mats) if planes.device.type == "cpu" else eigvalsh_chunked(mats)
        lsum = lorentzian_sum_plain if self.plain_kernels else lorentzian_sum
        acc += lsum(e, _point_weights(wrow, N, npt), om, eta)
        return acc

    # -- public API ----------------------------------------------------------

    def rung(self, npt, progress=None):
        """DOS partial sums over the full npt^3 grid: returns the (W,) array
        ``sum_k sum_b eta/((omega - e_b(k))^2 + eta^2) / pi`` (the caller
        applies the det(B)/npt^3 measure). The sum stays on the device until
        the rung's one host read."""
        prep = self._prepare(npt)
        nslab = prep["nslab"]
        acc = torch.zeros(self.omegas.size, dtype=REAL, device=self.device)
        for i in range(nslab):
            planes, wrow = self.slab_planes(prep, i)
            self._tail(planes, wrow, npt, acc)
            del planes
            if progress is not None and ((i + 1) % self.spd == 0 or i + 1 == nslab):
                progress(i + 1, nslab)
        return acc.cpu().numpy() / math.pi

    def rung_sharded(self, npt, mesh, axis="k"):
        """The reference's pod-parallel rung; multi-card sums are ROADMAP A10."""
        raise NotImplementedError(
            "rung_sharded (slab rows sharded over a device mesh) is not ported yet (ROADMAP A10)")
