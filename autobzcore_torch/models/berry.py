"""Berry curvature, Chern numbers, Wilson loops and the intrinsic anomalous
Hall family on the full zone grid (reference
``autobzcore_tpu/models/berry.py``, kernel family B12).

The build evaluates (H, dH) on the ``npt^d`` grid in row slabs of at most
2^18 points (``evaluate_grid``: complex128 products), so that peak memory
is the pack and one slab. Kernel K21 (:func:`band_pair_terms`,
``csrc/berry_pairs.cu``) then forms per point the eigenpairs (the closed
form ``eigh2`` in registers at m = 2; ``torch.linalg.eigh`` in chunks of
``ops.eigh3.EIGH_CHUNK`` above, as the reference calls its library), the
band-basis velocities and the degeneracy-masked band-pair sums: the
curvature, orbital moment and group velocities of :class:`BerryPack`, the
quantum metric, or the operator curvature of :meth:`~BerryCurvatureSolver.
operator_hall`. Every (mu, beta) query is one launch of kernel K24
(:func:`zone_average`, ``csrc/zone_average.cu``) and a float64 host tail
``|det B| / (2 pi)^d B^-T X B^-1``. The lattice (FHS) Chern number runs
kernel K22 (:func:`plaquette_flux`) and the Wilson loops kernel K23
(:func:`wilson_loops`, both ``csrc/berry_links.cu``) on frames from
``ops.eigh3.eigh_small``; the loop eigenphases and ``z2_invariant`` are
host numpy, as in the reference.

Queries return numpy; the pack's tensors stay on the series' device. The
reference's cache of compiled executables (``_LATTICE_CHERN_CACHE``) has
no counterpart: PyTorch runs eagerly, so a model scan pays its launches per
model. Physics and conventions as in the reference's module docstring:
fractional-coordinate curvature ``Omega_n,ab = -2 Im sum_{m != n} v_a,nm
v_b,mn / (e_n - e_m)^2`` with ``v_a = dH/du_a``, Cartesian tensors by
``B^-T . B^-1``, and a full-zone ``load_bz(FBZ(), ...)`` required (the
curvature is time-reversal-odd).
"""
from __future__ import annotations

from typing import NamedTuple

import numpy as np
import torch

from .._device import COMPLEX, REAL, check_tensor
from ..ops.cuda_lib import check_launch, load_kernels, stream_handle
from ..ops.eigh3 import eigh_small
from ..ops.fourier_eval import evaluate_grid
from .transport import fermi

_PAIR_MODES = {"curvature": 0, "metric": 1, "operator": 2}
_AVERAGE_MODES = {"step": 0, "fermi": 1, "entropy": 2, "dipole": 3, "grand": 4, "band": 5}
MAX_LINK_BANDS = 8  # the most occupied bands K22 and K23 take (csrc/berry_links.cu kMaxNb)


def _require_full_zone(bz, what):
    if getattr(bz, "syms", None) is not None:
        raise ValueError(
            f"{what} requires a full-zone BZ (load_bz(FBZ, ...)): Berry curvature is "
            "time-reversal-odd and the stored lattice point group need not be a symmetry of "
            "a TRS-broken Hamiltonian")


class BerryPack(NamedTuple):
    """Band energies and band-resolved fractional-coordinate Berry curvature
    on the full ``npt^d`` zone grid (built once, queried per (mu, beta)).
    ``Mm`` is the band self-rotation moment (the Kubo pair sum with
    ``1/(e_n - e_m)`` in place of ``1/(e_n - e_m)^2``). Tensors in float64
    on the series' device, C order over the grid."""

    e: object        # (K, m) band energies
    Om: object       # (K, m, d, d) Omega^frac_n,ab per grid point and band
    Mm: object       # (K, m, d, d) m^frac_n,ab = sum_m Q_ab,nm / (e_n - e_m)
    vd: object       # (K, m, d) diagonal band velocities Re v_a,nn
    ndim: int
    npt: int


def _slab_rows(h, npt, d, max_pts=1 << 18):
    """Row slabs along the first grid dimension: (S, L) first coordinates
    and the fixed inner nodes (the reference's slabs, so that peak memory
    stays O(slab))."""
    L = npt
    while L > 1 and L * npt ** (d - 1) > max_pts:
        L //= 2
    while npt % L:
        L -= 1
    u1 = np.arange(npt) / npt * h.period[0]
    inner = [np.arange(npt) / npt * h.period[j] for j in range(1, d)]
    return u1.reshape(-1, L), inner


def _eval_slab(h, d, u1_blk, inner):
    """(H (n, m, m), dH (n, d, m, m)) on one row slab, flattened in C order."""
    nodes = [u1_blk] + inner
    hk = evaluate_grid(h.c, d, nodes, h.offset, h.period)
    grads = [evaluate_grid(h.c, d, nodes, h.offset, h.period, tuple(int(i == j) for i in range(d)))
             for j in range(d)]
    vk = torch.stack(grads, dim=d)
    return (hk.reshape((-1,) + tuple(hk.shape[d:])).contiguous(),
            vk.reshape((-1, d) + tuple(vk.shape[d + 1:])).contiguous())


def _slab_map(h, npt, d, fn):
    """``fn(H, dH)`` over the row slabs of the ``npt^d`` grid: each of the
    tuple of (n, ...) tensors it returns lands in its rows of one (npt^d,
    ...) tensor, allocated at the first slab."""
    u1_slabs, inner = _slab_rows(h, npt, d)
    outs, s = None, 0
    for u1_blk in u1_slabs:
        parts = fn(*_eval_slab(h, d, u1_blk, inner))
        if outs is None:
            outs = [torch.empty((npt**d,) + tuple(p.shape[1:]), dtype=p.dtype, device=p.device) for p in parts]
        n = parts[0].shape[0]
        for o, p in zip(outs, parts):
            o[s:s + n] = p
        s += n
    return outs


def _pair_inv(e, degtol, power):
    """Degeneracy-masked band-pair denominators ``1/(e_n - e_m)^power``
    (zero on |de| <= degtol, the diagonal included): the shared masking rule
    of every Kubo sum here (reference ``berry.py:91-98``)."""
    de = e[..., :, None] - e[..., None, :]
    safe = torch.where(de == 0, torch.ones_like(de), de)
    return torch.where(de.abs() > degtol, 1.0 / safe**power, torch.zeros_like(de))


def band_pair_terms_plain(H, dH, degtol, mode="curvature", O=None):
    """Plain PyTorch version of K21, the reference's einsums
    (``berry.py:101-118``, ``:551-562``, ``:223-233``) after ``eigh_small``.
    Returns ``(e, Om, Mm, vd)`` (curvature), ``g`` (metric) or ``(e, OmO)``
    (operator), as :func:`band_pair_terms`."""
    e, U = eigh_small(H)
    Ud = U.conj().transpose(-1, -2)
    v = torch.einsum("kmi,kdij,kjn->kdmn", Ud, dH, U)
    if mode == "metric":
        m = e.shape[-1]
        R = torch.einsum("kanm,kbmn->kabnm", v, v).real
        off = 1 - torch.eye(m, dtype=REAL, device=e.device)
        return torch.einsum("kabnm,knm->knab", R, _pair_inv(e, degtol, 2) * off).contiguous()
    left = v
    if mode == "operator":
        Ob = torch.einsum("kmi,ij,kjn->kmn", Ud, O.to(U.dtype), U)
        left = 0.5 * (torch.einsum("knp,kdpm->kdnm", Ob, v) + torch.einsum("kdnp,kpm->kdnm", v, Ob))
    Q = torch.einsum("kanm,kbmn->kabnm", left, v).imag
    Om = (-2.0 * torch.einsum("kabnm,knm->knab", Q, _pair_inv(e, degtol, 2))).contiguous()
    if mode == "operator":
        return e.contiguous(), Om
    Mm = torch.einsum("kabnm,knm->knab", Q, _pair_inv(e, degtol, 1)).contiguous()
    vd = torch.einsum("kdnn->knd", v).real.contiguous()
    return e.contiguous(), Om, Mm, vd


def band_pair_terms(H, dH, degtol, mode="curvature", O=None):
    """The band-pair terms of Hamiltonians H (K, m, m) and gradients dH (K,
    d, m, m) complex128 (dH's (m, m) blocks contiguous; K11's and the slab
    build's strided views are taken as they are), with band pairs closer
    than ``degtol`` dropped:

    - ``mode="curvature"``: ``(e (K, m), Om (K, m, d, d), Mm (K, m, d, d),
      vd (K, m, d))``, the pack's fields;
    - ``"metric"``: the quantum metric ``g`` (K, m, d, d);
    - ``"operator"``: ``(e, OmO)``, the curvature of the symmetrized
      current of the (m, m) complex128 operator ``O``.

    CPU tensors take the plain version; CUDA tensors launch K21
    (``csrc/berry_pairs.cu``; at m > 2 after ``eigh_small``'s chunked
    ``torch.linalg.eigh``), and anything the kernel does not take raises."""
    check_tensor(H, "H", dtype=COMPLEX, ndim=3)
    K, m, m2 = H.shape
    if m2 != m or not isinstance(dH, torch.Tensor) or dH.ndim != 4 or dH.shape[0] != K \
            or tuple(dH.shape[2:]) != (m, m):
        raise ValueError(f"band_pair_terms takes H (K, m, m) and dH (K, d, m, m), got {tuple(H.shape)} and "
                         f"{tuple(getattr(dH, 'shape', ()))}")
    if dH.dtype != COMPLEX or dH.device != H.device:
        raise ValueError("dH must be a complex128 tensor on H's device")
    if mode not in _PAIR_MODES:
        raise ValueError(f"mode must be one of {tuple(_PAIR_MODES)}, got {mode!r}")
    if mode == "operator":
        if not isinstance(O, torch.Tensor):
            raise ValueError("mode 'operator' needs the operator O as an (m, m) complex128 tensor")
        check_tensor(O, "O", device=H.device, dtype=COMPLEX, ndim=2, shape=(m, m))
    d = dH.shape[1]
    if H.device.type == "cpu":
        return band_pair_terms_plain(H, dH, degtol, mode, O)
    if H.device.type != "cuda":
        raise ValueError(f"band_pair_terms runs on cpu or cuda tensors, got {H.device}")
    if dH.stride(3) != 1 or dH.stride(2) != m:
        raise ValueError("band_pair_terms needs dH's (m, m) blocks contiguous")
    lib = load_kernels()
    code = _PAIR_MODES[mode]
    if m > lib.berry_pairs_max_bands(d, code):
        raise ValueError(f"K21 takes at most {lib.berry_pairs_max_bands(d, code)} bands at d = {d} in mode "
                         f"{mode!r}, got {m}")
    eig = None if m == 2 else tuple(t.contiguous() for t in eigh_small(H))
    out = launch_pairs(lib, H, dH, eig, O, degtol, mode)
    if K:
        band_pair_terms.launches += 1
    return out


band_pair_terms.launches = 0


def launch_pairs(lib, H, dH, eig, O, degtol, mode):
    """One K21 launch on checked CUDA inputs: ``eig`` None for the closed
    form (m = 2), else the contiguous eigenpairs (e, U) of H. Returns the
    outputs of :func:`band_pair_terms`' mode. Counts no launch (the
    wrapper does)."""
    K, d, m = H.shape[0], dH.shape[1], H.shape[-1]
    dev = H.device
    e = torch.empty((K, m), dtype=REAL, device=dev)
    F1 = torch.empty((K, m, d, d), dtype=REAL, device=dev)
    F2 = torch.empty_like(F1) if mode == "curvature" else None
    vd = torch.empty((K, m, d), dtype=REAL, device=dev) if mode == "curvature" else None
    if K:
        ptr = lambda t: None if t is None else t.data_ptr()  # noqa: E731
        e_in, U_in = (None, None) if eig is None else eig
        stream = stream_handle(dev)
        check_launch(lib.berry_pairs_launch(H.data_ptr(), dH.data_ptr(), ptr(e_in), ptr(U_in), ptr(O), e.data_ptr(),
                                            F1.data_ptr(), ptr(F2), ptr(vd), K, d, m, dH.stride(0), dH.stride(1),
                                            float(degtol), _PAIR_MODES[mode], stream), "band_pair_terms")
    if mode == "metric":
        return F1
    if mode == "operator":
        return e, F1
    return e, F1, F2, vd


def _softplus(x):
    """``log(1 + e^x)`` as the reference's ``logaddexp(x, 0)``: ``max(x, 0) +
    log1p(e^-|x|)``, exact at every x (``torch.nn.functional.softplus``
    returns x above its threshold)."""
    return torch.clamp_min(x, 0.0) + torch.log1p(torch.exp(-x.abs()))


def zone_weights(e, mode, mu=0.0, beta=None):
    """The band weights of the reference's queries (``berry.py:487-490,
    505-507, 521-525, 606-610, 627-634``) at energies e: the step ``e <
    mu``; the Fermi function; the entropy ``softplus(x) - x sigmoid(x)``;
    ``-df/de = beta f (1 - f)``; the grand potential ``softplus(-x) / beta``
    (``max(mu - e, 0)`` at beta None); ones (``"band"``). x = beta (e - mu)."""
    if mode == "step":
        return (e < mu).to(REAL)
    if mode == "band":
        return torch.ones_like(e)
    if mode == "grand" and (beta is None or np.isinf(beta)):
        return torch.clamp_min(mu - e, 0.0)
    x = beta * (e - mu)
    if mode == "fermi":
        return fermi(x)
    if mode == "entropy":
        return _softplus(x) - x * torch.sigmoid(x)
    if mode == "dipole":
        f = fermi(x)
        return beta * f * (1 - f)
    return _softplus(-x) / beta


def _occupation(beta):
    """The occupation's weight mode: the step at zero temperature (beta None
    or inf, the limit of the reference's ``fermi(beta (e - mu))``), else
    the Fermi function."""
    return "step" if beta is None or beta == np.inf else "fermi"


def zone_average_plain(e, F, mode, mu=0.0, beta=None, vd=None):
    """Plain PyTorch version of K24, the reference's zone means
    (``berry.py:467-468, 478, 525``): ``mean_k sum_n w F`` (F.shape[2:]),
    with ``vd`` the dipole's (d, *F.shape[2:]), per band without the band
    sum (``"band"``, (m, *F.shape[2:]))."""
    if mode == "band":
        return F.mean(dim=0)
    w = zone_weights(e, mode, mu, beta)
    if mode == "dipole":
        return torch.einsum("kn,kna,knbc->kabc", w, vd, F).mean(dim=0)
    return torch.einsum("km,kmab->kab", w, F).mean(dim=0)


def zone_average(e, F, mode, mu=0.0, beta=None, vd=None):
    """Occupation-weighted zone mean of a band field: energies e (K, m) and
    F (K, m, d, d) float64 give ``X = mean_k sum_n w(e_kn) F_kn`` (d, d) for
    the weight ``mode`` of :func:`zone_weights` (``"step"``, ``"fermi"``,
    ``"entropy"``, ``"grand"``), ``mean_k sum_n w vd_kn,a F_kn`` (d, d, d)
    for ``"dipole"`` (vd (K, m, d)), and the per-band mean (m, d, d) for
    ``"band"``. ``beta`` None means zero temperature (the step, or the grand
    potential's ``max(mu - e, 0)``).

    CPU tensors take the plain version; CUDA tensors launch K24
    (``csrc/zone_average.cu``), and anything the kernel does not take
    raises."""
    check_tensor(e, "e", dtype=REAL, ndim=2)
    K, m = e.shape
    check_tensor(F, "F", device=e.device, dtype=REAL, shape=(K, m))
    if F.ndim != 4 or F.shape[2] != F.shape[3]:
        raise ValueError(f"zone_average takes a field F (K, m, d, d), got {tuple(F.shape)}")
    if mode not in _AVERAGE_MODES:
        raise ValueError(f"mode must be one of {tuple(_AVERAGE_MODES)}, got {mode!r}")
    d = F.shape[2]
    if mode == "dipole":
        if not isinstance(vd, torch.Tensor):
            raise ValueError("mode 'dipole' needs the band velocities vd (K, m, d)")
        check_tensor(vd, "vd", device=e.device, dtype=REAL, ndim=3, shape=(K, m, d))
    if mode in ("fermi", "entropy", "dipole") and (beta is None or not np.isfinite(beta)):
        raise ValueError(f"mode {mode!r} needs a finite beta")
    if K == 0:
        raise ValueError("zone_average needs at least one point")
    mu = float(mu)
    beta = None if beta is None else float(beta)
    if e.device.type == "cpu":
        return zone_average_plain(e, F, mode, mu, beta, vd)
    if e.device.type != "cuda":
        raise ValueError(f"zone_average runs on cpu or cuda tensors, got {e.device}")
    lib = load_kernels()
    lead = {"band": (m,), "dipole": (d,)}.get(mode, ())
    C = d * d
    out = torch.empty(lead + (d, d), dtype=REAL, device=e.device)
    card = torch.cuda.current_device() if e.device.index is None else e.device.index
    rows = lib.zone_average_num_rows(K, m, C, d, _AVERAGE_MODES[mode], card)
    if rows < 1:
        raise RuntimeError(f"zone_average: the card refuses the kernel's shared memory at m = {m}, d = {d}")
    partials = torch.empty((rows, out.numel()), dtype=REAL, device=e.device)
    stream = stream_handle(e.device)
    check_launch(lib.zone_average_launch(e.data_ptr(), F.data_ptr(), None if vd is None else vd.data_ptr(), K, m, C,
                                         d, _AVERAGE_MODES[mode], mu, np.inf if beta is None else beta, rows,
                                         partials.data_ptr(), out.data_ptr(), stream), "zone_average")
    zone_average.launches += 1
    return out


zone_average.launches = 0


def _check_frames(V, name):
    check_tensor(V, name, dtype=COMPLEX, ndim=4)
    n1, n2, m, nb = V.shape
    if min(n1, n2, m, nb) < 1 or nb > m:
        raise ValueError(f"{name} must be frames (n1, n2, m, nb) with 1 <= nb <= m, got {tuple(V.shape)}")
    if nb > MAX_LINK_BANDS:
        raise ValueError(f"the link kernels take at most {MAX_LINK_BANDS} occupied bands, got {nb}")
    return n1, n2, m, nb


def _links(Va, Vb):
    return torch.einsum("xyim,xyin->xymn", Va.conj(), Vb)


def plaquette_flux_plain(V):
    """Plain PyTorch version of K22, the reference's FHS field sum
    (``berry.py:314-333``): link determinants, normalised, the plaquette
    loop's ``-angle`` summed over the grid. Returns a 0-dim float64 tensor."""
    def link(Va, Vb):
        det = torch.linalg.det(_links(Va, Vb))
        return det / det.abs()

    Lx = link(V, torch.roll(V, -1, 0))
    Ly = link(V, torch.roll(V, -1, 1))
    F = -torch.angle(Lx * torch.roll(Ly, -1, 0) * torch.roll(Lx, -1, 1).conj() * Ly.conj())
    return torch.sum(F)


def plaquette_flux(V):
    """The Fukui-Hatsuda-Suzuki plaquette field of the occupied-band frames
    V (n1, n2, m, nb) complex128 (contiguous) of a periodic 2-D grid, summed
    over the n1 n2 plaquettes: a 0-dim float64 tensor, 2 pi times the
    lattice Chern number. At most :data:`MAX_LINK_BANDS` occupied bands.

    CPU tensors take the plain version; CUDA tensors launch K22
    (``csrc/berry_links.cu``), and anything the kernel does not take
    raises."""
    n1, n2, m, nb = _check_frames(V, "V")
    if V.device.type == "cpu":
        return plaquette_flux_plain(V)
    if V.device.type != "cuda":
        raise ValueError(f"plaquette_flux runs on cpu or cuda tensors, got {V.device}")
    lib = load_kernels()
    partials = torch.empty(lib.plaquette_flux_num_chunks(n1, n2), dtype=REAL, device=V.device)
    out = torch.empty((), dtype=REAL, device=V.device)
    stream = stream_handle(V.device)
    check_launch(lib.plaquette_flux_launch(V.data_ptr(), n1, n2, m, nb, partials.data_ptr(), out.data_ptr(), stream),
                 "plaquette_flux")
    plaquette_flux.launches += 1
    return out


plaquette_flux.launches = 0


def wilson_loops_plain(V):
    """Plain PyTorch version of K23, the reference's loops
    (``berry.py:375-385``): links along k1, then their ordered product over
    k1 for each k2 row. Returns (n2, nb, nb) complex128."""
    L = _links(V, torch.roll(V, -1, 0))
    nb = V.shape[-1]
    W = torch.eye(nb, dtype=V.dtype, device=V.device).expand(V.shape[1], nb, nb)
    for x in range(V.shape[0]):
        W = W @ L[x]
    return W


def wilson_loops(V):
    """The Wilson loops around k1 of the occupied-band frames V (n1, n2, m,
    nb) complex128 (contiguous): ``W(y) = prod_x V(x, y)^H V(x + 1, y)``,
    ordered along k1, for each of the n2 rows; (n2, nb, nb) complex128.

    CPU tensors take the plain version; CUDA tensors launch K23
    (``csrc/berry_links.cu``), and anything the kernel does not take
    raises."""
    n1, n2, m, nb = _check_frames(V, "V")
    if V.device.type == "cpu":
        return wilson_loops_plain(V)
    if V.device.type != "cuda":
        raise ValueError(f"wilson_loops runs on cpu or cuda tensors, got {V.device}")
    lib = load_kernels()
    out = torch.empty((n2, nb, nb), dtype=COMPLEX, device=V.device)
    stream = stream_handle(V.device)
    check_launch(lib.wilson_loops_launch(V.data_ptr(), n1, n2, m, nb, out.data_ptr(), stream), "wilson_loops")
    wilson_loops.launches += 1
    return out


wilson_loops.launches = 0


def berry_pack(h, bz, npt, degtol=1e-8, pairs=band_pair_terms) -> BerryPack:
    """Evaluate (H, dH) on the full npt^d grid in row slabs, and build the
    band energies, curvature, moment and velocities with K21 (``pairs``,
    or its plain version). ``degtol``: band pairs closer than this are
    dropped from the Kubo sums (at an exact crossing only the total over the
    degenerate subspace is meaningful, and that is what a filled-band sum
    reproduces)."""
    _require_full_zone(bz, "BerryCurvatureSolver")
    d = bz.ndim
    e, Om, Mm, vd = _slab_map(h, npt, d, lambda hk, vk: pairs(hk, vk, degtol))
    return BerryPack(e, Om, Mm, vd, d, npt)


def berry_flux_integrand(h, degtol=1e-8):
    """The occupied-band Berry flux ``sum_{e_n < mu} Omega^frac_n,12(k)`` as
    a :class:`~autobzcore_torch.fourier.FourierIntegrand` over a
    :class:`~autobzcore_torch.fourier.JacobianSeries`, so that Chern
    numbers and anomalous Hall integrals flow through the solve pipeline
    (PTR, IAI, EvalCounter). ``mu`` is a solve-time parameter; over a
    full-zone 2-D BZ ``solve(IntegralProblem(fi, bz, mu), alg).u = |det B| 2
    pi C_occ``.

    The integrand takes whole batches of points (``batched=True``): each
    PTR rule and IAI leaf trip is one call of :func:`band_pair_terms` (K21
    on the card, curvature mode, the (0, 1) component), then the occupied
    bands' sum. ``mu`` is one value, or one per point (a sweep solves a
    fixed rule's lanes one by one)."""
    from ..fourier import FourierIntegrand, JacobianSeries

    def flux(v, mu=None):
        H, V = v.s
        m, d = H.shape[-1], V.shape[-3]
        batch = tuple(H.shape[:-2])
        e, Om, _, _ = band_pair_terms(H.reshape(-1, m, m).contiguous(), V.reshape(-1, d, m, m), degtol)
        e, Om = e.reshape(batch + (m,)), Om[:, :, 0, 1].reshape(batch + (m,))
        mu = torch.as_tensor(mu, dtype=REAL, device=e.device)
        if mu.ndim and tuple(mu.shape) != batch:
            raise ValueError(f"the flux takes one mu, or one per point {batch}, got {tuple(mu.shape)}")
        occ = (e < mu[..., None]).to(Om.dtype)
        return torch.sum(occ * Om, dim=-1)

    return FourierIntegrand(flux, JacobianSeries(h), batched=True)


def _frames(h, u, bands):
    """The occupied-band eigenvectors (n1, n2, m, nb) of H on the grid u[0]
    x u[1], by ``eigh_small``; ``bands`` default to the lower half."""
    _, U = eigh_small(evaluate_grid(h.c, 2, u, h.offset, h.period))
    m = U.shape[-1]
    idx = list(range(m // 2)) if bands is None else [int(b) for b in bands]
    return U[..., idx].contiguous()


def lattice_chern(h, bz, npt, bands=None):
    """Gauge-invariant lattice Chern number by plaquette Wilson loops
    (Fukui-Hatsuda-Suzuki, J. Phys. Soc. Jpn. 74, 1674 (2005)): an integer
    to rounding on any grid fine enough that every plaquette flux is below
    pi, and a degenerate multiband set through the link determinant.
    ``bands``: the band indices of the (gapped) set, the lower half by
    default. K22 on the card; returns a float."""
    _require_full_zone(bz, "lattice_chern")
    if bz.ndim != 2:
        raise ValueError("lattice_chern is defined for 2D zones")
    u = [np.arange(npt) / npt * h.period[j] for j in range(2)]
    return float(plaquette_flux(_frames(h, u, bands))) / (2 * np.pi)


def wilson_loop_spectrum(h, npt, bands=None, nloop=None):
    """Hybrid Wannier centre flow: the eigenphases of the non-Abelian Wilson
    loop around the k1 circle as a function of k2, (nk2, nb) in [-1/2, 1/2)
    (units of a1), sorted per row. ``npt``: the loop's points along k1;
    ``nloop``: the k2 rows (npt by default); ``bands``: the lower half by
    default. The loops by K23 on the card; the eigenvalues of the (n2, nb,
    nb) matrices on the host (numpy), as the reference."""
    n2 = npt if nloop is None else int(nloop)
    u = [np.arange(npt) / npt * h.period[0], np.arange(n2) / n2 * h.period[1]]
    W = wilson_loops(_frames(h, u, bands))
    lam = np.linalg.eigvals(W.cpu().numpy())
    th = np.angle(lam) / (2 * np.pi)
    return np.sort(th, axis=-1)


def z2_invariant(h, npt=48, bands=None, nloop=None):
    """Time-reversal Z2 invariant from the Wannier-centre flow over half the
    zone (Yu-Qi-Bernevig-Dai-Fang largest-gap tracking, PRB 84, 075119
    (2011)): follow the midpoint of the largest gap between sorted centres
    from k2 = 0 to k2 = 1/2 and count centre crossings mod 2. For
    time-reversal-symmetric models with an even occupied set; returns 0 or
    1 (host numpy, the reference's ``berry.py:401-441``)."""
    n2 = npt if nloop is None else int(nloop)
    if n2 % 2:
        n2 += 1
    th = np.asarray(wilson_loop_spectrum(h, npt, bands=bands, nloop=n2))
    if th.shape[1] % 2:
        raise ValueError(
            "z2_invariant needs an even occupied set (Kramers pairs); got "
            f"{th.shape[1]} bands — pass bands=[...] explicitly")
    half = th[: n2 // 2 + 1]  # k2 in [0, 1/2]

    def gap_center(row):
        ext = np.concatenate([row, [row[0] + 1.0]])
        gaps = np.diff(ext)
        j = int(np.argmax(gaps))
        gc = ext[j] + gaps[j] / 2
        return (gc + 0.5) % 1.0 - 0.5

    crossings = 0
    g = gap_center(half[0])
    for i in range(1, len(half)):
        g2 = gap_center(half[i])
        d_end = (g2 - g) % 1.0
        if d_end <= 0.5:
            lo, span = g, d_end
        else:  # moved the short way backwards
            lo, span = g2, 1.0 - d_end
        for x in half[i]:
            if 0 < (x - lo) % 1.0 <= span:
                crossings += 1
        g = g2
    return crossings % 2


class BerryCurvatureSolver:
    """Reusable Berry-curvature observables over one cached (H, dH) grid.

    >>> slv = BerryCurvatureSolver(h, load_bz(FBZ(), np.eye(2)), npt=120)
    >>> slv.chern()                  # per-band Chern numbers (2D)
    >>> slv.ahc(mu=0.0, beta=None)   # I_ab; sigma_ab = -(e^2/hbar) I_ab

    ``pack``: a :class:`BerryPack` to query (e.g. one carried over from the
    JAX package by ``interop.berry_pack_from_arrays``). ``pairs`` and
    ``average``: K21 and K24 (``band_pair_terms``, ``zone_average``) or
    their plain versions. Queries return numpy; the pack's tensors stay on
    the series' device.
    """

    def __init__(self, h, bz, npt, degtol=1e-8, pack=None, pairs=band_pair_terms, average=zone_average):
        if pack is None:
            pack = berry_pack(h, bz, npt, degtol=degtol, pairs=pairs)
        self.pack = pack
        self.bz = bz
        self._h = h
        self._pairs = pairs
        self._average = average
        B = np.asarray(bz.B, dtype=np.float64)
        self._Binv = np.linalg.inv(B)
        self._detB = float(np.linalg.det(B))
        self._metric = None
        self._op_cache = {}

    def _norm(self):
        return abs(self._detB) / (2 * np.pi) ** self.pack.ndim

    def _cart_average(self, mode, field, mu=0.0, beta=None, e=None):
        """``|det B|/(2pi)^d * B^-T [mean_k sum_n w_kn field_kn,ab] B^-1``: one
        K24 launch, then the host tail in float64."""
        X = self._average(self.pack.e if e is None else e, field, mode, mu, beta).cpu().numpy()
        return self._norm() * (self._Binv.T @ X @ self._Binv)

    def chern(self):
        """Per-band Chern numbers (2D only): ``(1/2pi) mean_u Omega^frac_12``
        (m,). Integers (to grid accuracy) whenever the band is isolated."""
        p = self.pack
        if p.ndim != 2:
            raise ValueError("chern() is defined for 2D zones")
        return self._average(p.e, p.Om, "band").cpu().numpy()[:, 0, 1] / (2 * np.pi)

    def ahc(self, mu=0.0, beta=None):
        """Dimensionless intrinsic anomalous Hall integral ``I_ab = int
        d^dk/(2pi)^d sum_n f(e_n) Omega^cart_n,ab`` (``sigma_ab =
        -(e^2/hbar) I_ab``); ``beta=None`` (or ``inf``) is zero temperature."""
        return self._cart_average(_occupation(beta), self.pack.Om, mu, beta)

    def anomalous_nernst(self, mu=0.0, beta=50.0):
        """Anomalous Nernst integral ``N_ab = int d^dk/(2pi)^d sum_n s_n(k)
        Omega^cart_n,ab`` with the entropy density ``s(x) = softplus(x) - x
        sigmoid(x)`` (Xiao-Yao-Fang-Niu, PRL 97, 026603 (2006));
        ``alpha_ab = (k_B e/hbar) N_ab``."""
        return self._cart_average("entropy", self.pack.Om, mu, beta)

    def berry_curvature_dipole(self, mu=0.0, beta=50.0):
        """Berry curvature dipole (Sodemann-Fu, PRL 115, 216806 (2015)) in
        the Fermi-surface form ``D_{a;bc} = int d^dk/(2pi)^d sum_n
        (-df/de)(e_n) v_a,n Omega_n,bc``; (d, d, d) Cartesian."""
        p = self.pack
        Dfrac = self._average(p.e, p.Om, "dipole", mu, beta, vd=p.vd).cpu().numpy()
        Bi = self._Binv
        return self._norm() * np.einsum("ia,jb,kc,ijk->abc", Bi, Bi, Bi, Dfrac)

    def _slab_build(self, fn):
        h, p = self._h, self.pack
        if h is None:
            raise ValueError("this query rebuilds the grid: construct the solver with its series")
        return _slab_map(h, p.npt, p.ndim, fn)

    def quantum_metric(self, degtol=1e-8):
        """Band-resolved quantum metric ``g_n,ab(k) = sum_{m != n}
        Re[v_a,nm v_b,mn] / (e_n - e_m)^2`` in fractional coordinates (K, m,
        d, d), a tensor on the pack's device, built once per ``degtol`` (K21's
        metric mode) and cached."""
        if self._metric is not None and self._metric[0] == degtol:
            return self._metric[1]
        (g,) = self._slab_build(lambda hk, vk: (self._pairs(hk, vk, degtol, "metric"),))
        self._metric = (degtol, g)
        return g

    def operator_hall(self, O, mu=0.0, beta=None, degtol=1e-8):
        """Operator-resolved intrinsic Hall integral (the spin Hall
        conductivity for ``O = s_z``): ``I^O_ab = int d^dk/(2pi)^d sum_n
        f(e_n) Omega^O_n,ab`` with ``Omega^O`` the curvature of the
        symmetrized operator current ``J^O_a = (O v_a + v_a O)/2``. ``O``:
        an (m, m) Hermitian matrix in the orbital basis. The O-weighted grid
        is built on first use per operator (K21's operator mode) and cached
        on the operator's bytes."""
        Oarr = np.asarray(O)
        key = (Oarr.tobytes(), Oarr.shape, Oarr.dtype.str, float(degtol))
        if key not in self._op_cache:
            Ot = torch.as_tensor(Oarr.astype(np.complex128), device=self.pack.e.device).contiguous()
            self._op_cache[key] = self._slab_build(lambda hk, vk: self._pairs(hk, vk, degtol, "operator", Ot))
        e, OmO = self._op_cache[key]
        return self._cart_average(_occupation(beta), OmO, mu, beta, e=e)

    def orbital_magnetization(self, mu=0.0, beta=None):
        """Intrinsic orbital magnetization tensor ``M_ab`` (antisymmetric; in
        2D the scalar is ``M[0, 1]``), in units e/hbar, from the modern
        k-space theory: ``M = int d^dk/(2pi)^d sum_n [f_n m_n + (1/beta) ln(1
        + e^{-beta (e_n - mu)}) Omega_n]``, the grand-potential term
        ``(mu - e_n) theta(mu - e_n)`` at ``beta=None`` (or ``inf``). Inside
        a Chern gap ``dM_xy/dmu = sign(det B) C_occ / (2 pi)`` (Streda)."""
        p = self.pack
        return self._cart_average(_occupation(beta), p.Mm, mu, beta) + self._cart_average("grand", p.Om, mu, beta)


def certified_berry(h, bz, what="chern", abstol=1e-3, reltol=0.0, nmin=24, nmax=480, factor=2**0.5, degtol=1e-8,
                    pairs=band_pair_terms, average=zone_average, **obs_kwargs):
    """Richardson-certified Berry observable against the k-grid: run
    ``BerryCurvatureSolver(h, bz, npt).<what>(**obs_kwargs)`` on the
    rate-fitted npt ladder of ``models.observables.certified_ladder`` until
    the whole returned array is grid-converged. ``what``: ``"chern"``,
    ``"ahc"``, ``"anomalous_nernst"``, ``"berry_curvature_dipole"`` or
    ``"orbital_magnetization"``. Returns a ``CertifiedSweep``; ``retcode``
    False when ``nmax`` is reached first. ``pairs`` and ``average``: K21 and
    K24 or their plain versions."""
    from .observables import certified_ladder

    def eval_at(npt):
        slv = BerryCurvatureSolver(h, bz, int(npt), degtol=degtol, pairs=pairs, average=average)
        return getattr(slv, what)(**obs_kwargs)

    return certified_ladder(eval_at, abstol, reltol, nmin, nmax, factor)
