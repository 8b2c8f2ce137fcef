"""Kinetic coefficients, optical conductivity and electron counting
(reference ``autobzcore_tpu/models/transport.py``).

The spectral velocity pack (``models.observables.spectral_velocity_pack``,
kernels K11 and K18) builds once; each GK trip of a frequency integral is
one launch of kernel K19 (``models.observables.transport_gamma``) over all
of the trip's live nodes, whatever lane they belong to, through the
pool's batched-integrand form (``algorithms.gk``); the Fermi window, the
``(beta (w - mu))^alpha`` moment and the group average are elementwise
torch operations on the (N, d, d) node batch. ``ElectronCountSolver``
counts bands with kernel K20 (``fermi_count``, ``csrc/fermi_count.cu``),
one launch and one host read per ``find_mu`` bisection step; its cheap
build runs K1 at the representatives and K9 (m <= 3) or chunked
``eigvalsh`` (m > 3).

``alpha=0`` is the optical conductivity kernel sigma(Omega); ``Omega=0``
uses the analytic window limit ``-f'(w)``.
"""
from __future__ import annotations

import math

import numpy as np
import torch

from .._device import REAL, check_tensor
from ..ops.cuda_lib import check_launch, load_kernels, stream_handle
from ..wrappers import BatchIntegrand
from .observables import group_average, transport_gamma


def _real(x, like=None):
    """``x`` as a float64 tensor (on ``like``'s device where given and ``x``
    is not a tensor)."""
    if isinstance(x, torch.Tensor):
        return x.to(REAL)
    return torch.as_tensor(np.asarray(x, dtype=np.float64),
                           device=None if like is None else like.device)


def fermi(x):
    """Fermi function of the reduced variable ``x = beta (w - mu)``,
    ``1 / (1 + e^x)``, the stable sigmoid (no overflow at large |x|)."""
    return torch.sigmoid(-_real(x))


def fermi_window(w, Omega, beta, mu=0.0):
    """``(f(w) - f(w + Omega)) / Omega`` with the analytic ``Omega -> 0``
    limit ``-f'(w)``, in the reference's product form
    ``beta * [-expm1(-a) / a] * sigmoid(-x) * sigmoid(x + a)``, x = beta (w
    - mu), a = beta Omega: no difference of Fermi functions, so no
    cancellation at small beta Omega, and the limit is the same expression.
    Positive, and integrates to 1 over the real line for every Omega."""
    w = _real(w)
    x = beta * (w - mu)
    a = beta * _real(Omega, like=w)
    safe = torch.where(a == 0, 1.0, a)
    prefac = torch.where(a == 0, 1.0, -torch.expm1(-safe) / safe)
    return beta * prefac * torch.sigmoid(-x) * torch.sigmoid(x + a)


def fermi_window_limits(Omega, beta, mu=0.0, wtol=1e-10):
    """Truncation interval ``(lo, hi)`` outside which the window is below
    ``wtol`` times its peak: ``t = log(1/wtol) / beta`` of padding around
    the plateau ``[mu - Omega, mu]`` (host numbers)."""
    if beta <= 0 or not np.isfinite(beta):
        raise ValueError(
            "beta must be positive and finite: the fermi window degenerates "
            "to a zero-width interval at zero temperature (use a large finite "
            "beta; ElectronCountSolver alone supports beta=inf)")
    t = float(np.log(1.0 / wtol)) / float(beta)
    Om = float(Omega)
    lo, hi = min(mu - Om, mu), max(mu - Om, mu)
    return lo - t, hi + t


def _eigenvalue_grid(h, bz, npt):
    """Eigenvalues (K, m) float64 on the series' device and orbit weights
    (numpy) on the (symmetry-reduced) npt^d grid: the cheap build for band
    sums, K1 at the representatives, then K9 for m <= 3 or chunked
    ``eigvalsh`` for m > 3 (``ops.eigh3.eigvalsh_small``)."""
    from ..ops.eigh3 import eigvalsh_small
    from .observables import gathered_grid, reduced_grid, series_bands

    d = bz.ndim
    lin, weights, u, _, _ = reduced_grid(bz, npt, h.period)
    m = series_bands(h)
    hk = gathered_grid(h, d, u, lin).reshape(-1, m, m)
    return eigvalsh_small(hk), weights


class KineticCoefficientSolver:
    """``KineticCoefficientSolver(h, bz, npt, eta, beta, alpha=0, mu=0.0)``:
    the kinetic coefficient of order ``alpha`` at photon frequency Omega,

        A_alpha(Omega) = int dw (beta (w - mu))^alpha fermi_window(w, Omega)
                           * Gamma(w, w + Omega),

    with Gamma_ab the Kubo-Greenwood transport distribution over ``bz``
    (Lorentzian broadening ``eta``, inverse temperature ``beta``, chemical
    potential ``mu``). The pack builds once; each call runs one adaptive
    Gauss-Kronrod frequency integral per Omega, every trip's nodes in one
    K19 launch. Returns (W, d, d) float64 numpy; ``retcode`` and ``numevals``
    hold the last call's certificate and the accumulated evaluations.

    ``self_energy``: a scalar self-energy Sigma(w) with Im Sigma < 0, called
    on the (N,) float64 node tensor and returning N complex values (or one);
    the band spectral function becomes ``-Im[1 / (w - Sigma(w) - e_n)] /
    pi`` (``Sigma = -i eta`` gives the default). ``pack``: a
    :class:`~autobzcore_torch.models.observables.SpectralPack` to share.
    Computes on the pack's device (the series' device). ``gamma``: the
    contraction each trip calls, K19 (``transport_gamma``) or its plain
    version ``transport_gamma_plain`` (the comparison of the two routes on
    the card). At Omega = 0 the integrand hands it the same node tensors
    twice, which K19 reads as equal frequencies.
    """

    def __init__(self, h, bz, npt, eta, beta, alpha=0, mu=0.0, order=7, cap=256, wtol=1e-10,
                 self_energy=None, pack=None, gamma=transport_gamma):
        from .observables import spectral_velocity_pack

        if not isinstance(alpha, (int, np.integer)) or alpha < 0:
            raise ValueError("alpha must be a small non-negative integer")
        self.eta = float(eta)
        self.beta = float(beta)
        self.alpha = int(alpha)
        self.mu = float(mu)
        self.order = order
        self.cap = cap
        self.wtol = float(wtol)
        self.d = bz.ndim
        self.numevals = 0
        self.retcode = None  # set by __call__/sweep
        self.stats = None    # the last solve's LoopStats: GK trips and host syncs
        if pack is None:
            pack = spectral_velocity_pack(h, bz, npt)
        self.pack = pack
        self.device = pack.e.device
        self.self_energy = self_energy
        self._gamma = gamma

    def _spectral_args(self, w):
        """(y, g) of nodes w (N,): the shifted frequency and the width."""
        if self.self_energy is None:
            return w, torch.full_like(w, self.eta)
        sig = self.self_energy(w)
        if isinstance(sig, torch.Tensor):
            sig = sig.to(device=w.device, dtype=torch.complex128)
        else:  # a Python or numpy number: complex128, never torch's default complex64
            sig = torch.as_tensor(np.asarray(sig, dtype=np.complex128), device=w.device)
        y = w - sig.real.to(REAL)
        g = -sig.imag.to(REAL)
        return y.expand(w.shape).contiguous(), g.expand(w.shape).contiguous()

    def _integrand(self, w, Omega):
        """The integrand at nodes w (N,) (or one node) with photon
        frequencies Omega (one, or one per node): (N, d, d) (or (d, d))."""
        w = _real(w).to(self.device)
        scalar = w.ndim == 0
        w = w.reshape(-1)
        Om = _real(Omega, like=w).to(self.device).expand(w.shape)
        y1, g1 = self._spectral_args(w.contiguous())
        if isinstance(Omega, torch.Tensor) or np.any(Omega):
            y2, g2 = self._spectral_args((w + Om).contiguous())
        else:  # Omega = 0: Gamma(w, w), the same tensors (K19's equal frequencies)
            y2, g2 = y1, g1
        pk = self.pack
        G = self._gamma(pk.e, pk.Wmat, y1, g1, y2, g2, pk.scale).reshape(-1, self.d, self.d)
        G = group_average(G, pk.Savg)
        win = fermi_window(w, Om, self.beta, self.mu)
        mom = (self.beta * (w - self.mu)) ** self.alpha if self.alpha else 1.0
        out = (mom * win)[:, None, None] * G
        return out[0] if scalar else out

    def _wtol_eff(self):
        """Truncation tolerance inflated for the (beta w)^alpha moment:
        ``wtol / L^alpha``, L = ln(1/wtol)."""
        if self.alpha == 0:
            return self.wtol
        L = max(1.0, np.log(1.0 / self.wtol))
        return self.wtol / L**self.alpha

    def _alg(self):
        from ..algorithms.gk import QuadGKJL

        return QuadGKJL(order=self.order, cap=self.cap, device=self.device)

    def __call__(self, Omegas, abstol=1e-6, reltol=None, maxiters=None):
        from ..interfaces import IntegralProblem, init, solve_

        Omegas = np.atleast_1d(np.asarray(Omegas, np.float64))
        if np.all(Omegas >= 0):
            return self.sweep(Omegas, abstol=abstol, reltol=reltol, chunk=8)
        out = np.zeros((len(Omegas), self.d, self.d))
        ok = True
        wtol = self._wtol_eff()
        for i, Om in enumerate(Omegas):
            lo, hi = fermi_window_limits(Om, self.beta, self.mu, wtol)
            cache = init(IntegralProblem(BatchIntegrand(self._integrand), lo, hi, float(Om)), self._alg(),
                         abstol=abstol, reltol=reltol, maxiters=maxiters)
            sol = solve_(cache)
            self.stats = cache.cacheval["stats"]
            ok = ok and bool(sol.retcode)
            self.numevals += int(sol.numevals) if sol.numevals > 0 else 0
            out[i] = sol.u.cpu().numpy()
        self.retcode = ok
        return out

    def sweep(self, Omegas, abstol=1e-6, reltol=None, chunk=8, mesh=None):
        """All Omegas over the shared window interval ``[mu - max(Omega) - t,
        mu + t]``, ``chunk`` frequencies at a time as independent lanes of one
        batched pool (the reference's scan-swept ``SweepSolver(scan=True)``);
        each GK trip of a chunk is one K19 launch over its live nodes.
        ``mesh`` raises (ROADMAP A10). Returns (W, d, d)."""
        from ..interfaces import IntegralProblem
        from ..parallel.sweep import SweepSolver

        Omegas = np.atleast_1d(np.asarray(Omegas, np.float64))
        if np.any(Omegas < 0):
            raise ValueError("photon frequencies must be >= 0")
        wtol = self._wtol_eff()
        lo, _ = fermi_window_limits(float(Omegas.max()), self.beta, self.mu, wtol)
        _, hi = fermi_window_limits(0.0, self.beta, self.mu, wtol)
        if np.any(Omegas):
            integrand = self._integrand
        else:  # every Omega 0: the scalar 0, so that K19 takes equal frequencies
            def integrand(w, _):
                return self._integrand(w, 0.0)
        prob = IntegralProblem(BatchIntegrand(integrand), lo, hi)
        solver = SweepSolver(prob, self._alg(), abstol=abstol, reltol=reltol,
                             chunk=min(chunk, max(1, len(Omegas))), scan=True, mesh=mesh)
        out = solver(Omegas)
        self.numevals += int(solver.numevals)
        self.retcode = solver.retcode
        self.stats = solver.stats
        return np.asarray(out)


def optical_conductivity(h, bz, npt, eta, beta, Omegas, mu=0.0, abstol=1e-6):
    """One-shot optical-conductivity kernel sweep ``sigma_ab(Omega)``
    (:class:`KineticCoefficientSolver` with ``alpha=0``); warns if any
    frequency integral failed to certify."""
    import warnings

    slv = KineticCoefficientSolver(h, bz, npt, eta, beta, alpha=0, mu=mu)
    out = slv(Omegas, abstol=abstol)
    if not slv.retcode:
        warnings.warn("optical_conductivity: at least one frequency integral "
                      "did not converge to abstol; build the solver directly "
                      "to inspect retcode/numevals", stacklevel=2)
    return out


def fermi_count_plain(e, w, mu, beta):
    """Plain PyTorch version of K20, the reference's reduction
    ``sum(w[:, None] * occ)`` with occ = sigmoid(-beta (e - mu)), or the
    step (e - mu < 0) at beta = inf. Returns a 0-dim float64 tensor."""
    x = e - mu
    occ = (x < 0).to(REAL) if math.isinf(beta) else fermi(beta * x)
    return torch.sum(w[:, None] * occ)


def fermi_count(e, w, mu, beta):
    """``sum_k w_k sum_b occ(e[k, b] - mu)`` for energies e (K, m) and
    weights w (K,) float64: occ = 1 / (1 + exp(beta x)) for finite beta,
    (x < 0) for beta = inf. Returns a 0-dim float64 tensor on e's device.

    CPU tensors take the plain version; CUDA tensors launch K20
    (``csrc/fermi_count.cu``), and anything the kernel does not take
    raises."""
    check_tensor(e, "e", dtype=REAL, ndim=2)
    K, m = e.shape
    check_tensor(w, "w", device=e.device, dtype=REAL, ndim=1, shape=(K,))
    mu, beta = float(mu), float(beta)
    if e.device.type == "cpu":
        return fermi_count_plain(e, w, mu, beta)
    if e.device.type != "cuda":
        raise ValueError(f"fermi_count runs on cpu or cuda tensors, got {e.device}")
    lib = load_kernels()
    partials = torch.empty(max(lib.fermi_count_num_chunks(K, m), 1), dtype=REAL, device=e.device)
    out = torch.empty((), dtype=REAL, device=e.device)
    stream = stream_handle(e.device)
    check_launch(lib.fermi_count_launch(e.data_ptr(), w.data_ptr(), K, m, mu, beta, partials.data_ptr(),
                                        out.data_ptr(), stream), "fermi_count")
    fermi_count.launches += 1
    return out


fermi_count.launches = 0


class ElectronCountSolver:
    """``ElectronCountSolver(h, bz, npt, pack=None)``: band filling against
    the chemical potential, ``n(mu, beta) = (1 / npt^d) sum_k w_k sum_b
    f(beta (e_kb - mu))`` on the (symmetry-reduced) grid, electrons per cell
    in [0, nbands]; ``beta=inf`` gives the zero-temperature step. The sum
    runs over the orbit multiplicities and is divided by npt^d once (the
    reference divides the weights first), so whole bands count exactly. With a
    pack it reuses the pack's eigenvalues, normalized by the pack's own
    grid; without one the constructor runs the cheap eigenvalues-only build.
    Each query is one K20 launch and one host read on the card (``count``:
    K20, ``fermi_count``, or its plain version ``fermi_count_plain``)."""

    def __init__(self, h, bz, npt, pack=None, count=fermi_count):
        if pack is None:
            e, weights = _eigenvalue_grid(h, bz, npt)
            norm = float(npt**bz.ndim)
        else:
            # normalize by the pack's own grid (a mismatched npt argument
            # would silently rescale every filling)
            e, weights = pack.e, pack.weights
            norm = float(pack.npt**pack.ndim)
        self._e = e.contiguous()
        # the multiplicities themselves: sums of integers are exact, so a full
        # band counts 1 exactly after the one division by npt^d
        self._weights = torch.as_tensor(np.asarray(weights), dtype=REAL, device=e.device)
        self._norm = norm
        self._count = count
        self.nbands = int(e.shape[-1])

    def __call__(self, mu, beta):
        return float(self._count(self._e, self._weights, float(mu), float(beta))) / self._norm

    def find_mu(self, nu, beta, tol=1e-10, maxiter=200):
        """Chemical potential with filling ``nu`` electrons per cell: the
        reference's host bisection on the cached grid; raises if ``nu`` is
        outside (0, nbands)."""
        if not 0.0 < nu < self.nbands:
            raise ValueError(f"filling must lie in (0, {self.nbands})")
        emin = float(torch.min(self._e))
        emax = float(torch.max(self._e))
        pad = 1.0 if np.isinf(beta) else max(1.0, 40.0 / beta)
        lo, hi = emin - pad, emax + pad
        for _ in range(maxiter):
            mid = 0.5 * (lo + hi)
            if self(mid, beta) < nu:
                lo = mid
            else:
                hi = mid
            if hi - lo < tol:
                break
        return 0.5 * (lo + hi)
