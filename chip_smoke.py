#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port (``autobzcore_torch``) on one NVIDIA GPU.

Run from the repository root with no arguments:

    python3 chip_smoke.py

Phases, one or a few lines of output each (a failing phase ends the run
non-zero):

1. device: the card's name and power limit (nvidia-smi) and torch's name;
2. build: every CUDA kernel from ``autobzcore_torch/csrc`` with nvcc (one
   compiler per source, in parallel), timed;
3. kernels K1, K2: each against its plain PyTorch version on the card, in
   FP64, at stated tolerances; K2 run twice must be bit-identical; kernel
   and plain times at the flagship shapes (K = 1e6 points, W = 264), and
   K1's library time (``torch.matmul`` of the precomputed phases);
4. PTR main path: the flagship PTR leg at full width through the public
   entry points (synthetic 3-band series on the full zone, PTR(npt=100),
   eta = 0.05, SweepSolver(chunk=264) under hchebinterp over [-6, 7] eV,
   atol 1e-2), with K1/K2's launch counts, a sum-rule check of the
   interpolant and a check of D at 5 frequencies against the plain path;
5. cubic IBZ: tb_integer(3) on CubicSymIBZ against the full zone (PTR);
6. kernels K3, K4, K5: each against its plain version at the shapes of the
   IAI main path (33 frequencies: 990 mid and 29,700 leaf lanes), with
   kernel, plain and (K3) ``torch.matmul`` times;
7. IAI main path: the flagship cold IAI leg at full width,
   IAI(inner_cap=64, inner_nbisect=4) under SweepSolver(abstol=1e-3,
   chunk=33, scan=True) at 33 frequencies in [-6, 7] eV, eta = 0.05, with
   K3/K4/K5's launch counts, trips, host syncs and peak memory; checks: the
   retcode, 1 frequency against the same solve on the plain versions
   (within abstol) and all 33 against PTR(npt=400) (within 1e-2 max|D|);
8. cubic IBZ through IAI: tb_integer(3) on CubicSymIBZ against the full
   zone at 4 frequencies, eta = 0.1, abstol 1e-3 (within 2 abstol);
9. kernels K6 (coarsening) and K5's seed entry against their plain versions
   on the card: pools from phase 10's first call (the carried outer pool,
   cap 2048, and the harvest's mid pool, cap 64) and random dyadic pools;
   identical pools required; kernel and plain times. It runs between phase
   10's two calls, whose launch counts exclude it;
10. warm IAI main path: the flagship IAI leg as the reference runs it by
   default, IAI(inner_cap=64, inner_nbisect=4, warm_width=8) under
   SweepSolver(abstol=1e-3, chunk=33, scan=True, warm=True): call 1 at the
   33 frequencies of phase 7, call 2 at their 32 midpoints (the next
   interpolation frontier), seeded from the pools call 1 left; wall, evals
   against phase 7's cold chunk, trips, syncs, launches of K3-K6; checks:
   retcodes, values within 2 abstol of phase 7's, both calls against
   PTR(npt=400), and a 2-frequency warm chain on the plain versions against
   the kernels (identical counts and carried pools, values within abstol);
11. kernels K7 (fused eigenvalue + Lorentzian tail of a full-grid slab), K8
   (Lorentzian sum) and K9 (closed-form small eigenvalues), each against its
   plain version at the main path's shapes: K7 on one slab of the npt=400
   rung of phase 12 at 1024 omegas (bit-identical on repeat), K9 on the
   flagship's 1e6 matrices of the 100^3 grid (and numpy on a subsample), K8
   on their eigenvalues at 1000 omegas; kernel, plain and (K9) library times;
12. full-grid main path: the flagship's full-grid ladder at full width,
   LorentzianFullGrid(0.05, nmin=400, nmax=2000) over 1000 omegas in
   [-6, 7] eV, abstol 1e-3, through DOSProblem/init/dos_sweep; wall, rungs
   (npt, seconds, delta), evals, K7 launches, the stage products' time and
   peak memory; checks: the retcode, the npt=400 rung at phase 7's 33
   omegas against phase 7's PTR(npt=400) (within 1e-10 max|D|), a second
   sweep at the 999 midpoints replaying the certifying pair, and an npt=64
   rung through the plain tail against the kernel (1e-12);
13. bench lane: H(k) of the flagship on the 100^3 grid (``evaluate_grid``)
   and its eigenvalues by K9, k-points/s over 20 chained repetitions, then
   the 1000-omega Lorentzian sweep over [10, 15] eV at eta 0.01 by K8;
14. kernel K10 (the tetrahedron DOS and N(E)) against its plain version: the
   flagship's eigenvalue grid at npt=100, 1001 energies over [-6, 7] eV
   (the plain N(E) on a 64-energy subset), and d = 1, 2 at small shapes;
   max relative error <= 1e-12, bit-identical on repeat; kernel, plain and
   bound times;
15. LTM main path: the flagship LTM(npt=100) on the full zone through
   DOSProblem/init/dos_sweep at 1001 energies, nos_sweep, fermi_level(1.5);
   init and sweep walls, K10 launches, peak memory; checks: the band count
   of the DOS's integral (2e-2), N(7 eV) = 3 (1e-12), N monotone, dN/dE
   against D away from the band edges (5e-2), tb_integer(3) on CubicSymIBZ
   against the full zone (npt 60, E 0.8, 1e-12), 5 energies against the
   plain path (1e-12);
16. K4 over an omega block (W = 2, 4) and K5 at V = W against their plain
   versions at the IAI main path's lane shapes: 1e-12 of l1, identical
   pools; kernel and plain times;
17. omega-block IAI main path: phase 7's 33 frequencies, cold, under
   SweepSolver(abstol=1e-3, chunk=36, scan=True, block=W) at W = 2 and 4,
   three walls each beside phase 7's; evals per omega, trips, syncs, K4
   block launches, peak memory; checks: retcodes, values within 2 abstol
   of phase 7's, all 33 within 1e-2 max|D| of PTR(npt=400), and a
   2-frequency warm block chain on the plain versions against the kernels
   (identical counts and block certificates, values within abstol);
18. the repairs: the PTR leg of synthetic_wannier(4) at npt=60 over 264
   omegas through eigvalsh + K8 against the plain path (1e-10 relative),
   the route timed by events (cuSOLVER's share, K8's, the plain trace
   path's) beside its bound, and K2 with its grid capped at 7 block rows against the uncapped launch
   at 1e6 k-points, bit for bit.

With ``--profile``, the PTR, IAI, warm IAI, full-grid, LTM and block IAI
main paths each run once more under ``torch.profiler`` (after their checks),
which prints their device busy time, its share of the wall and the device
time of the leading kernels.

The second-to-last line is a JSON object with each kernel's numbers, the
last line ``{"ok": true, "device": {...}}``. Without CUDA, or without the
package beside it, the script exits non-zero and prints no result.
"""
import json
import math
import os
import subprocess
import sys
import time

ETA = 0.05
NPT = 100
W_FLAGSHIP = 264
WINDOW = (-6.0, 7.0)
IAI_OMEGAS = 33  # one SweepSolver chunk of the IAI leg
IAI_ABSTOL = 1e-3
# the least time the card could take: NVIDIA's data sheet for the H100 SXM
# at 700 W, FP64 outside the tensor cores (none of the kernels uses them)
PEAK_FP64 = 34e12
PEAK_BYTES = 3.35e12
# FP64 operations (an FMA counts 2) of Im Tr (z - H)^-1 by the closed forms
# of csrc/small_trace.cuh, per matrix: m = 1, 2, 3
TRACE_FLOPS = {1: 9, 2: 27, 3: 120}
# FP64 operations of one Lorentzian term eta / ((w - e)^2 + eta^2) summed
# with its weight (csrc/lorentzian.cuh): a subtraction (1), an FMA (2), the
# reciprocal, counted as the four DFMAs of its Newton sequence (8), and the
# FMA into the sum (2)
LORENTZ_FLOPS = 13
# FP64 operations of one closed-form 3x3 eigenvalue solve
# (csrc/small_eigen.cuh): ~60 multiplies and adds, a square root and three
# divisions at 8 each, and arccos and two cosines at ~40 each
EIG3_FLOPS = 210
FULLGRID_OMEGAS = 1000
FULLGRID_ABSTOL = 1e-3
FULLGRID_NMIN, FULLGRID_NMAX = 400, 2000  # the ladder; phase 7's PTR runs at FULLGRID_NMIN
FULLGRID_PLAIN_NPT = 64  # the rung held against the plain tail
LTM_ENERGIES = 1001
# FP64 operations of K10's work (csrc/tetra_dos.cu): the support test, two
# compares once for each (simplex, band) term (outside its support a term
# is a constant), and ~30 for each (energy, term) pair inside the support
# (the piece's compares, a dozen multiply-adds and a division counted as 8)
TETRA_TEST_FLOPS, TETRA_SUPPORT_FLOPS = 2, 30
BLOCKS = (2, 4)  # omega-block widths of phases 16-17
BLOCK_CHUNK = 36  # phase 17's SweepSolver chunk: 33 frequencies and their pads
BLOCK_WALL_RUNS = 3


def fail(msg):
    print(f"FAIL: {msg}", flush=True)
    sys.exit(1)


def cuda_ms(fn, reps):
    """Mean milliseconds of ``fn()`` over ``reps`` runs, by CUDA events,
    after one warm-up run."""
    import torch

    fn()
    torch.cuda.synchronize()
    start, stop = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(reps):
        fn()
    stop.record()
    torch.cuda.synchronize()
    return start.elapsed_time(stop) / reps


def profile(label, fn):
    """Run ``fn()`` under torch.profiler and print the device busy time (the
    sum of kernel and copy times on the one stream), its share of the wall
    and the leading kernels by device time."""
    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity
    from torch.profiler import profile as tprofile

    torch.cuda.synchronize()
    with tprofile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
    avgs = prof.key_averages()
    # device-side events only: an aten op's own row repeats its kernels' time
    dev_rows = [e for e in avgs if getattr(e, "device_type", None) == DeviceType.CUDA]
    rows = [(e.key, e.count, e.self_device_time_total)
            for e in (dev_rows or [e for e in avgs if not e.key.startswith("aten::")])
            if e.self_device_time_total > 0]
    busy = sum(r[2] for r in rows) / 1e6
    top = sorted(rows, key=lambda r: -r[2])[:8]
    print(f"profile {label}: wall {wall:.3f} s (profiled), device busy {busy:.4f} s "
          f"({100 * busy / wall:.2f} %); top: " + "; ".join(
              f"{k[:48]} x{n} {t / 1e3:.3f} ms" for k, n, t in top), flush=True)


def bound(flops, nbytes):
    """(bound_ms, bound_by): the larger of FP64 operations over the peak
    rate and bytes over the memory rate."""
    t_ops, t_bytes = flops / PEAK_FP64 * 1e3, nbytes / PEAK_BYTES * 1e3
    return (t_ops, "operations") if t_ops >= t_bytes else (t_bytes, "bytes")


def nbytes(*ts):
    return sum(t.numel() * t.element_size() for t in ts)


def random_hermitian(rng, K, m):
    a = rng.normal(size=(K, m, m)) + 1j * rng.normal(size=(K, m, m))
    return (a + a.conj().transpose(0, 2, 1)) / 2


def chebinterp_integral(interp):
    """Integral of a piecewise Chebyshev interpolant (Clenshaw-Curtis on
    each panel's coefficients)."""
    import numpy as np

    total = 0.0
    for p in interp.panels:
        n = np.arange(len(p.coef))
        even = n % 2 == 0
        total += (p.b - p.a) / 2 * float(np.sum(p.coef[even] * 2.0 / (1.0 - n[even] ** 2)))
    return total


def main():
    try:
        import numpy as np
        import torch
    except ImportError as e:
        fail(f"needs numpy and torch: {e}")
    if not torch.cuda.is_available():
        fail("torch.cuda.is_available() is false: this smoke run needs an NVIDIA GPU")
    sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))
    try:
        from autobzcore_torch import FBZ, PTR, CubicSymIBZ, IntegralProblem, load_bz, solve
        from autobzcore_torch.algorithms.ptr import frac_nodes
        from autobzcore_torch.models.observables import (
            dos_integrand, dos_trace_weighted_sum, dos_trace_weighted_sum_plain)
        from autobzcore_torch.models.tight_binding import flagship_series, tb_integer
        from autobzcore_torch.ops import cuda_lib
        from autobzcore_torch.ops.fourier_eval import fourier_points, fourier_points_plain, phase_matrix
        from autobzcore_torch.parallel.sweep import SweepSolver
        from autobzcore_torch.utils.chebinterp import hchebinterp
    except ImportError as e:
        fail(f"the autobzcore_torch package must sit beside this script: {e}")
    if "jax" in sys.modules:
        fail("the port imported jax")
    dev = torch.device("cuda", 0)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False

    # 1. device -------------------------------------------------------------
    try:
        smi = subprocess.run(
            ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
            capture_output=True, text=True, timeout=60).stdout.strip().splitlines()
    except (OSError, subprocess.TimeoutExpired) as e:
        fail(f"nvidia-smi: {e}")
    if not smi:
        fail("nvidia-smi printed nothing")
    print(smi[0], flush=True)
    kind = torch.cuda.get_device_name(0)
    print(f"device: torch sees {kind!r}, {torch.cuda.device_count()} card(s); "
          f"torch {torch.__version__}, CUDA {torch.version.cuda}", flush=True)

    # 2. build --------------------------------------------------------------
    try:
        seconds, log = cuda_lib.build_kernels()  # always from the sources
        cuda_lib.load_kernels()
    except (RuntimeError, OSError, subprocess.TimeoutExpired) as e:
        fail(f"kernel build: {e}")
    regs = [ln.strip() for ln in log.splitlines() if "Used" in ln or "spill" in ln]
    print(f"build: {len(cuda_lib.SOURCES)} sources -> {cuda_lib.LIBRARY.name} in "
          f"{seconds:.1f} s (sm_90a); ptxas: {' | '.join(regs)}", flush=True)

    # 3. kernels against their plain versions -------------------------------
    rng = np.random.default_rng(0)
    h = flagship_series(device=dev)
    args = (h.offset, h.period)
    X = torch.as_tensor(rng.random((100_000, 3)), device=dev)
    k1 = fourier_points(h.c, X, *args)
    p1 = fourier_points_plain(h.c, X, *args)
    torch.cuda.synchronize()
    err1 = float((k1 - p1).abs().max() / p1.abs().max())
    if not err1 <= 1e-12:
        fail(f"K1 fourier_points vs plain: max|dH|/max|H| = {err1:.3e} > 1e-12")
    errs2 = []
    for m in (1, 2, 3):
        H = torch.as_tensor(random_hermitian(rng, 100_000, m), device=dev)
        w = torch.as_tensor(rng.random(100_000) + 0.5, device=dev)
        om = torch.linspace(-3.0 * math.sqrt(m), 3.0 * math.sqrt(m), W_FLAGSHIP,
                            dtype=torch.float64, device=dev)
        eta = torch.full_like(om, ETA)
        d1 = dos_trace_weighted_sum(H, w, om, eta, 1e-5)
        d2 = dos_trace_weighted_sum(H, w, om, eta, 1e-5)
        dp = dos_trace_weighted_sum_plain(H, w, om, eta, 1e-5)
        torch.cuda.synchronize()
        e = float((d1 - dp).abs().max() / dp.abs().max())
        if not e <= 1e-10:
            fail(f"K2 dos_trace_weighted_sum vs plain at m={m}: max rel err {e:.3e} > 1e-10")
        if not torch.equal(d1, d2):
            fail(f"K2 at m={m}: two runs on the same inputs differ")
        errs2.append(e)
    print(f"kernels: K1 max|dH|/max|H| = {err1:.3e} (<= 1e-12); K2 max rel err "
          f"m=1,2,3: {errs2[0]:.3e}, {errs2[1]:.3e}, {errs2[2]:.3e} (<= 1e-10); "
          "K2 repeat bit-identical", flush=True)

    # flagship shapes: the full npt=100 grid, W = 264
    Xg = (frac_nodes(NPT, 3, dev) * torch.as_tensor(h.period, device=dev)).contiguous()
    Hg = fourier_points(h.c, Xg, *args)
    Hp = fourier_points_plain(h.c, Xg, *args)
    k1_abs = float((Hg - Hp).abs().max())
    Hg = Hg.reshape(-1, 3, 3)
    wg = torch.ones(Hg.shape[0], dtype=torch.float64, device=dev)
    omg = torch.linspace(*WINDOW, W_FLAGSHIP, dtype=torch.float64, device=dev)
    etag = torch.full_like(omg, ETA)
    sc = (2 * math.pi) ** 3 / NPT**3
    k2_abs = float((dos_trace_weighted_sum(Hg, wg, omg, etag, sc)
                    - dos_trace_weighted_sum_plain(Hg, wg, omg, etag, sc)).abs().max())
    t = {
        "k1": cuda_ms(lambda: fourier_points(h.c, Xg, *args), 10),
        "k1_plain": cuda_ms(lambda: fourier_points_plain(h.c, Xg, *args), 3),
        "k2": cuda_ms(lambda: dos_trace_weighted_sum(Hg, wg, omg, etag, sc), 10),
        "k2_plain": cuda_ms(lambda: dos_trace_weighted_sum_plain(Hg, wg, omg, etag, sc), 2),
    }
    # K1's library call: one complex matmul of the precomputed (K, 125) phase
    # matrix by the (125, 9) coefficients, the phases made outside the timed call
    ph = [phase_matrix(Xg[:, j].contiguous(), h.c.shape[j], h.offset[j], h.period[j]) for j in range(3)]
    Pm = (ph[0][:, :, None, None] * ph[1][:, None, :, None] * ph[2][:, None, None, :]).reshape(Xg.shape[0], -1)
    del ph
    cm = h.c.reshape(Pm.shape[1], -1)
    k1_lib_abs = float((torch.matmul(Pm, cm).reshape(Hg.shape) - Hp).abs().max())
    t["k1_library"] = cuda_ms(lambda: torch.matmul(Pm, cm), 10)
    del Pm
    print(f"kernels at K={Hg.shape[0]}, W={W_FLAGSHIP}: K1 {t['k1']:.3f} ms (plain "
          f"{t['k1_plain']:.3f} ms, max|dH| {k1_abs:.3e}; torch.matmul of the phases {t['k1_library']:.3f} "
          f"ms, max|dH| {k1_lib_abs:.3e}); K2 {t['k2']:.3f} ms (plain "
          f"{t['k2_plain']:.3f} ms, max|dD| {k2_abs:.3e})", flush=True)
    del Hp

    # 4. PTR main path at full width ----------------------------------------
    bz = load_bz(FBZ(), np.eye(3))
    prob = IntegralProblem(dos_integrand(h, ETA), bz)
    fourier_points.launches = 0
    dos_trace_weighted_sum.launches = 0
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    sweep = SweepSolver(prob, PTR(npt=NPT), chunk=W_FLAGSHIP)
    interp = hchebinterp(sweep, *WINDOW, atol=1e-2)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    launches = {"fourier_points": fourier_points.launches,
                "dos_trace_weighted_sum": dos_trace_weighted_sum.launches}
    print(f"main path: flagship PTR(npt={NPT}) leg: {interp.numevals} omegas, "
          f"{len(interp.panels)} panels, numevals {sweep.numevals}, retcode {sweep.retcode}, "
          f"wall {wall:.3f} s; launches {launches}", flush=True)
    if min(launches.values()) <= 0:
        fail(f"the main path did not go through every kernel: {launches}")
    if not sweep.retcode or sweep.numevals != interp.numevals * NPT**3:
        fail(f"sweep certificate: retcode {sweep.retcode}, numevals {sweep.numevals}")

    # sum rule: the integral of the interpolant over the window against the
    # closed-form integral of the Lorentzians at the eigenvalues
    # on the host: cuSOLVER's batched eigensolver refuses these batches
    # (CUSOLVER_STATUS_INVALID_VALUE at 1e6 and at 65536 3x3 matrices)
    e = torch.linalg.eigvalsh(Hg.cpu())
    lo, hi = WINDOW
    exact = float(((torch.atan((hi - e) / ETA) - torch.atan((lo - e) / ETA)) / math.pi).sum()) * sc
    got = chebinterp_integral(interp)
    rel = abs(got - exact) / abs(exact)
    ws = np.array([-4.0, -1.0, 0.5, 2.0, 5.5])
    d_main = sweep(ws)
    omw = torch.as_tensor(ws, device=dev)
    d_plain = dos_trace_weighted_sum_plain(
        fourier_points_plain(h.c, Xg, *args).reshape(-1, 3, 3), wg, omw,
        torch.full_like(omw, ETA), sc).cpu().numpy()
    rel5 = float(np.max(np.abs(d_main - d_plain) / np.abs(d_plain)))
    vals = interp(np.linspace(*WINDOW, 1001))
    print(f"main path check: integral {got:.10g} vs sum rule {exact:.10g} (rel {rel:.3e}, "
          f"<= 1e-3); D at 5 omegas vs plain path: max rel {rel5:.3e} (<= 1e-10); "
          f"D finite: {bool(np.all(np.isfinite(vals)))}", flush=True)
    if not rel <= 1e-3:
        fail(f"sum rule off by {rel:.3e}")
    if not rel5 <= 1e-10 or d_main.shape != (5,):
        fail(f"D at 5 omegas differs from the plain path by {rel5:.3e}")
    if not np.all(np.isfinite(vals)):
        fail("the interpolant is not finite")
    if "--profile" in sys.argv[1:]:
        profile("PTR main path", lambda: hchebinterp(SweepSolver(prob, PTR(npt=NPT), chunk=W_FLAGSHIP),
                                                      *WINDOW, atol=1e-2))

    # 5. cubic IBZ against the full zone -------------------------------------
    h1 = tb_integer(3, device=dev)
    om8 = torch.linspace(-5.0, 5.0, 8, dtype=torch.float64, device=dev)
    t0 = time.perf_counter()
    sol_ibz = solve(IntegralProblem(dos_integrand(h1, ETA), load_bz(CubicSymIBZ(), np.eye(3)), om8),
                    PTR(npt=NPT))
    sol_fbz = solve(IntegralProblem(dos_integrand(h1, ETA), load_bz(FBZ(), np.eye(3)), om8),
                    PTR(npt=NPT))
    u_ibz, u_fbz = sol_ibz.u.cpu().numpy(), sol_fbz.u.cpu().numpy()
    rel8 = float(np.max(np.abs(u_ibz - u_fbz) / np.abs(u_fbz)))
    print(f"cubic IBZ: tb_integer(3), npt={NPT}, 8 omegas: {sol_ibz.numevals} representatives "
          f"vs {sol_fbz.numevals} points, max rel diff {rel8:.3e} (<= 1e-10), "
          f"{time.perf_counter() - t0:.3f} s", flush=True)
    if not rel8 <= 1e-10:
        fail(f"CubicSymIBZ and FBZ differ by {rel8:.3e}")

    src = "autobzcore_torch/csrc/"
    b1 = bound(Hg.shape[0] * (125 * (8 * 9 + 6)),
               nbytes(h.c, Xg) + Hg.numel() * Hg.element_size())
    b2 = bound(Hg.shape[0] * W_FLAGSHIP * (TRACE_FLOPS[3] + 2), nbytes(Hg, wg, omg, etag) + 8 * W_FLAGSHIP)
    kernels = [
        {"name": "fourier_points", "route": "cuda", "source": src + "fourier_points.cu",
         "replaces": "autobzcore_tpu/ops/fourier_eval.py:78",
         "launches": launches["fourier_points"], "max_abs_err": k1_abs,
         "ms": t["k1"], "plain_ms": t["k1_plain"], "bound_ms": b1[0], "bound_by": b1[1],
         "library_ms": t["k1_library"]},
        {"name": "dos_trace_weighted_sum", "route": "cuda", "source": src + "dos_trace.cu",
         "replaces": "autobzcore_tpu/models/observables.py:149",
         "launches": launches["dos_trace_weighted_sum"], "max_abs_err": k2_abs,
         "ms": t["k2"], "plain_ms": t["k2_plain"], "bound_ms": b2[0], "bound_by": b2[1],
         "library_ms": None},
    ]
    del Hg, Xg, wg
    torch.cuda.empty_cache()
    cold, k_iai = iai_phases(np, torch, dev, h)
    kernels += k_iai
    kernels += warm_phases(np, torch, dev, h, cold)
    kernels += fullgrid_phases(np, torch, dev, h, cold)
    kernels += ltm_phases(np, torch, dev, h)
    kernels += block_phases(np, torch, dev, h, cold)
    kernels += repair_phases(np, torch, dev)
    print(json.dumps({"kernels": kernels}), flush=True)
    print(json.dumps({"ok": True, "device": {"platform": "gpu", "kind": kind,
                                             "count": torch.cuda.device_count()}}), flush=True)


def iai_phases(np, torch, dev, h):
    """Phases 6-8: K3-K5 against their plain versions, the IAI main path and
    the cubic-IBZ check through IAI. Returns the kernels' JSON entries."""
    from autobzcore_torch import FBZ, IAI, PTR, CubicSymIBZ, IntegralProblem, load_bz, solve
    from autobzcore_torch.models.observables import dos_integrand, gk_leaf_dos, gk_leaf_dos_plain
    from autobzcore_torch.models.tight_binding import tb_integer
    from autobzcore_torch.ops import adaptive as tad
    from autobzcore_torch.ops.fourier_eval import (fourier_contract, fourier_contract_plain,
                                                   phase_matrix)
    from autobzcore_torch.parallel.sweep import SweepSolver

    src = "autobzcore_torch/csrc/"
    rng = np.random.default_rng(1)
    xk, wk, wg = tad.gk_rule(7, dev)
    P = xk.shape[0]
    L_mid, L_leaf = IAI_OMEGAS * 2 * P, IAI_OMEGAS * (2 * P) ** 2

    # 6a. K3: the outer level's contraction at 2 x 15 nodes of each of the 33
    # solves, then the mid level's at 2 x 15 nodes of each of the 990 results
    c0 = h.c.reshape((1, 5, 5, 5, 9)).contiguous()
    x_out = torch.as_tensor(rng.random((IAI_OMEGAS, 2 * P)), device=dev)
    cm_out = torch.zeros(IAI_OMEGAS, dtype=torch.int64, device=dev)
    k3a = fourier_contract(c0, cm_out, x_out, h.offset[2], h.period[2])
    e3a = float((k3a - fourier_contract_plain(c0, cm_out, x_out, h.offset[2], h.period[2])).abs().max())
    c_mid = k3a.reshape(L_mid, 5, 5, 9)
    cm_mid = torch.arange(L_mid, device=dev)
    x_mid = torch.as_tensor(rng.random((L_mid, 2 * P)), device=dev)
    args3 = (c_mid, cm_mid, x_mid, h.offset[1], h.period[1])
    k3 = fourier_contract(*args3)
    p3 = fourier_contract_plain(*args3)
    e3 = float((k3 - p3).abs().max())
    cmax = max(float(c0.abs().max()), float(c_mid.abs().max()))
    if not max(e3a, e3) <= 1e-12 * cmax:
        fail(f"K3 fourier_contract vs plain: max|d| {max(e3a, e3):.3e} > 1e-12 max|c| ({cmax:.3e})")
    # the library call: one batched matmul of the (L, J, n) phases against (L, n, rest)
    ph = phase_matrix(x_mid, 5, h.offset[1], h.period[1])
    cl = c_mid.permute(0, 2, 1, 3).reshape(L_mid, 5, 45).contiguous()
    e3m = float((torch.matmul(ph, cl).reshape(p3.shape) - p3).abs().max())
    t3 = {"ms": cuda_ms(lambda: fourier_contract(*args3), 50),
          "plain_ms": cuda_ms(lambda: fourier_contract_plain(*args3), 10),
          "library_ms": cuda_ms(lambda: torch.matmul(ph, cl), 50),
          "outer_ms": cuda_ms(lambda: fourier_contract(c0, cm_out, x_out, h.offset[2], h.period[2]), 50)}
    b3 = bound(k3.numel() * 8 * 5, nbytes(c_mid, cm_mid, x_mid, k3))
    print(f"K3 fourier_contract: outer {tuple(x_out.shape)} max|d| {e3a:.3e}, mid "
          f"{tuple(x_mid.shape)} max|d| {e3:.3e} (<= 1e-12 max|c| = {1e-12 * cmax:.3e}); mid "
          f"{t3['ms']:.4f} ms (plain {t3['plain_ms']:.4f}, torch.matmul {t3['library_ms']:.4f} "
          f"max|d| {e3m:.3e}; bound {b3[0]:.4f} ms by {b3[1]}), outer {t3['outer_ms']:.4f} ms",
          flush=True)

    # 6b. K4: leaf lanes with 1-D coefficients of the flagship contracted at
    # random (x3, x2), 2 intervals per lane; m = 1, 2 from random 1-D series
    def leaf_inputs(L, m):
        if m == 3:
            x3 = torch.as_tensor(rng.random((1, L)), device=dev)
            c2 = fourier_contract_plain(c0, torch.zeros(1, dtype=torch.int64, device=dev), x3,
                                        h.offset[2], 1.0).reshape(L, 5, 5, 9)
            x2 = torch.as_tensor(rng.random((L, 1)), device=dev)
            c1 = fourier_contract_plain(c2, torch.arange(L, device=dev), x2, h.offset[1], 1.0)
            c1 = c1.reshape(L, 5, 9).contiguous()
        else:
            a = rng.normal(size=(L, 5, m, m)) + 1j * rng.normal(size=(L, 5, m, m))
            a = a + np.conj(a[:, ::-1].transpose(0, 1, 3, 2))  # a Hermitian series
            c1 = torch.as_tensor(a.reshape(L, 5, m * m), device=dev).contiguous()
        a0 = torch.as_tensor(rng.random((L, 2)) * 0.5, device=dev)
        b0 = (a0 + torch.as_tensor(rng.random((L, 2)) * 0.5, device=dev)).contiguous()
        om = torch.as_tensor(rng.uniform(-6, 7, L), device=dev)
        return (c1, torch.arange(L, device=dev), -2, 1.0, a0.contiguous(), b0, om,
                torch.full_like(om, ETA), torch.ones(L, dtype=torch.bool, device=dev), xk, wk, wg)

    errs4 = []
    for m in (1, 2, 3):
        a4 = leaf_inputs(900, m)
        got, want = gk_leaf_dos(*a4), gk_leaf_dos_plain(*a4)
        l1 = want[2]
        e = max(float(((got[0] - want[0]).abs() / l1).max()), float(((got[1] - want[1]).abs() / l1).max()))
        if not (e <= 1e-12 and torch.equal(got[3], want[3])):
            fail(f"K4 gk_leaf_dos vs plain at m={m}: max |d val|, |d err| / l1 = {e:.3e} > 1e-12")
        errs4.append(e)
    a4 = leaf_inputs(L_leaf, 3)
    got, want = gk_leaf_dos(*a4), gk_leaf_dos_plain(*a4)
    e4 = float(max((got[0] - want[0]).abs().max(), (got[1] - want[1]).abs().max()))
    t4 = {"ms": cuda_ms(lambda: gk_leaf_dos(*a4), 50), "plain_ms": cuda_ms(lambda: gk_leaf_dos_plain(*a4), 5)}
    b4 = bound(L_leaf * 2 * P * (5 * (8 * 9 + 6) + TRACE_FLOPS[3] + 9),
               nbytes(*a4[:2], *a4[4:9]) + 4 * L_leaf * 2 * 8)
    print(f"K4 gk_leaf_dos: 900 lanes x 2 intervals, max |d val|, |d err| / l1 at m=1,2,3: "
          f"{errs4[0]:.3e}, {errs4[1]:.3e}, {errs4[2]:.3e} (<= 1e-12); {L_leaf} lanes m=3: "
          f"{t4['ms']:.4f} ms (plain {t4['plain_ms']:.4f}; bound {b4[0]:.4f} ms by {b4[1]}), "
          f"max|d| {e4:.3e}", flush=True)

    # 6c. K5: pools of the leaf level (cap 64, nbisect 1) with planted ties,
    # lanes with n < nbisect (at nbisect 4) and stopped lanes; then the rule
    # reduction of the mid level (per-node counts of the inner solves)
    def random_pool(L, nb):
        n = torch.as_tensor(rng.integers(1, 64 - nb + 3, L), device=dev)
        if nb > 1:
            n[: L // 20] = torch.as_tensor(rng.integers(1, nb, L // 20), device=dev)
        live = torch.arange(64, device=dev)[None, :] < n[:, None]
        zero = torch.zeros((), dtype=torch.float64, device=dev)
        a0 = torch.where(live, torch.as_tensor(rng.random((L, 64)), device=dev), zero)
        b0 = torch.where(live, a0 + torch.as_tensor(rng.random((L, 64)), device=dev), zero)
        err = torch.where(live, torch.as_tensor(rng.integers(0, 6, (L, 64)) * 0.125, device=dev), zero)
        val = torch.where(live, torch.as_tensor(rng.normal(size=(L, 64)), device=dev), zero)
        pool = tad.GKPool(a=a0, b=b0, err=err, l1=2 * err, val=val, n=n,
                          evals=torch.as_tensor(rng.integers(0, 2000, L).astype(np.float64), device=dev),
                          atol=torch.as_tensor(rng.random(L) * 4, device=dev), rtol=1e-3, max_evals=1500.0,
                          active=torch.as_tensor(rng.random(L) > 0.05, device=dev))
        tad.gk_pool_totals_plain(pool)
        return pool

    def clone(pool):
        return tad.GKPool(**{k: (v.clone() if isinstance(v, torch.Tensor) else v)
                             for k, v in pool.__dict__.items()})

    checks5, e5s = [], 0.0
    for L, nb in ((900, 1), (900, 4), (L_leaf, 1)):
        pool = random_pool(L, nb)
        ref = clone(pool)
        idx, ca, cb = tad.gk_pool_select(pool, nb)
        ridx, rca, rcb = tad.gk_pool_select_plain(ref, nb)
        live = ref.active
        if not (torch.equal(pool.active, live) and torch.equal(idx[live], ridx[live])
                and torch.equal(ca, rca) and torch.equal(cb, rcb)):
            fail(f"K5 select at {L} lanes, nbisect {nb}: picks differ from the plain version")
        e5s = max(e5s, float((idx[live] - ridx[live]).abs().max()), float((ca - rca).abs().max()),
                  float((cb - rcb).abs().max()))
        cval = torch.as_tensor(rng.normal(size=(L, 2 * nb)), device=dev)
        cerr = torch.as_tensor(rng.random((L, 2 * nb)), device=dev)
        count = torch.full((L,), 30.0 * nb, dtype=torch.float64, device=dev)
        sel_in = (clone(pool), nb)
        tad.gk_pool_update(pool, nb, idx, ca, cb, cval, cerr, cerr, count)
        tad.gk_pool_update_plain(ref, nb, ridx, rca, rcb, cval, cerr, cerr, count)
        same = all(torch.equal(getattr(pool, k), getattr(ref, k))
                   for k in ("a", "b", "err", "l1", "val", "n", "evals"))
        d_err, d_val = (pool.tot_err - ref.tot_err).abs(), (pool.tot_val - ref.tot_val).abs()
        rel = max(float((d_err / ref.tot_err.abs().clamp_min(1e-300)).max()),
                  float((d_val / ref.tot_val.abs().clamp_min(1e-300)).max()))
        if not (same and rel <= 1e-14):
            fail(f"K5 update at {L} lanes, nbisect {nb}: pools identical {same}, totals rel {rel:.3e}")
        checks5.append((L, nb, int(live.sum()), rel, max(float(d_err.max()), float(d_val.max()))))
    # times at the leaf level's widest trip (the last pool above)
    pool_s, nb = sel_in
    upd_args = (nb, idx, ca, cb, cval, cerr, cerr, count)
    # select only narrows `active`, so it repeats on one pool unchanged
    pool_k, pool_p = clone(pool_s), clone(pool_s)
    t5s = {"ms": cuda_ms(lambda: tad.gk_pool_select(pool_k, nb), 30),
           "plain_ms": cuda_ms(lambda: tad.gk_pool_select_plain(pool_p, nb), 10)}
    # an update moves n on, so each timed call clones the pool first
    clone_ms = cuda_ms(lambda: clone(pool_s), 30)
    t5u = {"ms": cuda_ms(lambda: tad.gk_pool_update(clone(pool_s), *upd_args), 30) - clone_ms,
           "plain_ms": cuda_ms(lambda: tad.gk_pool_update_plain(clone(pool_s), *upd_args), 10) - clone_ms}
    b5s = bound(0, nbytes(pool_s.err, pool_s.n, pool_s.evals, pool_s.tot_err, pool_s.tol, pool_s.active)
                + 2 * 2 * L_leaf * 8 + nbytes(idx, ca, cb))
    b5u = bound(L_leaf * 64 * 2, nbytes(ca, cb, cval, cerr, cerr, count, idx) + 2 * L_leaf * 2 * 5 * 8
                + nbytes(pool_s.err, pool_s.val) + 3 * L_leaf * 8)
    # rule reduction at the mid level's shape: 990 lanes x 2 intervals x 15
    # nodes of inner-solve values and counts
    fx = torch.as_tensor(rng.normal(size=(L_mid, 2, P)), device=dev)
    cnt = torch.as_tensor(rng.integers(100, 5000, (L_mid, 2, P)).astype(np.float64), device=dev)
    half = torch.as_tensor(rng.random((L_mid, 2)), device=dev)
    half[::7, 1] = 0.0
    got, want = tad.gk_rule_reduce(fx, cnt, half, wk, wg), tad.gk_rule_reduce_plain(fx, cnt, half, wk, wg)
    e5r = max(float((g - w).abs().max()) for g, w in zip(got[:3], want[:3]))
    if not (e5r <= 1e-12 * float(want[2].max()) and torch.equal(got[3], want[3])):
        fail(f"K5 rule reduce vs plain: max|d| {e5r:.3e}")
    t5r = {"ms": cuda_ms(lambda: tad.gk_rule_reduce(fx, cnt, half, wk, wg), 50),
           "plain_ms": cuda_ms(lambda: tad.gk_rule_reduce_plain(fx, cnt, half, wk, wg), 20)}
    b5r = bound(L_mid * 2 * P * 7, nbytes(fx, cnt, half, wk, wg) + L_mid * (3 * 2 + 1) * 8)
    print(f"K5 gk_pool: select/update vs plain (lanes, nbisect, live, totals rel, abs): {checks5}, picks "
          f"and pools identical; at {L_leaf} lanes x cap 64: select {t5s['ms']:.4f} ms (plain "
          f"{t5s['plain_ms']:.4f}; bound {b5s[0]:.4f} by {b5s[1]}), update {t5u['ms']:.4f} ms "
          f"(plain {t5u['plain_ms']:.4f}; bound {b5u[0]:.4f} by {b5u[1]}); rule reduce "
          f"{tuple(fx.shape)}: max|d| {e5r:.3e}, {t5r['ms']:.4f} ms (plain {t5r['plain_ms']:.4f}; "
          f"bound {b5r[0]:.5f} by {b5r[1]})", flush=True)
    del a4, got, want, k3, p3, cl, ph

    # 7. IAI main path at full width ------------------------------------------
    bz = load_bz(FBZ(), np.eye(3))
    prob = IntegralProblem(dos_integrand(h, ETA), bz)
    oms = np.linspace(*WINDOW, IAI_OMEGAS)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    fourier_contract.launches = 0
    gk_leaf_dos.launches = 0
    tad.gk_rule_reduce.launches = 0
    for key in tad.gk_pool_launches:
        tad.gk_pool_launches[key] = 0
    t0 = time.perf_counter()
    sweep = SweepSolver(prob, IAI(inner_cap=64, inner_nbisect=4), abstol=IAI_ABSTOL,
                        chunk=IAI_OMEGAS, scan=True)
    d_iai = sweep(oms)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    launches = {"fourier_contract": fourier_contract.launches, "gk_leaf_dos": gk_leaf_dos.launches,
                "gk_pool_select": tad.gk_pool_launches["select"],
                "gk_pool_update": tad.gk_pool_launches["update"] + tad.gk_pool_launches["totals"],
                "gk_rule_reduce": tad.gk_rule_reduce.launches}
    peak = torch.cuda.max_memory_allocated() / 2**20
    ne = sweep.lane_numevals
    st = sweep.stats
    print(f"IAI main path: flagship FBZ, eta {ETA}, {IAI_OMEGAS} omegas, abstol {IAI_ABSTOL}: wall "
          f"{wall:.3f} s ({wall / IAI_OMEGAS:.4f} s/omega); numevals {sweep.numevals} (per omega "
          f"min {ne.min()} max {ne.max()} mean {ne.mean():.4g}); retcode {sweep.retcode}; trips "
          f"(level 3 outer, 2 mid, 1 leaf) {dict(sorted(st.trips.items(), reverse=True))}; host "
          f"syncs {st.syncs} ({st.syncs / IAI_OMEGAS:.1f} per omega); launches {launches}; peak "
          f"device memory {peak:.1f} MiB", flush=True)
    if min(launches.values()) <= 0:
        fail(f"the IAI main path did not go through every kernel: {launches}")
    if not sweep.retcode or d_iai.shape != (IAI_OMEGAS,) or not np.all(np.isfinite(d_iai)):
        fail(f"IAI sweep: retcode {sweep.retcode}, shape {d_iai.shape}")
    if "--profile" in sys.argv[1:]:
        profile("IAI main path", lambda: SweepSolver(prob, IAI(inner_cap=64, inner_nbisect=4),
                                                     abstol=IAI_ABSTOL, chunk=IAI_OMEGAS,
                                                     scan=True)(oms))

    # the same solve through the plain versions, at one frequency (phase 10
    # holds the warm chain against them too, within the time limit)
    pick = [IAI_OMEGAS // 4]
    t0 = time.perf_counter()
    psweep = SweepSolver(prob, IAI(inner_cap=64, inner_nbisect=4, plain_kernels=True),
                         abstol=IAI_ABSTOL, chunk=IAI_OMEGAS, scan=True)
    d_plain = psweep(oms[pick])
    t_plain = time.perf_counter() - t0
    dev3 = float(np.max(np.abs(d_plain - d_iai[pick])))
    print(f"IAI vs plain path at omegas {oms[pick].round(4).tolist()}: D {d_iai[pick].tolist()} vs "
          f"{d_plain.tolist()}, max|d| {dev3:.3e} (<= abstol {IAI_ABSTOL}); numevals "
          f"{ne[pick].tolist()} vs {psweep.lane_numevals.tolist()}; plain path {t_plain:.3f} s, "
          f"retcode {psweep.retcode}", flush=True)
    if not (dev3 <= IAI_ABSTOL and psweep.retcode):
        fail(f"IAI kernels vs plain path: max|d| {dev3:.3e}")

    # a gross-error catch against the fixed rule at npt = 400
    t0 = time.perf_counter()
    d_ptr = solve(IntegralProblem(dos_integrand(h, ETA), bz, torch.as_tensor(oms, device=dev)),
                  PTR(npt=400)).u.cpu().numpy()
    torch.cuda.synchronize()
    dptr = float(np.max(np.abs(d_iai - d_ptr)))
    print(f"IAI vs PTR(npt=400) at {IAI_OMEGAS} omegas: max|d| {dptr:.4e} (<= 1e-2 max|D| = "
          f"{1e-2 * np.max(np.abs(d_ptr)):.4e}); PTR {time.perf_counter() - t0:.3f} s", flush=True)
    if not dptr <= 1e-2 * np.max(np.abs(d_ptr)):
        fail(f"IAI and PTR(npt=400) differ by {dptr:.3e}")
    torch.cuda.empty_cache()

    # 8. cubic IBZ through IAI ------------------------------------------------
    h1 = tb_integer(3, device=dev)
    om4 = np.array([-4.1, -1.3, 0.7, 2.9])
    t0 = time.perf_counter()
    outs = {}
    for name, kind in (("IBZ", CubicSymIBZ()), ("FBZ", FBZ())):
        sw = SweepSolver(IntegralProblem(dos_integrand(h1, 0.1), load_bz(kind, np.eye(3))),
                         IAI(inner_cap=64, inner_nbisect=4), abstol=IAI_ABSTOL, chunk=4, scan=True)
        outs[name] = (sw(om4), sw.numevals, sw.retcode)
    d4 = float(np.max(np.abs(outs["IBZ"][0] - outs["FBZ"][0])))
    print(f"cubic IBZ through IAI: tb_integer(3), eta 0.1, 4 omegas: max|d| {d4:.3e} (<= "
          f"{2 * IAI_ABSTOL}); numevals IBZ {outs['IBZ'][1]} vs FBZ {outs['FBZ'][1]}; retcodes "
          f"{outs['IBZ'][2]} {outs['FBZ'][2]}; {time.perf_counter() - t0:.3f} s", flush=True)
    if not (d4 <= 2 * IAI_ABSTOL and outs["IBZ"][2] and outs["FBZ"][2]):
        fail(f"CubicSymIBZ and FBZ differ through IAI by {d4:.3e}")

    rep = "autobzcore_tpu/ops/adaptive.py:"
    cold = {"oms": oms, "d": d_iai, "ne": ne, "numevals": sweep.numevals, "wall": wall,
            "d_ptr": d_ptr, "bz": bz}
    return cold, [
        {"name": "fourier_contract", "route": "cuda", "source": src + "fourier_contract.cu",
         "replaces": "autobzcore_tpu/ops/fourier_eval.py:104", "launches": launches["fourier_contract"],
         "max_abs_err": max(e3a, e3), "ms": t3["ms"], "plain_ms": t3["plain_ms"],
         "bound_ms": b3[0], "bound_by": b3[1], "library_ms": t3["library_ms"]},
        {"name": "gk_leaf_dos", "route": "cuda", "source": src + "gk_leaf_dos.cu",
         "replaces": "autobzcore_tpu/fourier.py:394", "launches": launches["gk_leaf_dos"],
         "max_abs_err": e4, "ms": t4["ms"], "plain_ms": t4["plain_ms"],
         "bound_ms": b4[0], "bound_by": b4[1], "library_ms": None},
        {"name": "gk_pool_select", "route": "cuda", "source": src + "gk_pool.cu",
         "replaces": rep + "427", "launches": launches["gk_pool_select"], "max_abs_err": e5s,
         "ms": t5s["ms"], "plain_ms": t5s["plain_ms"], "bound_ms": b5s[0], "bound_by": b5s[1],
         "library_ms": None},
        {"name": "gk_pool_update", "route": "cuda", "source": src + "gk_pool.cu",
         "replaces": rep + "446", "launches": launches["gk_pool_update"],
         "max_abs_err": max(c[4] for c in checks5), "ms": t5u["ms"], "plain_ms": t5u["plain_ms"],
         "bound_ms": b5u[0], "bound_by": b5u[1], "library_ms": None},
        {"name": "gk_rule_reduce", "route": "cuda", "source": src + "gk_pool.cu",
         "replaces": rep + "72", "launches": launches["gk_rule_reduce"], "max_abs_err": e5r,
         "ms": t5r["ms"], "plain_ms": t5r["plain_ms"], "bound_ms": b5r[0], "bound_by": b5r[1],
         "library_ms": None},
    ]


def warm_phases(np, torch, dev, h, cold):
    """Phases 9-10: the warm IAI main path (two calls) with K6 and K5's seed
    entry checked against their plain versions between them. Returns the
    two kernels' JSON entries."""
    import copy

    from autobzcore_torch import IAI, PTR, IntegralProblem, solve
    from autobzcore_torch.algorithms.nested import _mid_seed_pool
    from autobzcore_torch.interop import pool_to_arrays
    from autobzcore_torch.models.observables import dos_integrand, gk_leaf_dos
    from autobzcore_torch.ops import adaptive as tad
    from autobzcore_torch.ops.fourier_eval import fourier_contract
    from autobzcore_torch.parallel.sweep import SweepSolver

    sys.path.insert(0, os.path.join(os.path.dirname(os.path.abspath(__file__)), "tests"))
    from torch_parity import dyadic_pools

    src = "autobzcore_torch/csrc/"
    bz, oms = cold["bz"], cold["oms"]
    prob = IntegralProblem(dos_integrand(h, ETA), bz)

    def warm_sweep(chunk, plain=False):
        return SweepSolver(prob, IAI(inner_cap=64, inner_nbisect=4, warm_width=8, plain_kernels=plain),
                           abstol=IAI_ABSTOL, chunk=chunk, scan=True, warm=True)

    def reset():
        fourier_contract.launches = gk_leaf_dos.launches = 0
        tad.gk_rule_reduce.launches = tad.coarsen_pool.launches = 0
        for key in tad.gk_pool_launches:
            tad.gk_pool_launches[key] = 0

    def launches():
        return {"fourier_contract": fourier_contract.launches, "gk_leaf_dos": gk_leaf_dos.launches,
                "gk_pool_select": tad.gk_pool_launches["select"],
                "gk_pool_update": tad.gk_pool_launches["update"] + tad.gk_pool_launches["totals"],
                "gk_rule_reduce": tad.gk_rule_reduce.launches,
                "gk_pool_seed": tad.gk_pool_launches["seed"], "coarsen_pool": tad.coarsen_pool.launches}

    def run(sweep, xs):
        before = copy.deepcopy(sweep.stats)
        ne0, nchunks = sweep.numevals, len(sweep.chunk_evals)
        reset()
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        t0 = time.perf_counter()
        d = sweep(xs)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        st = sweep.stats
        delta = lambda new, old: {k: v - old.get(k, 0) for k, v in sorted(new.items(), reverse=True)}  # noqa: E731
        ne = sweep.numevals - ne0
        out = {"d": d, "wall": wall, "launches": launches(), "numevals": ne,
               "harvest": ne - sum(sweep.chunk_evals[nchunks:]), "trips": delta(st.trips, before.trips),
               "seed_trips": delta(st.seed_trips, before.seed_trips), "syncs": st.syncs - before.syncs,
               "peak": torch.cuda.max_memory_allocated() / 2**20}
        pool = pool_to_arrays(sweep._pool)
        print(f"warm IAI call ({len(xs)} omegas in [{xs.min():.4g}, {xs.max():.4g}]): wall {wall:.3f} s "
              f"({wall / len(xs):.4f} s/omega); numevals {ne} (harvests {out['harvest']:.0f}); retcode "
              f"{sweep.retcode}; trips (level 3 outer, 2 mid, 1 leaf) {out['trips']}, seed trips "
              f"{out['seed_trips']}; host syncs {out['syncs']} ({out['syncs'] / len(xs):.1f} per omega); "
              f"launches {out['launches']}; carried pool: outer n {pool[3]}, mid tn {pool[4][3]}; "
              f"chunk evals {sweep.chunk_evals[nchunks:]}; peak device memory {out['peak']:.1f} MiB",
              flush=True)
        if not sweep.retcode or d.shape != xs.shape or not np.all(np.isfinite(d)):
            fail(f"warm IAI sweep: retcode {sweep.retcode}, shape {d.shape}")
        return out

    # 10, call 1: the 33 frequencies of phase 7's cold chunk ----------------------
    sweep = warm_sweep(IAI_OMEGAS)
    c1 = run(sweep, oms)
    ratio = c1["numevals"] / cold["numevals"]
    dcold = float(np.max(np.abs(c1["d"] - cold["d"])))
    dptr = float(np.max(np.abs(c1["d"] - cold["d_ptr"])))
    print(f"warm call 1 vs phase 7's cold chunk on the same omegas: evals {c1['numevals']} vs "
          f"{cold['numevals']} (warm/cold {ratio:.4f}); wall {c1['wall']:.3f} s vs {cold['wall']:.3f} s; "
          f"max|d D| {dcold:.3e} (<= 2 abstol); vs PTR(npt=400) max|d| {dptr:.4e} (<= "
          f"{1e-2 * np.max(np.abs(cold['d_ptr'])):.4e})", flush=True)
    if not dcold <= 2 * IAI_ABSTOL:
        fail(f"warm and cold IAI values differ by {dcold:.3e}")
    if not dptr <= 1e-2 * np.max(np.abs(cold["d_ptr"])):
        fail(f"warm IAI and PTR(npt=400) differ by {dptr:.3e}")

    # 9. K6 and K5's seed entry against their plain versions ----------------------
    pool = sweep._pool
    scale = abs(float(np.linalg.det(bz.B))) * bz.nsyms
    tol = torch.full((1,), IAI_ABSTOL / scale, dtype=torch.float64, device=dev)
    segs = torch.tensor([[0.0, 1.0]], dtype=torch.float64, device=dev)
    outer = (pool.a[None].contiguous(), pool.b[None].contiguous(), pool.e[None].contiguous(),
             pool.n.clone(), segs, tol)
    # the harvest's pool before its coarsening: the carried mid seed on the
    # mid level's domain, [0, 1] on the full zone at every outer node
    (ma, mb, me, mn), _ = _mid_seed_pool(pool.mid, segs)
    mid = (ma, mb, me, mn, segs, tol)
    rng = np.random.default_rng(9)
    cases = [("outer pool", outer), ("harvest pool", mid)]
    for cap, sg in ((64, [0.0, 0.3, 1.0]), (2048, [0.0, 0.125, 0.5])):
        a, b, e, n = dyadic_pools(rng, 40, cap, sg, dev)
        cases.append((f"40 random pools, cap {cap}",
                      (a, b, e, n, torch.tensor(sg, dtype=torch.float64, device=dev).expand(40, -1).contiguous(),
                       torch.as_tensor(10 ** rng.uniform(-7, -2, 40), device=dev))))
    merged, e6 = [], 0.0
    for name, args in cases:
        got, want = tad.coarsen_pool(*args), tad.coarsen_pool_plain(*args)
        if not all(torch.equal(g, wv) for g, wv in zip(got, want)):
            fail(f"K6 coarsen_pool vs plain on the {name}: pools differ")
        e6 = max([e6] + [float((g - wv).abs().max()) for g, wv in zip(got, want)])
        merged.append(f"{name}: n {args[3].tolist()[:3]} -> {want[2].tolist()[:3]}")
    t6 = {"ms": cuda_ms(lambda: tad.coarsen_pool(*outer), 200),
          "plain_ms": cuda_ms(lambda: tad.coarsen_pool_plain(*outer), 20)}
    cap_o = pool.a.shape[0]
    b6 = bound(cap_o * 24, nbytes(*outer) + 2 * cap_o * 8 + 8)
    # the seed entry: the coarsened outer pool seeded chunk by chunk (C = 8)
    # with random chunk values, then the mid shape of an outer seed trip
    # (120 lanes = 8 intervals x 15 nodes, cap 64, C = 2), some lanes idle
    a_c, b_c, n0 = tad.coarsen_pool(*outer)

    def seeded(seed_fn, L, cap, C, a_s, b_s, n_s, trips, seeding):
        g = np.random.default_rng(10)
        pl = tad.GKPool(a=a_s.clone(), b=b_s.clone(), err=torch.zeros((L, cap), dtype=torch.float64, device=dev),
                        l1=torch.zeros((L, cap), dtype=torch.float64, device=dev),
                        val=torch.zeros((L, cap), dtype=torch.float64, device=dev),
                        n=torch.zeros(L, dtype=torch.int64, device=dev),
                        evals=torch.zeros(L, dtype=torch.float64, device=dev),
                        atol=torch.full((L,), 1e-6, dtype=torch.float64, device=dev), rtol=0.0,
                        max_evals=1e18, active=torch.ones(L, dtype=torch.bool, device=dev))
        for k in range(trips):
            start = min(k * C, cap - C)
            ch = [torch.as_tensor(g.random((L, C)), device=dev) for _ in range(3)]
            seed_fn(pl, start, a_s[:, start:start + C].contiguous(), b_s[:, start:start + C].contiguous(),
                    ch[0], ch[1], ch[2], torch.full((L,), 15.0 * C, dtype=torch.float64, device=dev),
                    n_s, seeding)
        return pl

    n0h = int(n0[0])
    shapes = [(1, cap_o, 8, a_c, b_c, n0, -(-n0h // 8), torch.ones(1, dtype=torch.bool, device=dev))]
    ra, rb, _, rn = dyadic_pools(rng, 120, 64, [0.0, 1.0], dev)
    shapes.append((120, 64, 2, ra, rb, rn, 16, torch.as_tensor(rng.random(120) > 0.1, device=dev)))
    fields = ("a", "b", "err", "l1", "val", "n", "evals", "tot_val", "tot_err", "tol")
    e5d = 0.0
    for L, cap, C, a_s, b_s, n_s, trips, seeding in shapes:
        got = seeded(tad.gk_pool_seed, L, cap, C, a_s, b_s, n_s, trips, seeding)
        want = seeded(tad.gk_pool_seed_plain, L, cap, C, a_s, b_s, n_s, trips, seeding)
        same = all(torch.equal(getattr(got, k), getattr(want, k)) for k in fields[:7])
        # the totals and tolerance to a relative 1e-14 per lane (the kernel
        # sums in another order)
        rel = max(float(((getattr(got, k) - getattr(want, k)).reshape(L, -1).abs().amax(1)
                         / getattr(want, k).reshape(L, -1).abs().amax(1).clamp_min(1e-300)).max())
                  for k in fields[7:])
        if not (same and rel <= 1e-14):
            fail(f"K5 seed entry vs plain at {L} lanes x cap {cap}: pools identical {same}, "
                 f"totals and tol rel {rel:.3e}")
        e5d = max([e5d] + [float((getattr(got, k) - getattr(want, k)).abs().max())
                           for k in fields])
    L, cap, C = 120, 64, 2
    sp = seeded(tad.gk_pool_seed, L, cap, C, ra, rb, rn, 1, shapes[1][7])
    chunk = [torch.as_tensor(rng.random((L, C)), device=dev) for _ in range(5)]
    cnt = torch.full((L,), 30.0, dtype=torch.float64, device=dev)
    seed_args = (sp, 4, *chunk, cnt, rn, shapes[1][7])
    t5d = {"ms": cuda_ms(lambda: tad.gk_pool_seed(*seed_args), 200),
           "plain_ms": cuda_ms(lambda: tad.gk_pool_seed_plain(*seed_args), 50)}
    b5d = bound(L * cap * 2, nbytes(*chunk, cnt, rn, shapes[1][7]) + 5 * L * C * 8 + 2 * L * cap * 8
                + L * 4 * 8)
    print(f"K6 coarsen_pool vs plain: identical a2, b2, n2 (max|d| {e6:.3e}) on {'; '.join(merged)}; "
          f"at 1 lane x cap "
          f"{cap_o}: {t6['ms']:.4f} ms (plain {t6['plain_ms']:.4f}; bound {b6[0]:.6f} ms by {b6[1]}). "
          f"K5 seed vs plain: identical seeded pools, max|d| over pools, totals and tol {e5d:.3e} (outer: "
          f"{-(-n0h // 8)} chunks of 8 into cap "
          f"{cap_o}; mid: 120 lanes x cap 64, C = 2); at 120 x 64: {t5d['ms']:.4f} ms (plain "
          f"{t5d['plain_ms']:.4f}; bound {b5d[0]:.6f} ms by {b5d[1]})", flush=True)

    # 10, call 2: the midpoints, as the next interpolation frontier -----------------
    mids = (oms[:-1] + oms[1:]) / 2
    c2 = run(sweep, mids)
    d_ptr2 = solve(IntegralProblem(dos_integrand(h, ETA), bz, torch.as_tensor(mids, device=dev)),
                   PTR(npt=400)).u.cpu().numpy()
    dptr2 = float(np.max(np.abs(c2["d"] - d_ptr2)))
    print(f"warm call 2 vs PTR(npt=400) at the midpoints: max|d| {dptr2:.4e} (<= "
          f"{1e-2 * np.max(np.abs(d_ptr2)):.4e}); both calls: {c1['wall'] + c2['wall']:.3f} s for "
          f"{len(oms) + len(mids)} omegas", flush=True)
    if not dptr2 <= 1e-2 * np.max(np.abs(d_ptr2)):
        fail(f"warm IAI and PTR(npt=400) differ by {dptr2:.3e} at the midpoints")
    total = {k: c1["launches"][k] + c2["launches"][k] for k in c1["launches"]}
    if min(total.values()) <= 0:
        fail(f"the warm IAI main path did not go through every kernel: {total}")
    if "--profile" in sys.argv[1:]:
        profile("warm IAI chunk", lambda: warm_sweep(IAI_OMEGAS)(oms))

    # the warm chain on the plain versions, at the two cheapest neighbours
    i = int(np.argmin(cold["ne"]))
    j = i + 1 if i + 1 < len(oms) and (i == 0 or cold["ne"][i + 1] <= cold["ne"][i - 1]) else i - 1
    pair = np.sort(oms[[i, j]])
    res = []
    for plain in (False, True):
        t0 = time.perf_counter()
        sw = warm_sweep(2, plain)
        res.append((sw(pair), sw.numevals, pool_to_arrays(sw._pool), sw.retcode, time.perf_counter() - t0))
    (dk, nk, pk, rk, tk), (dp, npl, pp, rp, tp) = res
    same_pool = (pk[3] == pp[3] and pk[4][3] == pp[4][3] and np.array_equal(pk[0], pp[0])
                 and np.array_equal(pk[1], pp[1]) and np.array_equal(pk[4][0], pp[4][0]))
    dpair = float(np.max(np.abs(dk - dp)))
    print(f"warm chain on the plain versions at omegas {pair.round(4).tolist()}: numevals {npl} vs {nk} "
          f"(kernels), carried pools identical {same_pool}, max|d D| {dpair:.3e} (<= abstol); "
          f"plain {tp:.3f} s, kernels {tk:.3f} s", flush=True)
    if not (npl == nk and same_pool and dpair <= IAI_ABSTOL and rk and rp):
        fail(f"warm IAI kernels vs plain path: numevals {nk} vs {npl}, pools {same_pool}, max|d| {dpair:.3e}")

    return [
        {"name": "coarsen_pool", "route": "cuda", "source": src + "gk_coarsen.cu",
         "replaces": "autobzcore_tpu/ops/adaptive.py:143", "launches": total["coarsen_pool"],
         "max_abs_err": e6, "ms": t6["ms"], "plain_ms": t6["plain_ms"], "bound_ms": b6[0],
         "bound_by": b6[1], "library_ms": None},
        {"name": "gk_pool_seed", "route": "cuda", "source": src + "gk_pool.cu",
         "replaces": "autobzcore_tpu/ops/adaptive.py:344", "launches": total["gk_pool_seed"],
         "max_abs_err": e5d, "ms": t5d["ms"], "plain_ms": t5d["plain_ms"], "bound_ms": b5d[0],
         "bound_by": b5d[1], "library_ms": None},
    ]


def fullgrid_phases(np, torch, dev, h, cold):
    """Phases 11-13: K7, K8 and K9 against their plain versions, the
    full-grid ladder main path and the bench lane. Returns the three
    kernels' JSON entries."""
    from autobzcore_torch import FBZ, DOSProblem, load_bz
    from autobzcore_torch.dos import LorentzianFullGrid
    from autobzcore_torch.dos import init as dos_init
    from autobzcore_torch.ops import eigh3
    from autobzcore_torch.ops import grid_sweep as gs
    from autobzcore_torch.ops.fourier_eval import evaluate_grid

    src = "autobzcore_torch/csrc/"
    eta = ETA
    ws = np.linspace(*WINDOW, FULLGRID_OMEGAS)
    bz = load_bz(FBZ(), np.eye(3))
    det_b = abs(float(np.linalg.det(bz.B)))
    u100 = [np.arange(NPT) / NPT] * 3

    # 11. K9, K8, K7 against their plain versions ----------------------------------
    Hg = evaluate_grid(h.c, 3, u100, h.offset, h.period).reshape(-1, 3, 3).contiguous()
    K = Hg.shape[0]
    e9 = eigh3.eigvalsh_small(Hg)
    p9 = eigh3.eigvalsh_small_plain(Hg)
    torch.cuda.synchronize()
    scale9 = float(p9.abs().max())
    err9 = float((e9 - p9).abs().max())
    sub = torch.arange(0, K, max(1, K // 4096), device=dev)[:4096]
    err9np = float(np.abs(e9[sub].cpu().numpy() - np.linalg.eigvalsh(Hg[sub].cpu().numpy())).max())
    if not (err9 <= 1e-12 * scale9 and err9np <= 1e-12 * scale9):
        fail(f"K9 eigvalsh_small: max|d| vs plain {err9:.3e}, vs numpy {err9np:.3e} > 1e-12 x {scale9:.3e}")
    t9 = {"ms": cuda_ms(lambda: eigh3.eigvalsh_small(Hg), 20),
          "plain_ms": cuda_ms(lambda: eigh3.eigvalsh_small_plain(Hg), 5)}
    # the library: torch.linalg.eigvalsh, whose batched cuSOLVER path refuses
    # large batches; the largest batch it takes, then all K in such batches
    refused, lib_batch = [], None
    for B in (K, 1 << 18, 1 << 16, 1 << 15, 1 << 14, 1 << 13, 1 << 12):
        try:
            torch.linalg.eigvalsh(Hg[:B])
            torch.cuda.synchronize()
            lib_batch = B
            break
        except RuntimeError as ex:
            refused.append(f"{B}: {str(ex).splitlines()[0][:60]}")
    if lib_batch is None:
        fail(f"torch.linalg.eigvalsh refused every batch tried: {refused}")
    lib_one = cuda_ms(lambda: torch.linalg.eigvalsh(Hg[:lib_batch]), 5)
    elib = float((eigh3.eigvalsh_chunked(Hg, lib_batch) - p9).abs().max())
    t9["library_ms"] = cuda_ms(lambda: eigh3.eigvalsh_chunked(Hg, lib_batch), 2)
    b9 = bound(K * EIG3_FLOPS, nbytes(Hg, e9))
    print(f"K9 eigvalsh_small: {K} flagship 3x3 matrices (100^3 grid): max|d| vs plain {err9:.3e}, vs numpy "
          f"on 4096 {err9np:.3e} (<= 1e-12 x {scale9:.4f}); {t9['ms']:.4f} ms (plain {t9['plain_ms']:.4f}; "
          f"bound {b9[0]:.4f} ms by {b9[1]}); torch.linalg.eigvalsh refused {refused or 'nothing'}, took "
          f"{lib_batch} in {lib_one:.4f} ms, all {K} in batches of {lib_batch}: {t9['library_ms']:.4f} ms "
          f"(max|d| {elib:.3e})", flush=True)

    om = torch.as_tensor(ws, device=dev)
    k8 = gs.lorentzian_sum(e9, None, om, eta, 1 / (math.pi * K))
    k8b = gs.lorentzian_sum(e9, None, om, eta, 1 / (math.pi * K))
    p8 = gs.lorentzian_sum_plain(e9, None, om, eta, 1 / (math.pi * K))
    torch.cuda.synchronize()
    err8 = float((k8 - p8).abs().max())
    if not (err8 <= 1e-12 * float(p8.abs().max()) and torch.equal(k8, k8b)):
        fail(f"K8 lorentzian_sum vs plain: max|d| {err8:.3e}, repeat identical {torch.equal(k8, k8b)}")
    t8 = {"ms": cuda_ms(lambda: gs.lorentzian_sum(e9, None, om, eta), 10),
          "plain_ms": cuda_ms(lambda: gs.lorentzian_sum_plain(e9, None, om, eta), 2)}
    b8 = bound(e9.numel() * FULLGRID_OMEGAS * LORENTZ_FLOPS, nbytes(e9, om) + 8 * FULLGRID_OMEGAS)
    print(f"K8 lorentzian_sum: ({K}, 3) eigenvalues x {FULLGRID_OMEGAS} omegas: max|d| vs plain {err8:.3e} "
          f"(<= 1e-12 max|D|), repeat bit-identical; {t8['ms']:.4f} ms (plain {t8['plain_ms']:.4f}; bound "
          f"{b8[0]:.4f} ms by {b8[1]})", flush=True)
    del p9

    # K7: one slab of the npt = 400 rung at the ladder's padded width
    fg = LorentzianFullGrid(eta, nmin=FULLGRID_NMIN, nmax=FULLGRID_NMAX)
    cache = dos_init(DOSProblem(h, ws, bz), fg, abstol=FULLGRID_ABSTOL)
    eng = fg._engine(cache.cacheval, ws)
    W = eng.omegas.size
    prep = eng._prepare(FULLGRID_NMIN)
    planes, wrow = eng.slab_planes(prep, prep["nslab"] // 2)

    def tail(fn):
        return fn(planes, 3, wrow, FULLGRID_NMIN, eng._om, eta, torch.zeros(W, dtype=torch.float64, device=dev))

    k7, k7b, p7 = tail(gs.fullgrid_tail), tail(gs.fullgrid_tail), tail(gs.fullgrid_tail_plain)
    torch.cuda.synchronize()
    err7 = float((k7 - p7).abs().max())
    rel7 = err7 / float(p7.abs().max())
    if not (rel7 <= 1e-12 and torch.equal(k7, k7b)):
        fail(f"K7 fullgrid_tail vs plain: max rel {rel7:.3e}, repeat identical {torch.equal(k7, k7b)}")
    t7 = {"ms": cuda_ms(lambda: tail(gs.fullgrid_tail), 10), "plain_ms": cuda_ms(lambda: tail(gs.fullgrid_tail_plain), 1)}
    npts7 = planes.shape[1]
    b7 = bound(npts7 * (3 * W * LORENTZ_FLOPS + EIG3_FLOPS), nbytes(planes, wrow, eng._om) + 2 * 8 * W)
    print(f"K7 fullgrid_tail: one npt={FULLGRID_NMIN} slab ({npts7} points, {eng.slab} rows) x {W} omegas: max rel vs plain "
          f"{rel7:.3e} (<= 1e-12), repeat bit-identical; {t7['ms']:.4f} ms (plain {t7['plain_ms']:.4f}; bound "
          f"{b7[0]:.4f} ms by {b7[1]})", flush=True)
    del planes, prep, Hg, e9
    torch.cuda.empty_cache()

    # 12. the full-grid ladder main path -------------------------------------------
    # the stage products' own time over the npt = 400 rung's slabs
    prep = eng._prepare(FULLGRID_NMIN)
    t_stages = cuda_ms(lambda: [eng.slab_planes(prep, i) for i in range(prep["nslab"])], 2)
    # their bound: the complex products' operations (8 per multiply-add) and
    # bytes (I3 and the phase tables read, every slab's planes written once)
    S, n1, n2, ne, npt0 = eng.slab, eng.n1, eng.n2, eng.ne, FULLGRID_NMIN
    nslab = prep["nslab"]
    b_st = bound(nslab * 8 * (S * n1 * n2 * ne * npt0 + ne * npt0 * n2 * S * npt0),
                 nbytes(prep["I3"], prep["P1"], prep["P2"]) + nslab * ne * npt0 * S * npt0 * 16)
    # the whole rung: every point's eigenvalues and Lorentzian terms, and the
    # stage products; it reads the coefficients and writes W values
    b_rung = bound(npt0**3 * (3 * W * LORENTZ_FLOPS + EIG3_FLOPS) + b_st[0] * PEAK_FP64 / 1e3,
                   nbytes(eng.c6) + 2 * 8 * W)
    del prep
    fg = LorentzianFullGrid(eta, nmin=FULLGRID_NMIN, nmax=FULLGRID_NMAX)
    cache = dos_init(DOSProblem(h, ws, bz), fg, abstol=FULLGRID_ABSTOL)
    gs.fullgrid_tail.launches = gs.lorentzian_sum.launches = eigh3.eigvalsh_small.launches = 0
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    D, ok = fg.dos_sweep(cache.cacheval, ws, abstol=FULLGRID_ABSTOL, with_status=True)
    D = D * det_b
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    launches12 = gs.fullgrid_tail.launches
    peak = torch.cuda.max_memory_allocated() / 2**20
    log = list(cache.cacheval["rung_log"])
    nev = sum(r["npt"] ** 3 for r in log)
    i125 = int(np.argmin(np.abs(ws - 0.5)))
    rung_txt = "; ".join(f"npt {r['npt']}: {r['seconds']:.3f} s, delta "
                         + ("-" if r["delta"] is None else f"{r['delta']:.3e}") for r in log)
    print(f"full-grid main path: flagship FBZ, eta {eta}, {FULLGRID_OMEGAS} omegas in {list(WINDOW)}, abstol "
          f"{FULLGRID_ABSTOL}: wall {wall:.3f} s; rungs [{rung_txt}]; retcode {ok}; numevals {nev}; K7 "
          f"launches {launches12}; stage products of the npt={FULLGRID_NMIN} rung {t_stages:.3f} ms (bound "
          f"{b_st[0]:.3f} ms by {b_st[1]}); rung bound {b_rung[0]:.3f} ms by {b_rung[1]}; peak device memory "
          f"{peak:.1f} MiB; hint {cache.cacheval.get('ladder_hint')}; DOS({ws[i125]:.4f}) = {D[i125]:.6f}",
          flush=True)
    if launches12 <= 0:
        fail("the full-grid main path did not go through K7")
    if not ok or D.shape != (FULLGRID_OMEGAS,) or not np.all(np.isfinite(D)):
        fail(f"full-grid ladder: retcode {ok}, shape {D.shape}")
    if "--profile" in sys.argv[1:]:
        def ladder():
            f2 = LorentzianFullGrid(eta, nmin=FULLGRID_NMIN, nmax=FULLGRID_NMAX)
            c2 = dos_init(DOSProblem(h, ws, bz), f2, abstol=FULLGRID_ABSTOL)
            f2.dos_sweep(c2.cacheval, ws, abstol=FULLGRID_ABSTOL)

        profile("full-grid main path", ladder)

    # the npt = 400 rung at phase 7's 33 omegas against PTR(npt=400): the same
    # nodes arange(npt)/npt, reached through K1 + K2's adjugate trace
    e33 = gs.FullGridSpectralSweep(h, cold["oms"], eta)
    d33 = det_b * e33.rung(FULLGRID_NMIN) / FULLGRID_NMIN**3
    dmax = float(np.max(np.abs(cold["d_ptr"])))
    dptr = float(np.max(np.abs(d33 - cold["d_ptr"])))
    print(f"full-grid npt={FULLGRID_NMIN} rung vs PTR(npt={FULLGRID_NMIN}) at {len(cold['oms'])} omegas: max|d| {dptr:.3e} (<= 1e-10 "
          f"max|D| = {1e-10 * dmax:.3e})", flush=True)
    if not dptr <= 1e-10 * dmax:
        fail(f"the full-grid rung and PTR(npt={FULLGRID_NMIN}) differ by {dptr:.3e}")

    # a second sweep at the midpoints replays the certifying pair
    hint = cache.cacheval["ladder_hint"]
    mids = (ws[:-1] + ws[1:]) / 2
    t0 = time.perf_counter()
    sol = fg.dos_solve(h, mids, bz, cache.cacheval, abstol=FULLGRID_ABSTOL)
    t_mid = time.perf_counter() - t0
    want = hint[0] ** 3 + hint[1] ** 3
    print(f"full-grid sweep at the {mids.size} midpoints: numevals {sol.numevals} (the pair {hint[:2]}: "
          f"{want}), retcode {sol.retcode}, {t_mid:.3f} s", flush=True)
    if not (sol.retcode and sol.numevals == want and np.all(np.isfinite(sol.u))):
        fail(f"the midpoint sweep did not replay the certifying pair: numevals {sol.numevals} vs {want}")

    # an npt = 64 rung through the plain tail against the kernel's
    wpad = eng.omegas
    t64 = []
    for plain in (False, True):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        t64.append(gs.FullGridSpectralSweep(h, wpad, eta, plain_kernels=plain).rung(FULLGRID_PLAIN_NPT))
        t64.append(time.perf_counter() - t0)
    r_k, tk64, r_p, tp64 = t64
    rel64 = float(np.max(np.abs(r_k - r_p)) / np.max(np.abs(r_p)))
    print(f"full-grid npt={FULLGRID_PLAIN_NPT} rung, kernel vs plain tail at {wpad.size} omegas: max rel {rel64:.3e} "
          f"(<= 1e-12); kernel tail {tk64 * 1e3:.2f} ms, plain tail {tp64 * 1e3:.2f} ms", flush=True)
    if not rel64 <= 1e-12:
        fail(f"the npt={FULLGRID_PLAIN_NPT} rung's kernel and plain tails differ by {rel64:.3e}")
    torch.cuda.empty_cache()

    # 13. the bench lane: H(k) + eigenvalues, then the 1000-omega sweep -------------
    gs.fullgrid_tail.launches = gs.lorentzian_sum.launches = eigh3.eigvalsh_small.launches = 0
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    e = eigh3.eigvalsh_small(evaluate_grid(h.c, 3, u100, h.offset, h.period).reshape(-1, 3, 3))
    torch.cuda.synchronize()
    t_one = time.perf_counter() - t0
    reps = 20
    t0 = time.perf_counter()
    chk = torch.zeros((), dtype=torch.float64, device=dev)
    for _ in range(reps):
        chk = chk + eigh3.eigvalsh_small(evaluate_grid(h.c, 3, u100, h.offset, h.period).reshape(-1, 3, 3)).sum()
    float(chk)
    t_amort = (time.perf_counter() - t0) / reps
    omb = torch.linspace(10.0, 15.0, 1000, dtype=torch.float64, device=dev)
    d = gs.lorentzian_sum(e, None, omb, 0.01, 1 / (math.pi * e.shape[0]))
    float(d.sum())
    t0 = time.perf_counter()
    d = gs.lorentzian_sum(e, None, omb, 0.01, 1 / (math.pi * e.shape[0]))
    float(d.sum())
    t_sweep = (time.perf_counter() - t0) * 1e3
    launches13 = {"eigvalsh_small": eigh3.eigvalsh_small.launches, "lorentzian_sum": gs.lorentzian_sum.launches}
    print(f"bench lane: flagship H(k) + K9 eigenvalues on the {NPT}^3 grid: one pass {t_one * 1e3:.3f} ms, "
          f"{NPT**3 / t_amort:.4g} k-points/s over {reps} chained passes; 1000-omega sweep [10, 15] eV, eta "
          f"0.01, by K8: {t_sweep:.3f} ms (max D {float(d.max()):.4e}, finite {bool(torch.isfinite(d).all())}); "
          f"launches {launches13}", flush=True)
    if min(launches13.values()) <= 0 or not bool(torch.isfinite(d).all()):
        fail(f"the bench lane did not go through K8 and K9: {launches13}")

    return [
        {"name": "fullgrid_tail", "route": "cuda", "source": src + "fullgrid_tail.cu",
         "replaces": "autobzcore_tpu/ops/grid_sweep.py:259", "launches": launches12, "max_abs_err": err7,
         "ms": t7["ms"], "plain_ms": t7["plain_ms"], "bound_ms": b7[0], "bound_by": b7[1],
         "library_ms": None},
        {"name": "lorentzian_sum", "route": "cuda", "source": src + "lorentzian_sum.cu",
         "replaces": "autobzcore_tpu/ops/grid_sweep.py:289", "launches": launches13["lorentzian_sum"],
         "max_abs_err": err8, "ms": t8["ms"], "plain_ms": t8["plain_ms"], "bound_ms": b8[0],
         "bound_by": b8[1], "library_ms": None},
        {"name": "eigvalsh_small", "route": "cuda", "source": src + "eigh_small.cu",
         "replaces": "autobzcore_tpu/ops/eigh3.py:161", "launches": launches13["eigvalsh_small"],
         "max_abs_err": err9, "ms": t9["ms"], "plain_ms": t9["plain_ms"], "bound_ms": b9[0],
         "bound_by": b9[1], "library_ms": t9["library_ms"]},
    ]


def once_ms(fn):
    """Milliseconds of one run of ``fn()`` by CUDA events, no warm-up (for
    plain versions that take seconds)."""
    import torch

    torch.cuda.synchronize()
    start, stop = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    start.record()
    fn()
    stop.record()
    torch.cuda.synchronize()
    return start.elapsed_time(stop)


def band_grid(np, rng, m, npt, d):
    """A band-major grid (m, npt^d) of smooth periodic bands: a cosine band
    (with exact ties) and m - 1 random ones."""
    x = np.meshgrid(*[np.arange(npt) / npt] * d, indexing="ij")
    bands = [sum(np.cos(2 * np.pi * xi) for xi in x)]
    for _ in range(m - 1):
        ph = rng.random(d)
        bands.append(sum(rng.normal() * np.cos(2 * np.pi * (xi + q)) for xi, q in zip(x, ph)) + rng.normal())
    return np.stack([b.reshape(-1) for b in bands])


def ltm_phases(np, torch, dev, h):
    """Phases 14-15: K10 against its plain version, then the LTM main path.
    Returns K10's JSON entry."""
    from autobzcore_torch import FBZ, CubicSymIBZ, DOSProblem, load_bz
    from autobzcore_torch.dos import LTM
    from autobzcore_torch.dos import init as dos_init
    from autobzcore_torch.dos import solve_ as dos_solve_
    from autobzcore_torch.dos import tetrahedron as tet
    from autobzcore_torch.models.tight_binding import tb_integer
    from autobzcore_torch.ops import eigh3
    from autobzcore_torch.ops.fourier_eval import evaluate_grid

    src = "autobzcore_torch/csrc/"
    bz = load_bz(FBZ(), np.eye(3))
    ws = np.linspace(*WINDOW, LTM_ENERGIES)
    E = torch.as_tensor(ws, device=dev)

    # 14. K10 against its plain version ------------------------------------------
    cv = LTM(npt=NPT).init_cacheval(h, 0.0, bz)
    eg, tol, vol = cv["eg"], cv["tol"], cv["vol"]
    got = {nos: [tet.tetra_dos(eg, 3, E, tol, vol, nos) for _ in range(2)] for nos in (False, True)}
    sub = np.round(np.linspace(0, LTM_ENERGIES - 1, 64)).astype(np.int64)
    p_dos = tet.tetra_dos_plain(eg, 3, E, tol, vol)
    p_nos = tet.tetra_dos_plain(eg, 3, E[sub], tol, vol, nos=True)
    torch.cuda.synchronize()
    err10 = float((got[False][0] - p_dos).abs().max())
    rel = {"dos": err10 / float(p_dos.abs().max()),
           "nos": float((got[True][0][sub] - p_nos).abs().max() / p_nos.abs().max())}
    same = all(torch.equal(a, b) for a, b in got.values())
    if not (max(rel.values()) <= 1e-12 and same):
        fail(f"K10 tetra_dos vs plain at the flagship: max rel {rel}, repeat identical {same}")
    small = []
    rng = np.random.default_rng(14)
    for d, npt, m in ((1, 4096, 3), (2, 256, 2)):
        g = torch.as_tensor(band_grid(np, rng, m, npt, d), device=dev).contiguous()
        lo, hi = float(g.min()), float(g.max())
        Es = torch.linspace(lo - 0.5, hi + 0.5, LTM_ENERGIES, dtype=torch.float64, device=dev)
        t_, v_ = 1e-9 * (hi - lo), 1.0 / (len(tet._SIMPLICES[d]) * npt**d)
        for nos in (False, True):
            k = tet.tetra_dos(g, d, Es, t_, v_, nos)
            pl = tet.tetra_dos_plain(g, d, Es, t_, v_, nos)
            r = float((k - pl).abs().max() / pl.abs().max())
            if not (r <= 1e-12 and torch.equal(k, tet.tetra_dos(g, d, Es, t_, v_, nos))):
                fail(f"K10 at d={d}, npt={npt}, m={m}, nos={nos}: max rel {r:.3e} or repeat differs")
            small.append(r)
    t10 = {"ms": cuda_ms(lambda: tet.tetra_dos(eg, 3, E, tol, vol), 5),
           "nos_ms": cuda_ms(lambda: tet.tetra_dos(eg, 3, E, tol, vol, True), 5),
           "plain_ms": once_ms(lambda: tet.tetra_dos_plain(eg, 3, E, tol, vol))}
    # the bound counts one support test per term and the closed form of the
    # (energy, term) pairs this energy grid puts inside the support; the
    # second reading repeats the test for every energy, as the kernel's
    # per-thread range test does at worst
    ec = tet.sorted_corners(eg, 3)
    n_terms = ec[0].numel()
    n_support = int((torch.searchsorted(E, ec[3].reshape(-1)) - torch.searchsorted(E, ec[0].reshape(-1))).sum())
    del ec
    b10 = bound(n_terms * TETRA_TEST_FLOPS + n_support * TETRA_SUPPORT_FLOPS, nbytes(eg, E) + 8 * LTM_ENERGIES)
    b10_each = bound(LTM_ENERGIES * n_terms * TETRA_TEST_FLOPS + n_support * TETRA_SUPPORT_FLOPS,
                     nbytes(eg, E) + 8 * LTM_ENERGIES)
    print(f"K10 tetra_dos: flagship eigenvalue grid (3, {NPT}^3), {n_terms} (simplex, band) terms x "
          f"{LTM_ENERGIES} energies ({n_support} inside their support): max rel vs plain DOS {rel['dos']:.3e}, "
          f"N(E) on 64 energies {rel['nos']:.3e} (<= 1e-12), d=1,2 small grids {max(small):.3e}; repeat "
          f"bit-identical; DOS {t10['ms']:.4f} ms, N(E) {t10['nos_ms']:.4f} ms (plain DOS {t10['plain_ms']:.1f} ms; "
          f"bound {b10[0]:.4f} ms by {b10[1]}: {TETRA_TEST_FLOPS} operations per term and {TETRA_SUPPORT_FLOPS} per "
          f"pair in the support; {b10_each[0]:.4f} ms with the test repeated for every energy)", flush=True)
    del got, p_dos, p_nos, cv
    torch.cuda.empty_cache()

    # 15. the LTM main path ----------------------------------------------------------
    def ltm_path():
        ltm = LTM(npt=NPT)
        cache = dos_init(DOSProblem(h, 0.5, bz), ltm)
        torch.cuda.synchronize()
        t1 = time.perf_counter()
        D = ltm.dos_sweep(cache.cacheval, ws)
        t2 = time.perf_counter()
        N = ltm.nos_sweep(cache.cacheval, ws)
        t3 = time.perf_counter()
        ef = ltm.fermi_level(cache.cacheval, 1.5)
        return ltm, cache, D, N, ef, (t1, t2, t3, time.perf_counter())

    tet.tetra_dos.launches = eigh3.eigvalsh_small.launches = 0
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    ltm, cache, D, N, ef, (t1, t2, t3, t4) = ltm_path()
    launches = {"tetra_dos": tet.tetra_dos.launches, "eigvalsh_small": eigh3.eigvalsh_small.launches}
    peak = torch.cuda.max_memory_allocated() / 2**20
    u = [np.arange(NPT) / NPT] * 3
    t_grid = cuda_ms(lambda: evaluate_grid(h.c, 3, u, h.offset, h.period), 3)
    hk = evaluate_grid(h.c, 3, u, h.offset, h.period).reshape(-1, 3, 3)
    t_eig = cuda_ms(lambda: eigh3.eigvalsh_small(hk), 5)
    del hk
    integral = float(np.trapezoid(D, ws))
    eg = cache.cacheval["eg"]
    edges = np.concatenate([eg.min(1).values.cpu().numpy(), eg.max(1).values.cpu().numpy()])
    away = np.min(np.abs(ws[:, None] - edges[None]), axis=1) > 0.3
    dnd = float(np.max(np.abs(np.gradient(N, ws) - D)[away]))
    mono = float(np.min(np.diff(N)))
    print(f"LTM main path: flagship LTM(npt={NPT}), FBZ, {LTM_ENERGIES} energies in {list(WINDOW)}: init "
          f"{t1 - t0:.3f} s (grid products {t_grid:.3f} ms, K9 eigenvalues {t_eig:.3f} ms by event time; no "
          f"scatter on the full zone), dos_sweep {t2 - t1:.4f} s, nos_sweep {t3 - t2:.4f} s, fermi_level(1.5) "
          f"= {ef:.10f} in {t4 - t3:.4f} s; launches {launches}; peak device memory {peak:.1f} MiB; bands "
          f"{np.round(edges, 4).tolist()}", flush=True)
    if min(launches.values()) <= 0:
        fail(f"the LTM main path did not go through every kernel: {launches}")
    h1 = tb_integer(3, device=dev)
    vals = []
    for kind in (CubicSymIBZ(), FBZ()):
        vals.append(float(dos_solve_(dos_init(DOSProblem(h1, 0.8, load_bz(kind, np.eye(3))), LTM(npt=60))).u))
    rel_ibz = abs(vals[0] - vals[1]) / abs(vals[1])
    ws5 = np.array([-4.0, -1.0, 0.5, 2.0, 5.5])
    d5 = ltm.dos_sweep(cache.cacheval, ws5)
    p5 = tet.tetra_dos_plain(eg, 3, torch.as_tensor(ws5, device=dev), cache.cacheval["tol"],
                             cache.cacheval["vol"]).cpu().numpy()
    rel5 = float(np.max(np.abs(d5 - p5) / np.abs(p5)))
    print(f"LTM main path check: integral of D {integral:.10f} (3 within 2e-2); N(7 eV) {N[-1]:.15f} (3 within "
          f"1e-12); min step of N {mono:.3e} (monotone); max|dN/dE - D| {dnd:.3e} at {int(away.sum())} energies "
          f"0.3 eV from the band edges (<= 5e-2); tb_integer(3) npt=60 E=0.8: CubicSymIBZ {vals[0]:.15f} vs FBZ "
          f"{vals[1]:.15f} (rel {rel_ibz:.3e} <= 1e-12); 5 energies vs plain path: max rel {rel5:.3e} (<= 1e-12)",
          flush=True)
    if not (abs(integral - 3) <= 2e-2 and abs(N[-1] - 3) <= 1e-12 and mono >= -1e-12 and dnd <= 5e-2):
        fail(f"LTM checks: integral {integral}, N(7) {N[-1]}, monotone {mono}, dN/dE {dnd}")
    if not (rel_ibz <= 1e-12 and rel5 <= 1e-12 and np.all(np.isfinite(D)) and D.shape == ws.shape):
        fail(f"LTM checks: IBZ rel {rel_ibz:.3e}, 5 energies rel {rel5:.3e}")
    if "--profile" in sys.argv[1:]:
        profile("LTM main path", ltm_path)
    del cache, eg
    torch.cuda.empty_cache()
    return [{"name": "tetra_dos", "route": "cuda", "source": src + "tetra_dos.cu",
             "replaces": "autobzcore_tpu/dos/tetrahedron.py:68", "launches": launches["tetra_dos"],
             "max_abs_err": err10, "ms": t10["ms"], "plain_ms": t10["plain_ms"], "bound_ms": b10[0],
             "bound_by": b10[1], "library_ms": None}]


def block_phases(np, torch, dev, h, cold):
    """Phases 16-17: K4's block entry and K5 at V = W against their plain
    versions, then the omega-block IAI main path. Returns the block entry's
    JSON entry."""
    import copy

    from autobzcore_torch import IAI, IntegralProblem
    from autobzcore_torch.models.observables import dos_integrand, gk_leaf_dos, gk_leaf_dos_plain
    from autobzcore_torch.ops import adaptive as tad
    from autobzcore_torch.ops.fourier_eval import fourier_contract, fourier_contract_plain
    from autobzcore_torch.parallel.sweep import SweepSolver

    src = "autobzcore_torch/csrc/"
    rng = np.random.default_rng(16)
    xk, wk, wg = tad.gk_rule(7, dev)
    P = xk.shape[0]
    c0 = h.c.reshape((1, 5, 5, 5, 9)).contiguous()
    step = (WINDOW[1] - WINDOW[0]) / (IAI_OMEGAS - 1)

    # 16. K4's block entry and K5 at V = W ---------------------------------------------
    def leaf_inputs(L, W):
        """Flagship 1-D coefficients at random (x3, x2), 2 intervals per lane,
        W adjacent frequencies of phase 7's spacing per lane."""
        x3 = torch.as_tensor(rng.random((1, L)), device=dev)
        c2 = fourier_contract_plain(c0, torch.zeros(1, dtype=torch.int64, device=dev), x3,
                                    h.offset[2], 1.0).reshape(L, 5, 5, 9)
        x2 = torch.as_tensor(rng.random((L, 1)), device=dev)
        c1 = fourier_contract_plain(c2, torch.arange(L, device=dev), x2, h.offset[1], 1.0)
        a0 = torch.as_tensor(rng.random((L, 2)) * 0.5, device=dev)
        b0 = (a0 + torch.as_tensor(rng.random((L, 2)) * 0.5, device=dev)).contiguous()
        om = torch.as_tensor(rng.uniform(WINDOW[0], WINDOW[1] - W * step, (L, 1)) + step * np.arange(W),
                             device=dev).contiguous()
        return (c1.reshape(L, 5, 9).contiguous(), torch.arange(L, device=dev), h.offset[0], 1.0,
                a0.contiguous(), b0, om, torch.full_like(om, ETA), torch.ones(L, dtype=torch.bool, device=dev),
                xk, wk, wg)

    t16, e16 = {}, 0.0
    for W in BLOCKS:
        L = -(-IAI_OMEGAS // W) * (2 * P) ** 2  # leaf lanes of a full trip of the blocked chunk
        a = leaf_inputs(L, W)
        got, want = gk_leaf_dos(*a), gk_leaf_dos_plain(*a)
        l1 = want[2]
        e = max(float(((got[0] - want[0]).abs() / l1[..., None]).max()),
                float(((got[1] - want[1]).abs() / l1).max()))
        if not (e <= 1e-12 and torch.equal(got[3], want[3])
                and torch.allclose(got[2], l1, rtol=1e-12, atol=0)):
            fail(f"K4 block entry vs plain at W={W}: max |d val|, |d err| / l1 = {e:.3e} > 1e-12")
        e16 = max(e16, float((got[0] - want[0]).abs().max()), float((got[1] - want[1]).abs().max()))
        t16[W] = {"L": L, "rel": e, "ms": cuda_ms(lambda: gk_leaf_dos(*a), 50),
                  "plain_ms": cuda_ms(lambda: gk_leaf_dos_plain(*a), 5),
                  "bound": bound(L * 2 * P * (5 * (8 * 9 + 6) + W * (TRACE_FLOPS[3] + 9)),
                                 nbytes(*a[:2], *a[4:9]) + L * 2 * (W + 2) * 8 + L * 8)}
        del a, got, want

    def pool_v(L, nb, W):
        n = torch.as_tensor(rng.integers(1, 64 - nb + 3, L), device=dev)
        live = torch.arange(64, device=dev)[None, :] < n[:, None]
        zero = torch.zeros((), dtype=torch.float64, device=dev)
        a0 = torch.where(live, torch.as_tensor(rng.random((L, 64)), device=dev), zero)
        b0 = torch.where(live, a0 + torch.as_tensor(rng.random((L, 64)), device=dev), zero)
        err = torch.where(live, torch.as_tensor(rng.integers(0, 6, (L, 64)) * 0.125, device=dev), zero)
        val = torch.where(live[..., None], torch.as_tensor(rng.normal(size=(L, 64, W)), device=dev), zero)
        pool = tad.GKPool(a=a0, b=b0, err=err, l1=2 * err, val=val.contiguous(), n=n,
                          evals=torch.as_tensor(rng.integers(0, 2000, L).astype(np.float64), device=dev),
                          atol=torch.as_tensor(rng.random(L) * 4, device=dev), rtol=1e-3, max_evals=1500.0,
                          active=torch.as_tensor(rng.random(L) > 0.05, device=dev))
        tad.gk_pool_totals_plain(pool)
        return pool

    def clone(pool):
        return tad.GKPool(**{k: (v.clone() if isinstance(v, torch.Tensor) else v) for k, v in pool.__dict__.items()})

    t5 = {}
    for W in BLOCKS:
        L = t16[W]["L"]
        pool = pool_v(L, 4, W)
        ref = clone(pool)
        idx, ca, cb = tad.gk_pool_select(pool, 4)
        ridx, rca, rcb = tad.gk_pool_select_plain(ref, 4)
        base = clone(pool)  # after the select, which narrows `active`
        live = ref.active
        cval = torch.as_tensor(rng.normal(size=(L, 8, W)), device=dev)
        cerr = torch.as_tensor(rng.random((L, 8)), device=dev)
        count = torch.full((L,), 120.0, dtype=torch.float64, device=dev)
        tad.gk_pool_update(pool, 4, idx, ca, cb, cval, cerr, cerr, count)
        tad.gk_pool_update_plain(ref, 4, ridx, rca, rcb, cval, cerr, cerr, count)
        same = (torch.equal(idx[live], ridx[live]) and torch.equal(ca, rca)
                and all(torch.equal(getattr(pool, k), getattr(ref, k)) for k in ("a", "b", "err", "l1", "val", "n", "evals")))
        # the totals sum the pool in another order: hold them to the rounding
        # of that sum, relative to the sum of the magnitudes
        rel_t = float(((pool.tot_val - ref.tot_val).abs() / ref.val.abs().sum(1).clamp_min(1e-300)).max())
        fx = torch.as_tensor(rng.normal(size=(-(-IAI_OMEGAS // W) * 2 * P, 2, P, W)), device=dev)
        cnt = torch.as_tensor(rng.integers(100, 5000, fx.shape[:3]).astype(np.float64), device=dev)
        half = torch.as_tensor(rng.random(fx.shape[:2]), device=dev)
        gr, wr = tad.gk_rule_reduce(fx, cnt, half, wk, wg), tad.gk_rule_reduce_plain(fx, cnt, half, wk, wg)
        er = max(float((g - w).abs().max()) for g, w in zip(gr[:3], wr[:3])) / float(wr[2].max())
        if not (same and rel_t <= 1e-14 and er <= 1e-12 and torch.equal(gr[3], wr[3])):
            fail(f"K5 at V={W}: pools identical {same}, totals rel {rel_t:.3e}, rule reduce rel {er:.3e}")
        upd = (4, idx, ca, cb, cval, cerr, cerr, count)
        clone_ms = cuda_ms(lambda: clone(base), 20)
        t5[W] = {"update_ms": cuda_ms(lambda: tad.gk_pool_update(clone(base), *upd), 20) - clone_ms,
                 "update_plain_ms": cuda_ms(lambda: tad.gk_pool_update_plain(clone(base), *upd), 5) - clone_ms,
                 "rel": max(rel_t, er)}
        del pool, ref, base, fx, cnt
    print("K4 block entry vs plain: " + "; ".join(
        f"W={W}: {t16[W]['L']} lanes x 2 intervals, max |d|/l1 {t16[W]['rel']:.3e} (<= 1e-12), "
        f"{t16[W]['ms']:.4f} ms (plain {t16[W]['plain_ms']:.4f}; bound {t16[W]['bound'][0]:.4f} ms by "
        f"{t16[W]['bound'][1]})" for W in BLOCKS) + ". K5 at V=W: identical pools; " + "; ".join(
        f"V={W}: update {t5[W]['update_ms']:.4f} ms (plain {t5[W]['update_plain_ms']:.4f}), totals and rule "
        f"reduce rel {t5[W]['rel']:.3e}" for W in BLOCKS), flush=True)
    torch.cuda.empty_cache()

    # 17. the omega-block IAI main path --------------------------------------------
    bz, oms = cold["bz"], cold["oms"]
    prob = IntegralProblem(dos_integrand(h, ETA), bz)
    dmax = float(np.max(np.abs(cold["d_ptr"])))

    def reset():
        fourier_contract.launches = gk_leaf_dos.launches = 0
        tad.gk_rule_reduce.launches = 0
        for key in tad.gk_pool_launches:
            tad.gk_pool_launches[key] = 0

    def blocked(W, plain=False, warm=False, chunk=BLOCK_CHUNK):
        return SweepSolver(prob, IAI(inner_cap=64, inner_nbisect=4, plain_kernels=plain,
                                     warm_width=8 if warm else None, device=dev),
                           abstol=IAI_ABSTOL, chunk=chunk, scan=True, block=W, warm=warm)

    total_block_launches, res = 0, {}
    for W in BLOCKS:
        walls = []
        for r in range(BLOCK_WALL_RUNS):
            reset()
            torch.cuda.synchronize()
            torch.cuda.reset_peak_memory_stats()
            t0 = time.perf_counter()
            sw = blocked(W)
            d = sw(oms)
            torch.cuda.synchronize()
            walls.append(time.perf_counter() - t0)
            if r == 0:
                launches = {"fourier_contract": fourier_contract.launches,
                            "gk_leaf_dos_block": gk_leaf_dos.launches,
                            "gk_pool_select": tad.gk_pool_launches["select"],
                            "gk_pool_update": tad.gk_pool_launches["update"] + tad.gk_pool_launches["totals"],
                            "gk_rule_reduce": tad.gk_rule_reduce.launches}
                peak = torch.cuda.max_memory_allocated() / 2**20
                first = (d, sw.numevals, sw.retcode, copy.deepcopy(sw.stats), sw.block_certificates)
        d, ne, ok, st, bc = first
        total_block_launches += launches["gk_leaf_dos_block"]
        dcold = float(np.max(np.abs(d - cold["d"])))
        dptr = float(np.max(np.abs(d - cold["d_ptr"])))
        res[W] = {"walls": walls, "numevals": ne}
        print(f"block IAI main path, block={W}: {IAI_OMEGAS} omegas (chunk {BLOCK_CHUNK}, {len(bc[0])} real blocks), "
              f"walls {', '.join(f'{w:.3f}' for w in walls)} s (phase 7, block 1: {cold['wall']:.3f} s); numevals "
              f"{ne} ({ne / IAI_OMEGAS:.4g} per omega; phase 7 {cold['numevals'] / IAI_OMEGAS:.4g}); retcode {ok}; "
              f"trips (level 3 outer, 2 mid, 1 leaf) {dict(sorted(st.trips.items(), reverse=True))}; host syncs "
              f"{st.syncs}; launches {launches}; peak device memory {peak:.1f} MiB; vs phase 7 max|d| {dcold:.3e} "
              f"(<= 2 abstol); vs PTR(npt=400) max|d| {dptr:.4e} (<= {1e-2 * dmax:.4e})", flush=True)
        if min(launches.values()) <= 0:
            fail(f"the block IAI main path did not go through every kernel: {launches}")
        if not (ok and d.shape == (IAI_OMEGAS,) and dcold <= 2 * IAI_ABSTOL and dptr <= 1e-2 * dmax):
            fail(f"block={W} IAI: retcode {ok}, vs phase 7 {dcold:.3e}, vs PTR {dptr:.3e}")
    if "--profile" in sys.argv[1:]:
        profile("block IAI main path (block=2)", lambda: blocked(2)(oms))

    # the warm block chain on the plain versions, at the two cheapest neighbours
    i = int(np.argmin(cold["ne"]))
    j = i + 1 if i + 1 < len(oms) and (i == 0 or cold["ne"][i + 1] <= cold["ne"][i - 1]) else i - 1
    pair = np.sort(oms[[i, j]])
    out = []
    for plain in (False, True):
        t0 = time.perf_counter()
        sw = blocked(2, plain=plain, warm=True, chunk=2)
        out.append((sw(pair), sw.numevals, sw.block_certificates, sw.retcode, time.perf_counter() - t0))
    (dk, nk, bk, rk, tk), (dp, npl, bp, rp, tp) = out
    same_bc = all(np.array_equal(a, b) for a, b in zip(bk, bp))
    dpair = float(np.max(np.abs(dk - dp)))
    print(f"warm block chain (block 2) on the plain versions at omegas {pair.round(4).tolist()}: numevals {npl} vs "
          f"{nk} (kernels), block certificates identical {same_bc} ({bk[1].tolist()}), max|d D| {dpair:.3e} (<= "
          f"abstol); plain {tp:.3f} s, kernels {tk:.3f} s", flush=True)
    if not (npl == nk and same_bc and dpair <= IAI_ABSTOL and rk and rp):
        fail(f"warm block chain kernels vs plain: numevals {nk} vs {npl}, certificates {same_bc}, max|d| {dpair:.3e}")
    W0 = BLOCKS[0]
    return [{"name": "gk_leaf_dos_block", "route": "cuda", "source": src + "gk_leaf_dos.cu",
             "replaces": "autobzcore_tpu/models/observables.py:138", "launches": total_block_launches,
             "max_abs_err": e16, "ms": t16[W0]["ms"], "plain_ms": t16[W0]["plain_ms"],
             "bound_ms": t16[W0]["bound"][0], "bound_by": t16[W0]["bound"][1], "library_ms": None}]


def repair_phases(np, torch, dev):
    """Phase 18: the PTR sum above three bands through eigvalsh + K8, and
    K2's grid-stride loop against the uncapped launch. Returns the entry of
    the m > 3 route (K8 after batched eigvalsh)."""
    from autobzcore_torch import FBZ, PTR, IntegralProblem, init, load_bz, solve_
    from autobzcore_torch.models import observables as obs
    from autobzcore_torch.models.tight_binding import synthetic_wannier
    from autobzcore_torch.ops import eigh3
    from autobzcore_torch.ops import grid_sweep as gs

    npt, m = 60, 4
    om = torch.linspace(-4.0, 4.0, W_FLAGSHIP, dtype=torch.float64, device=dev)
    prob = IntegralProblem(obs.dos_integrand(synthetic_wannier(m, device=dev), ETA), load_bz(FBZ(), np.eye(3)), om)
    gs.lorentzian_sum.launches = obs.dos_trace_weighted_sum.launches = 0
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    cache = init(prob, PTR(npt=npt, device=dev))
    u = solve_(cache).u
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    launches = {"lorentzian_sum": gs.lorentzian_sum.launches, "dos_trace_weighted_sum": obs.dos_trace_weighted_sum.launches}
    w, H = cache.cacheval["inner"]["consts"]
    eta = torch.full_like(om, ETA)
    sc = (2 * math.pi) ** 3 / npt**3
    plain = obs.dos_trace_weighted_sum_plain(H, w, om, eta, sc)
    err18 = float((u - plain).abs().max())
    rel = err18 / float(plain.abs().max())
    # the route by event time, split into cuSOLVER's eigenvalues and K8
    e = eigh3.eigvalsh_chunked(H)
    t18 = {"ms": cuda_ms(lambda: obs.dos_eig_weighted_sum(H, w, om, eta, sc), 5),
           "eig_ms": cuda_ms(lambda: eigh3.eigvalsh_chunked(H), 5),
           "k8_ms": cuda_ms(lambda: gs.lorentzian_sum(e, w, om, ETA, sc / math.pi), 10),
           "k8_plain_ms": cuda_ms(lambda: gs.lorentzian_sum_plain(e, w, om, ETA, sc / math.pi), 3),
           "plain_ms": cuda_ms(lambda: obs.dos_trace_weighted_sum_plain(H, w, om, eta, sc), 2)}
    # the eigenvalues counted as the (16/3) m^3 real operations of the
    # Householder reduction of a Hermitian matrix (the QL iteration left out)
    K = H.shape[0]
    b18 = bound(K * 16 * m**3 / 3 + K * m * W_FLAGSHIP * LORENTZ_FLOPS, nbytes(H, w, om, eta) + 8 * W_FLAGSHIP)
    del e
    rng = np.random.default_rng(18)
    K2 = 1_000_000
    H3 = torch.as_tensor(random_hermitian(rng, K2, 3), device=dev)
    w3 = torch.as_tensor(rng.random(K2), device=dev)
    full = obs._dos_trace_launch(H3, w3, om, eta, 1.0, obs.DOS_GRID_CAP)
    capped = obs._dos_trace_launch(H3, w3, om, eta, 1.0, 7)
    torch.cuda.synchronize()
    print(f"repairs: PTR(npt={npt}) of synthetic_wannier({m}) at {W_FLAGSHIP} omegas through eigvalsh + K8 in "
          f"{wall:.3f} s, launches {launches}, max rel vs the plain trace path {rel:.3e} (<= 1e-10); the route "
          f"on its {K} k-points by event time {t18['ms']:.4f} ms (cuSOLVER eigvalsh {t18['eig_ms']:.4f} ms, K8 "
          f"{t18['k8_ms']:.4f} ms, K8's plain version {t18['k8_plain_ms']:.4f} ms), the plain trace path "
          f"{t18['plain_ms']:.4f} ms, bound {b18[0]:.4f} ms by {b18[1]}; K2 at {K2} k-points with 7 block rows "
          f"looping over {-(-K2 // 4096)} chunks vs the uncapped launch: bit-identical {torch.equal(full, capped)}",
          flush=True)
    if not (rel <= 1e-10 and launches["lorentzian_sum"] > 0 and launches["dos_trace_weighted_sum"] == 0):
        fail(f"the m > 3 PTR sum: rel {rel:.3e}, launches {launches}")
    if not torch.equal(full, capped):
        fail("K2 with a capped grid differs from the uncapped launch")
    return [{"name": "dos_eig_weighted_sum", "route": "cuda", "source": "autobzcore_torch/csrc/lorentzian_sum.cu",
             "replaces": "autobzcore_tpu/models/observables.py:145", "launches": launches["lorentzian_sum"],
             "max_abs_err": err18, "ms": t18["ms"], "plain_ms": t18["plain_ms"], "bound_ms": b18[0],
             "bound_by": b18[1], "library_ms": None}]


if __name__ == "__main__":
    main()
