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
   the kernels (identical counts and carried pools, values within abstol).

With ``--profile``, the PTR, IAI and warm IAI main paths each run once more
under ``torch.profiler`` (after their checks), which prints their device
busy time, its share of the wall and the device time of the leading
kernels.

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


if __name__ == "__main__":
    main()
