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
   and plain times at the flagship shapes (K = 1e6 points, W = 264);
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
   retcode, 3 frequencies against the same solve on the plain versions
   (within abstol) and all 33 against PTR(npt=400) (within 1e-2 max|D|);
8. cubic IBZ through IAI: tb_integer(3) on CubicSymIBZ against the full
   zone at 4 frequencies, eta = 0.1, abstol 1e-3 (within 2 abstol).

With ``--profile``, the PTR and IAI main paths each run once more under
``torch.profiler`` (after their checks), which prints their device busy
time, its share of the wall and the device time of the leading kernels.

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
        from autobzcore_torch.ops.fourier_eval import fourier_points, fourier_points_plain
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
    print(f"kernels at K={Hg.shape[0]}, W={W_FLAGSHIP}: K1 {t['k1']:.3f} ms (plain "
          f"{t['k1_plain']:.3f} ms, max|dH| {k1_abs:.3e}); K2 {t['k2']:.3f} ms (plain "
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
         "library_ms": None},
        {"name": "dos_trace_weighted_sum", "route": "cuda", "source": src + "dos_trace.cu",
         "replaces": "autobzcore_tpu/models/observables.py:149",
         "launches": launches["dos_trace_weighted_sum"], "max_abs_err": k2_abs,
         "ms": t["k2"], "plain_ms": t["k2_plain"], "bound_ms": b2[0], "bound_by": b2[1],
         "library_ms": None},
    ]
    del Hg, Xg, wg
    torch.cuda.empty_cache()
    kernels += iai_phases(np, torch, dev, h)
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

    checks5 = []
    for L, nb in ((900, 1), (900, 4), (L_leaf, 1)):
        pool = random_pool(L, nb)
        ref = clone(pool)
        idx, ca, cb = tad.gk_pool_select(pool, nb)
        ridx, rca, rcb = tad.gk_pool_select_plain(ref, nb)
        live = ref.active
        if not (torch.equal(pool.active, live) and torch.equal(idx[live], ridx[live])
                and torch.equal(ca, rca) and torch.equal(cb, rcb)):
            fail(f"K5 select at {L} lanes, nbisect {nb}: picks differ from the plain version")
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
    t5s = {"ms": cuda_ms(lambda: tad.gk_pool_select(clone(pool_s), nb), 30),
           "plain_ms": cuda_ms(lambda: tad.gk_pool_select_plain(clone(pool_s), nb), 10),
           "clone_ms": cuda_ms(lambda: clone(pool_s), 30)}
    t5u = {"ms": cuda_ms(lambda: tad.gk_pool_update(clone(pool_s), *upd_args), 30),
           "plain_ms": cuda_ms(lambda: tad.gk_pool_update_plain(clone(pool_s), *upd_args), 10)}
    for t5 in (t5s, t5u):  # each timed call clones the pool first
        t5["ms"] = max(t5["ms"] - t5s["clone_ms"], 0.0)
        t5["plain_ms"] = max(t5["plain_ms"] - t5s["clone_ms"], 0.0)
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

    # the same solve through the plain versions, at 3 frequencies
    pick = sorted({int(np.argmax(d_iai)), IAI_OMEGAS // 4, (3 * IAI_OMEGAS) // 4})
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
    return [
        {"name": "fourier_contract", "route": "cuda", "source": src + "fourier_contract.cu",
         "replaces": "autobzcore_tpu/ops/fourier_eval.py:104", "launches": launches["fourier_contract"],
         "max_abs_err": max(e3a, e3), "ms": t3["ms"], "plain_ms": t3["plain_ms"],
         "bound_ms": b3[0], "bound_by": b3[1], "library_ms": t3["library_ms"]},
        {"name": "gk_leaf_dos", "route": "cuda", "source": src + "gk_leaf_dos.cu",
         "replaces": "autobzcore_tpu/fourier.py:394", "launches": launches["gk_leaf_dos"],
         "max_abs_err": e4, "ms": t4["ms"], "plain_ms": t4["plain_ms"],
         "bound_ms": b4[0], "bound_by": b4[1], "library_ms": None},
        {"name": "gk_pool_select", "route": "cuda", "source": src + "gk_pool.cu",
         "replaces": rep + "427", "launches": launches["gk_pool_select"], "max_abs_err": 0.0,
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

if __name__ == "__main__":
    main()
