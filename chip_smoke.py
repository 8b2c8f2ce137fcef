#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port (``autobzcore_torch``) on one NVIDIA GPU.

Run from the repository root with no arguments:

    python3 chip_smoke.py

Phases, one line of output each (a failing phase ends the run non-zero):

1. device: the card's name and power limit (nvidia-smi) and torch's name;
2. build: both CUDA kernels from ``autobzcore_torch/csrc`` with nvcc, timed;
3. kernels: each kernel against its plain PyTorch version on the card, in
   FP64, at stated tolerances; K2 run twice must be bit-identical; kernel
   and plain times at the flagship shapes (K = 1e6 points, W = 264);
4. main path: the flagship PTR leg at full width through the public entry
   points (synthetic 3-band series on the full zone, PTR(npt=100),
   eta = 0.05, SweepSolver(chunk=264) under hchebinterp over [-6, 7] eV,
   atol 1e-2), with the kernels' launch counts, a sum-rule check of the
   interpolant and a check of D at 5 frequencies against the plain path;
5. cubic IBZ: tb_integer(3) on CubicSymIBZ against the full zone.

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

    # 4. main path at full width --------------------------------------------
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
    kernels = [
        {"name": "fourier_points", "route": "cuda", "source": src + "fourier_points.cu",
         "replaces": "autobzcore_tpu/ops/fourier_eval.py:78",
         "launches": launches["fourier_points"], "max_abs_err": k1_abs,
         "ms": t["k1"], "plain_ms": t["k1_plain"]},
        {"name": "dos_trace_weighted_sum", "route": "cuda", "source": src + "dos_trace.cu",
         "replaces": "autobzcore_tpu/models/observables.py:149",
         "launches": launches["dos_trace_weighted_sum"], "max_abs_err": k2_abs,
         "ms": t["k2"], "plain_ms": t["k2_plain"]},
    ]
    print(json.dumps({"kernels": kernels}), flush=True)
    print(json.dumps({"ok": True, "device": {"platform": "gpu", "kind": kind,
                                             "count": torch.cuda.device_count()}}), flush=True)


if __name__ == "__main__":
    main()
