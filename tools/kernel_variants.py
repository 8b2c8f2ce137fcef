#!/usr/bin/env python3
"""Time variants of one kernel source on one NVIDIA GPU, at the main path's
shapes, against the kernels' plain versions.

    python3 tools/kernel_variants.py SOURCE [--only NAME,...] [--other NAME=FILE.cu ...] [--out DIR]

SOURCE is a file of ``autobzcore_torch/csrc/`` with a patch table here:

- ``fourier_points`` (K1 and K11): ``ctiles=N`` (N = 1, 2, 3, 5, 9), the
  column tiles forced to N (at most one a four outputs), where the package
  chooses them from the point tiles and the SM count; ``nostore``, the
  epilogue's stores taken out (its outputs are garbage): the most that any
  cheaper epilogue could save; ``staged``, the epilogue staged through
  shared memory (a warp's 16 points by its column tile), so that each warp
  writes whole lines of the (K, R, V) output. Shapes: K1 and K11 (R = 4,
  V = 9) on the flagship at the 1e6 points of the 100^3 grid, K11 at a GGR
  init / transport pack chunk (its first 4,096 points), K1 at a k-path's
  3,787 points.
- ``transport_gamma`` (K19): ``div``, each reciprocal 1 / (x^2 + g^2) a
  correctly rounded division (``__ddiv_rn``) instead of
  ``rcp.approx.ftz.f64`` and two Newton steps; ``dmmaonly``, every
  reciprocal the constant g^2 (wrong values): what staging, products and
  DMMA cost without the Lorentzians; ``nodmma``, the DMMA made two FMAs
  (wrong values): what the CUDA cores cost alone; ``chunk256``, 256 points
  a chunk (the package has 512). Shapes: the flagship's npt=60 pack
  (216,000 points, m = d = 3) at 64 equal frequencies and at a 960-pair
  trip with Omega != 0, as phase 25 of ``chip_smoke.py``, and its npt=100
  pack (1e6 points) at 256 equal lanes (the B11d shape).

Each variant is a copy of the source, changed by a text patch, built on its
own with the package's nvcc flags into a library of its own under
``build/autobzcore_torch/variants/``; ``package`` is the source as it is,
and ``--other NAME=FILE.cu`` adds another source with the same C entry
points as it is, for example the parent's (``git show HEAD~1:...`` into a
file). ``--only`` keeps the named variants. Each variant is timed in two
rounds, by events, by torch.profiler's device time and by the host time of
its ctypes launch. The last line is a JSON object of the numbers; with
``--out DIR`` a copy goes to ``DIR/variants_SOURCE.json``.
"""
import ctypes
import importlib.util
import json
import subprocess
import sys
from concurrent.futures import ThreadPoolExecutor
from pathlib import Path

import numpy as np

REPO = Path(__file__).resolve().parent.parent
CSRC = REPO / "autobzcore_torch" / "csrc"
sys.path.insert(0, str(REPO))
VP, LL, INT, DBL = ctypes.c_void_p, ctypes.c_longlong, ctypes.c_int, ctypes.c_double


def patch(name, src, old, new):
    if src.count(old) != 1:
        sys.exit(f"{name}.cu no longer holds the text this variant patches:\n{old}")
    return src.replace(old, new)


# fourier_points.cu: K1 and K11
EPILOGUE = """#pragma unroll
    for (int nt = 0; nt < TN; ++nt) {
      const int j = j0 + nt * 4 + t;
      if (j < G.VP) {
        if (kA < K) out[kA * G.VP + j] = make_double2(acc[nt][0], acc[nt][1]);
        if (kB < K) out[kB * G.VP + j] = make_double2(acc[nt][2], acc[nt][3]);
      }
    }
"""
STAGED = """    {
      double2* E = Bs + G.CS * TN * 16 + warp * 16 * JB;
      __syncwarp();
#pragma unroll
      for (int nt = 0; nt < TN; ++nt) {
        E[g * JB + nt * 4 + t] = make_double2(acc[nt][0], acc[nt][1]);
        E[(g + 8) * JB + nt * 4 + t] = make_double2(acc[nt][2], acc[nt][3]);
      }
      __syncwarp();
      const int jn = min(JB, G.VP - j0);
      const int64_t k0 = kA - g;
      const int np = static_cast<int>(K - k0 < 16 ? K - k0 : 16);
      for (int e = lane; e < np * jn; e += 32) {
        const int p = e / jn, jj = e - p * jn;
        out[(k0 + p) * G.VP + j0 + jj] = E[p * JB + jj];
      }
      __syncwarp();
    }
"""
TILES = "  const int tn = static_cast<int>(((VP + ctiles - 1) / ctiles + 3) / 4);\n"
SMEM = "  const int smem = G.CS * slab_bytes;\n"
OPT_IN = "cudaFuncAttributeMaxDynamicSharedMemorySize, kSmemBudget)"


def fourier_variants(src):
    p = lambda s, old, new: patch("fourier_points", s, old, new)  # noqa: E731
    out = {f"ctiles={n}": p(src, TILES, f"  ctiles = {n} < (VP + 3) / 4 ? {n} : (VP + 3) / 4;\n" + TILES)
           for n in (1, 2, 3, 5, 9)}
    out["nostore"] = p(src, EPILOGUE, EPILOGUE.replace("if (j < G.VP) {", "if (j < G.VP && acc[nt][0] == 1e300) {"))
    staged = p(p(src, EPILOGUE, STAGED), SMEM, "  const int smem = G.CS * slab_bytes + kWarps * 16 * 4 * TN * 16;\n")
    out["staged"] = p(staged, OPT_IN, "cudaFuncAttributeMaxDynamicSharedMemorySize, kSmemBudget + kWarps * 16 * 36 * 16)")
    return out


def fourier_cases(torch, cs, dev, stream):
    """(tag, reps, skip(name), launcher(lib) -> (go, result), want) of K1 and K11."""
    from autobzcore_torch.algorithms.ptr import frac_nodes
    from autobzcore_torch.models.tight_binding import flagship_series
    from autobzcore_torch.ops import fourier_eval as fe

    h = flagship_series(device=dev)
    Xg = (frac_nodes(cs.NPT, 3, dev) * torch.as_tensor(h.period, device=dev)).contiguous()
    orders = fe.jacobian_orders(3)
    flat = (ctypes.c_int * 12)(*[o for order in orders for o in order])
    want = {False: fe.fourier_points_plain(h.c, Xg, h.offset, h.period),
            True: fe.fourier_points_derivs_plain(h.c, Xg, h.offset, h.period, orders)}

    def case(K, deriv):
        def launcher(lib):
            lib.fourier_points_launch.argtypes = [VP, VP, VP, LL] + [INT] * 7 + [DBL] * 3 + [INT, VP]
            lib.fourier_points_derivs_launch.argtypes = [VP, VP, VP, LL] + [INT] * 7 + [DBL] * 3 + [
                INT, INT, ctypes.POINTER(INT), VP]
            out = torch.empty((K, 4 if deriv else 1, 3, 3), dtype=torch.complex128, device=dev)
            head = (h.c.data_ptr(), Xg.data_ptr(), out.data_ptr(), K, 3, 5, 5, 5, *h.offset, *h.period, 9)
            fn, args = ((lib.fourier_points_derivs_launch, head + (4, flat, stream)) if deriv else
                        (lib.fourier_points_launch, head + (stream,)))
            return (lambda: fn(*args)), (lambda: out if deriv else out[:, 0])
        return launcher, want[deriv][:K]

    # the forced column tiles only where the point tiles alone leave SMs idle
    few = lambda name: name.startswith("ctiles")  # noqa: E731
    return [("k1_1e6", 10, few, *case(Xg.shape[0], False)), ("k11_1e6", 10, few, *case(Xg.shape[0], True)),
            ("k11_4096", 300, None, *case(4096, True)), ("k1_3787", 300, None, *case(3787, False))]


# transport_gamma.cu: K19
RCP = """  double r;
  asm("rcp.approx.ftz.f64 %0, %1;" : "=d"(r) : "d"(den));
  r = __fma_rn(r, __fma_rn(-den, r, 1.0), r);
  return __fma_rn(r, __fma_rn(-den, r, 1.0), r);
"""
LORENTZ = """  const double x = __dsub_rn(y, e);
  const double den = __dadd_rn(__dmul_rn(x, x), gg);
""" + RCP


def transport_variants(src):
    p = lambda old, new: patch("transport_gamma", src, old, new)  # noqa: E731
    return {"div": p(RCP, "  return __ddiv_rn(1.0, den);\n"),
            "dmmaonly": p(LORENTZ, "  return y == 1e300 ? e : gg;\n"),
            "nodmma": p("  dmma(acc, a, b0, b1);\n",
                        "  acc[0] = __fma_rn(a[0], b0, acc[0]);\n  acc[1] = __fma_rn(a[2], b1, acc[1]);\n"),
            "chunk256": p("constexpr int kChunk = 512;", "constexpr int kChunk = 256;")}


def transport_cases(torch, cs, dev, stream):
    """(tag, reps, skip(name), launcher(lib) -> (go, result), want) of K19."""
    from autobzcore_torch import FBZ, load_bz
    from autobzcore_torch.models import observables as obs
    from autobzcore_torch.models.tight_binding import flagship_series

    h = flagship_series(device=dev)
    bz = load_bz(FBZ(), np.eye(3))
    p60, p100 = obs.spectral_velocity_pack(h, bz, cs.TR_NPT), obs.spectral_velocity_pack(h, bz, cs.NPT)
    rng = np.random.default_rng(25)
    lo, hi = -2.6, 0.6
    om64 = torch.linspace(lo, hi, 64, dtype=torch.float64, device=dev)
    w960 = torch.as_tensor(rng.uniform(lo, hi, 960), device=dev)
    x2 = (w960 + torch.as_tensor(np.repeat(np.linspace(0.25, 2.0, 8), 120), device=dev)).contiguous()
    om256 = torch.as_tensor(np.linspace(*cs.WINDOW, cs.TR_PTR_OMEGAS), device=dev)
    eta64, eta960, eta256 = torch.full_like(om64, cs.TR_ETA), torch.full_like(w960, cs.TR_ETA), torch.full_like(
        om256, cs.ETA)

    def case(pack, y1, g1, y2, g2):
        e, Wm, sc = pack.e, pack.Wmat, pack.scale
        K, B = e.shape[0], y1.shape[0]

        def launcher(lib):
            lib.transport_gamma_num_chunks.argtypes = [LL]
            lib.transport_gamma_num_chunks.restype = LL
            lib.transport_gamma_launch.argtypes = [VP, VP, LL, INT, INT, VP, VP, VP, VP, LL, INT, DBL, VP, VP, VP]
            out = torch.empty((B, 9), dtype=torch.float64, device=dev)
            part = torch.empty((lib.transport_gamma_num_chunks(K), B, 9), dtype=torch.float64, device=dev)
            args = (e.data_ptr(), Wm.data_ptr(), K, 3, 3, y1.data_ptr(), g1.data_ptr(), y2.data_ptr(),
                    g2.data_ptr(), B, int(y2 is y1), float(sc), part.data_ptr(), out.data_ptr(), stream)
            return (lambda: lib.transport_gamma_launch(*args)), (lambda: out)
        return launcher, obs.transport_gamma_plain(e, Wm, y1, g1, y2, g2, sc)

    return [("equal64", 5, None, *case(p60, om64, eta64, om64, eta64)),
            ("trip960", 5, None, *case(p60, w960, eta960, x2, eta960)),
            ("ptr256", 5, None, *case(p100, om256, eta256, om256, eta256))]


SOURCES = {"fourier_points": (fourier_variants, fourier_cases),
           "transport_gamma": (transport_variants, transport_cases)}


def main():
    argv = sys.argv[1:]
    if not argv or argv[0] not in SOURCES:
        sys.exit(__doc__)
    source = argv.pop(0)
    out_dir, others, only = None, {}, None
    while argv:
        flag = argv.pop(0)
        if flag == "--out" and argv:
            out_dir = Path(argv.pop(0))
        elif flag == "--only" and argv:
            only = set(argv.pop(0).split(","))
        elif flag == "--other" and argv and "=" in argv[0]:
            name, path = argv.pop(0).split("=", 1)
            others[name] = Path(path).read_text()
        else:
            sys.exit(__doc__)

    import torch

    from autobzcore_torch.ops import cuda_lib

    if not torch.cuda.is_available():
        sys.exit("needs a CUDA card")
    spec = importlib.util.spec_from_file_location("chip_smoke", REPO / "chip_smoke.py")
    cs = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(cs)
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True, timeout=60).stdout.strip()
    print(smi, flush=True)
    make_variants, make_cases = SOURCES[source]
    text = (CSRC / f"{source}.cu").read_text()
    srcs = {"package": text, **make_variants(text)}
    if only is not None:
        srcs = {k: v for k, v in srcs.items() if k in only}
    srcs.update(others)
    vdir = cuda_lib.BUILD_DIR / "variants"
    vdir.mkdir(parents=True, exist_ok=True)

    def build(item):
        i, (name, src) = item
        cu, so = vdir / f"{source}_{i}.cu", vdir / f"{source}_{i}.so"
        cu.write_text(src)
        r = subprocess.run([cuda_lib.nvcc_path(), *cuda_lib.NVCC_FLAGS, "-I", str(CSRC), "-shared", str(cu), "-o",
                            str(so)], capture_output=True, text=True, timeout=900)
        if r.returncode:
            sys.exit(f"{name}: build failed\n{r.stdout[-3000:]}{r.stderr[-3000:]}")
        regs = [ln.strip() for ln in r.stdout.splitlines() + r.stderr.splitlines() if "Used" in ln]
        return name, (so, regs)

    with ThreadPoolExecutor(len(srcs)) as ex:
        built = dict(ex.map(build, enumerate(srcs.items())))
    libs = {}
    for name, (so, regs) in built.items():
        libs[name] = ctypes.CDLL(str(so))
        print(f"{name}: ptxas {regs[:12]}", flush=True)

    dev = torch.device("cuda", 0)
    cases = make_cases(torch, cs, dev, cuda_lib.stream_handle(dev))
    res = {"card": smi, "source": source, "ptxas": {k: v[1] for k, v in built.items()}}
    for rnd in range(2):
        for name, lib in libs.items():
            for tag, reps, skip, launcher, want in cases:
                if skip is not None and skip(name):
                    continue
                launch, result = launcher(lib)

                def go():
                    err = launch()
                    if err:
                        raise RuntimeError(f"CUDA error {err} at launch")
                go()
                torch.cuda.synchronize()
                rel = float((result() - want).abs().max() / want.abs().max())
                r = {"rel": rel, "ms": cs.cuda_ms(go, reps), "device_ms": cs.device_ms(go, min(reps, 100)),
                     "host_us": cs.host_us(go, reps)}
                res.setdefault(f"{name}:{tag}", []).append(r)
                print(f"round {rnd} {name} {tag}: rel {rel:.2e}, events {r['ms']:.5f} ms, device "
                      f"{cs.ms_text(r['device_ms'])}, host {r['host_us']:.1f} us", flush=True)
            torch.cuda.empty_cache()
    if out_dir is not None:
        out_dir.mkdir(parents=True, exist_ok=True)
        (out_dir / f"variants_{source}.json").write_text(json.dumps(res, indent=1))
    print(json.dumps(res), flush=True)


if __name__ == "__main__":
    main()
