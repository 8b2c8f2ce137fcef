#!/usr/bin/env python3
"""Time variants of one kernel source on one NVIDIA GPU, at the main path's
shapes, against the kernels' plain versions.

    python3 tools/kernel_variants.py SOURCE [--only NAME,...] [--other NAME=FILE.cu ...] [--base FILE.cu]
        [--out DIR]

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

- ``sigma_pairs`` (K28): ``minblocks=N`` (N = 1-4), the kernel's
  ``__launch_bounds__`` asking for N blocks of 128 threads an SM at every m
  (the package asks for 3 at m <= 3, at most 168 registers a thread, and 1
  above); ``tile=N`` (N = 16, 64) points a shared tile at m <= 3 (the
  package has 32); ``loops4``, the packed-Hermitian helpers run as loops over
  local memory at m = 4 as above it (the package unrolls them up to m = 4).
  Shapes: the flagship's npt=100 grid (H and V at 1e6 points, m = d = 3)
  with phase 30's Fermi-liquid Sigma at 32 unequal pairs (w, w + 0.5 eV),
  at a kinetic trip's 960 and at the transport sweep's 256 equal
  frequencies, each checked on its first 32 pairs; and phase 29's step
  above three bands (synthetic_wannier(4) at npt 64, 262,144 points) at 32
  equal and 32 unequal pairs.

- ``tetra_dos`` (K10): ``chunk256``, 256 sorted energies a block row (the
  package has 512); ``pairs2048``, rounds of 2,048 pairs (the package has
  1,024); ``brick2x8x8``, tiles of 2 x 8 x 8 cells (the package has 4 x 4
  x 8); ``noforms``, the closed forms replaced by one product (wrong
  values): what the staging, the supports, the pair numbering and the walk
  cost without them; ``nofew``, one energy on the tile kernel instead of
  the term-by-term one. Shapes: the flagship's eigenvalue grid at
  npt=100 with 1001 energies over [-6, 7] eV (the DOS and N(E)) and one
  energy (a Fermi-level step's N(E)), against the package's kernel.

- ``dos_trace`` (K2): ``div``, every pair's quotient a correctly rounded
  division (``__ddiv_rn``) instead of ``rcp.approx.ftz.f64`` and two
  Newton steps; ``r8``, at most 8 lanes a thread (the package takes up to
  16). Shapes: the flagship's npt=100 grid (1e6 points, m = 3) at the PTR
  leg's 264 lanes, and its npt=400 grid (6.4e7 points) at 8 lanes (a late
  AutoPTR rung), checked on their whole grids.
- ``sigma_trace`` (K27): ``noguard``, the tensor-core expansion without
  the guard's redo (near poles its values lose digits): what the guard
  costs; ``direct``, every pair by the guard's direct form (M from H's
  reals, cofactors, one reciprocal): what the expansion on the tensor
  cores saves; ``guard8192`` and ``guard32768``, the guard's threshold
  (the package's 2048) raised; ``minblocks5`` and ``minblocks4``, the
  tensor-core entries asked for five or four blocks of 128 threads an SM;
  ``pipelined``, a step's products issued before the previous step's
  finish (two sets of accumulators); ``noinline``, the guard's direct route
  a call of its own, whose registers the products' loop does not hold. ``--other parent=FILE.cu`` adds the previous design (its
  trace and diagonal sums take the same arguments). Shapes:
  the flagship's npt=100 grid (1e6 points) with phase 30's Fermi-liquid
  Sigma at 1000 lanes in trace and in diagonal mode, and 64 lanes of Sigma
  = -1e-3 i half on an eigenvalue of some H_k (trace mode), each checked on
  all its lanes.
- ``ggr_dos`` (K13): ``noeval``, a pair's closed form replaced by its
  energy (wrong values): what the staging, the supports, the pair
  numbering and the walks over a tile's terms cost; ``nowalk``, no energy
  walks the tile's terms (wrong values): the staging, the supports, the
  barriers, box mode's pair evaluation and the partials; ``chunk512``, 512
  sorted energies a block row (the package has 1,024); ``pairsN``, box
  mode's rounds of N pairs (the package has 1,536; above it a block holds
  more shared memory, and fewer blocks fit an SM); ``plainwalk``, box
  mode's owner of an energy walking all of a tile's terms (the package
  walks only those a ballot finds in its warp's 32 energies).
  Shapes: phase 19's, the flagship's spectral grid at npt=100 (3e6 terms)
  at 1001 energies over [-6, 7] eV in box and in Gaussian mode, and
  config 5's (893,730 terms) at 1000 energies in box mode.
- ``gm_pool`` (K16): ``noscatter``, the update's writes taken out;
  ``noloads``, the pass over the pool reading no memory; ``noselect``, the
  select taken out; ``rounds``, the select by rounds of a block arg-max at
  nbisect 4 (the package merges per-thread lists up to 4); ``top1``, a
  thread's list only its best slot; ``warpmerge0``, a lane's own list
  taken for its warp's (warp 0 still merges the warps' lists);
  ``nochildren``, no pick's box read (zero children); each but ``rounds``
  gives wrong pools, with valid picks, so that the lanes keep stepping:
  what its part costs. Shape: the step of
  phase 23's TAI trip, 33 lanes x cap 4096 x d = 3, one value, nbisect 4,
  on a started pool of random lanes.
- ``lindhard_chi0`` (K25): ``noloop``, the frequency loop over a tile's
  terms taken out (wrong values): what building the tiles, the launch and
  the second pass cost; ``nobuild``, the terms' build replaced by constant
  terms (wrong values): what the frequency loop costs. The patches hold for
  this package's source and for the design before it (the parent's, given
  by ``--base``); ``nounroll``, the term loop not unrolled (the package
  unrolls it twice). Shapes: phase 29's flagship grid at npt 64 (262,144
  points, m = 3) at q = (1/8, 0, 0), with the map's 100 omegas and
  certified_chi0's 9.

Each variant is a copy of the source, changed by a text patch, built on its
own with the package's nvcc flags into a library of its own under
``build/autobzcore_torch/variants/``; ``package`` is the source as it is,
and ``--other NAME=FILE.cu`` adds another source with the same C entry
points as it is, for example the parent's (``git show HEAD~1:...`` into a
file). ``--base FILE.cu`` patches that source instead of the package's
and times it as ``base`` beside ``package``. ``--only`` keeps the named
variants. Each variant is timed in two
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


# sigma_pairs.cu: K28
BOUNDS = "__global__ void __launch_bounds__(kThreads, kMinBlocks<M>)\nsigma_pairs_partials("
TILE = "constexpr int kTileK = 32;     // points per shared tile for m <= 3"


UNROLL = "constexpr int kUnroll = M <= 4 ? 8 : 1;"
LOOPS = ("#pragma unroll (U)\n    for (int j = 0; j < M; ++j) {\n      A.d[j] = -2.0",
         "#pragma unroll (U)\n      for (int k = j + 1; k < M; ++k) {")


def sigma_variants(src):
    p = lambda s, old, new: patch("sigma_pairs", s, old, new)  # noqa: E731
    out = {f"minblocks={n}": p(src, BOUNDS, BOUNDS.replace("kMinBlocks<M>)", f"{n})")) for n in (1, 2, 3, 4)}
    out.update({f"tile={n}": p(src, TILE, TILE.replace("32;", f"{n};")) for n in (16, 64)})
    loops = p(src, UNROLL, UNROLL.replace("M <= 4", "M <= 3"))
    for loop in LOOPS:
        loops = p(loops, loop, loop.replace("#pragma unroll (U)", "#pragma unroll 1"))
    out["loops4"] = loops
    return out


def sigma_cases(torch, cs, dev, stream):
    """(tag, reps, skip(name), launcher(lib) -> (go, result), want) of K28."""
    from autobzcore_torch import FBZ, load_bz
    from autobzcore_torch.models import selfenergy as se
    from autobzcore_torch.models.tight_binding import flagship_series, synthetic_wannier

    bz = load_bz(FBZ(), np.eye(3))
    h = flagship_series(device=dev)
    (H, V), w, sc, _ = se._grid(h, bz, cs.SE_NPT, jacobian=True)
    ws = np.linspace(-8.0, 8.0, cs.SE_SIGMA_POINTS)
    sigma = se.SigmaInterpolant(ws, cs.fermi_liquid_sigma(np, ws), device=dev)
    m4 = cs.M4_BANDS
    (H4, V4), w4, sc4, _ = se._grid(synthetic_wannier(m4, nr=3, ndim=3, seed=1, device=dev), bz, cs.M4_NPT,
                                    jacobian=True)
    s4 = se.SigmaInterpolant(ws, cs.fermi_liquid_sigma(np, ws, m4), device=dev)
    om4 = torch.linspace(*cs.WINDOW, cs.M4_PAIRS, dtype=torch.float64, device=dev)
    Z4, Z4b = se._zmat(om4, s4, m4).contiguous(), se._zmat(om4 + 0.5, s4, m4).contiguous()
    om256 = torch.linspace(*cs.WINDOW, cs.SE_TR_OMEGAS, dtype=torch.float64, device=dev)
    om960 = torch.linspace(*cs.WINDOW, cs.SE_TRIP_PAIRS, dtype=torch.float64, device=dev)
    Z256 = se._zmat(om256, sigma, 3).contiguous()
    Z960, Z960b = se._zmat(om960, sigma, 3).contiguous(), se._zmat(om960 + 0.5, sigma, 3).contiguous()
    Z32, Z32b = Z256[:32].contiguous(), se._zmat(om256[:32] + 0.5, sigma, 3).contiguous()

    def case(Z1, Z2, H=H, V=V, w=w, sc=sc):
        K, B, m = H.shape[0], Z1.shape[0], H.shape[-1]

        def launcher(lib):
            lib.sigma_pairs_num_chunks.argtypes = [LL]
            lib.sigma_pairs_num_chunks.restype = LL
            lib.sigma_pairs_sum_launch.argtypes = [VP] * 5 + [INT, VP, VP, LL, INT, INT, INT, DBL, VP]
            out = torch.empty((B, 3, 3), dtype=torch.float64, device=dev)
            part = torch.empty((lib.sigma_pairs_num_chunks(K), B, 3, 3), dtype=torch.float64, device=dev)
            args = (H.data_ptr(), V.data_ptr(), w.data_ptr(), Z1.data_ptr(), Z2.data_ptr(), int(Z2 is Z1),
                    part.data_ptr(), out.data_ptr(), K, B, m, 3, float(sc), stream)
            return (lambda: lib.sigma_pairs_sum_launch(*args)), (lambda: out)
        want = se.sigma_pairs_sum_plain(H, V, w, Z1[:32], Z1[:32] if Z2 is Z1 else Z2[:32], sc)
        return launcher, want

    def first32(launcher):
        def first(lib):
            go, result = launcher(lib)
            return go, (lambda: result()[:32])
        return first

    cases = [("unequal32", 3, None, *case(Z32, Z32b)), ("unequal960", 2, None, *case(Z960, Z960b)),
             ("equal256", 3, None, *case(Z256, Z256)),
             ("m4equal32", 3, None, *case(Z4, Z4, H4, V4, w4, sc4)),
             ("m4unequal32", 3, None, *case(Z4, Z4b, H4, V4, w4, sc4))]
    return [(tag, reps, skip, first32(launcher), want) for tag, reps, skip, launcher, want in cases]


# tetra_dos.cu: K10
FORMS = "        sh.val[i] = kNos ? nos_term(En, e, tol) : dos_term(En, e, tol);\n"


def tetra_variants(src):
    p = lambda s, old, new: patch("tetra_dos", s, old, new)  # noqa: E731
    nofew = p(src, "  if (W <= kFewE) {\n", "  if (W < 0) {\n")
    return {"chunk256": p(src, "constexpr int kChunkE = 512;", "constexpr int kChunkE = 256;"),
            "pairs2048": p(src, "constexpr int kPairs = 1024;", "constexpr int kPairs = 2048;"),
            "brick2x8x8": p(src, "(j < 2 ? 4 : 8))", "(j == 0 ? 2 : 8))"),
            "noforms": p(src, FORMS, "        sh.val[i] = En * e[0];\n"),
            "nofew": p(nofew, "  if (m > 0 && W <= kFewE) {\n", "  if (m > 0 && W < 0) {\n")}


def tetra_cases(torch, cs, dev, stream):
    """(tag, reps, skip(name), launcher(lib) -> (go, result), want) of K10."""
    from autobzcore_torch import FBZ, load_bz
    from autobzcore_torch.dos import LTM
    from autobzcore_torch.dos import tetrahedron as tet
    from autobzcore_torch.models.tight_binding import flagship_series

    cv = LTM(npt=cs.NPT).init_cacheval(flagship_series(device=dev), 0.0, load_bz(FBZ(), np.eye(3)))
    eg, tol, vol = cv["eg"], cv["tol"], cv["vol"]
    E = torch.as_tensor(np.linspace(*cs.WINDOW, cs.LTM_ENERGIES), device=dev)
    E1 = torch.as_tensor([0.9424544925], dtype=torch.float64, device=dev)

    def case(En, nos):
        W = En.shape[0]

        def launcher(lib):
            lib.tetra_dos_num_blocks.argtypes = [LL, INT, INT, INT]
            lib.tetra_dos_num_blocks.restype = LL
            lib.tetra_dos_launch.argtypes = [VP, LL, INT, INT, VP, INT, DBL, DBL, INT, VP, VP, VP]
            out = torch.empty(W, dtype=torch.float64, device=dev)
            part = torch.empty((lib.tetra_dos_num_blocks(3, cs.NPT, 3, W), W), dtype=torch.float64, device=dev)
            args = (eg.data_ptr(), 3, cs.NPT, 3, En.data_ptr(), W, tol, vol, int(nos), part.data_ptr(),
                    out.data_ptr(), stream)
            return (lambda: lib.tetra_dos_launch(*args)), (lambda: out)
        return launcher, tet.tetra_dos(eg, 3, En, tol, vol, nos)

    return [("dos1001", 10, None, *case(E, False)), ("nos1001", 10, None, *case(E, True)),
            ("nos1", 50, None, *case(E1, True))]


# dos_trace.cu: K2
QUOTIENT = "__device__ __forceinline__ double quotient(double num, double den) {\n"
LANES = "  for (int R = 1; R <= 16; R *= 2) {\n"


def dos_variants(src):
    p = lambda old, new: patch("dos_trace", src, old, new)  # noqa: E731
    return {"div": p(QUOTIENT, QUOTIENT + "  return __ddiv_rn(num, den);\n"),
            "r8": p(LANES, LANES.replace("16", "8"))}


def dos_cases(torch, cs, dev, stream):
    """(tag, reps, skip(name), launcher(lib) -> (go, result), want) of K2."""
    from autobzcore_torch.algorithms.ptr import frac_nodes
    from autobzcore_torch.models import observables as obs
    from autobzcore_torch.models.tight_binding import flagship_series
    from autobzcore_torch.ops.fourier_eval import fourier_points

    h = flagship_series(device=dev)
    period = torch.as_tensor(h.period, device=dev)
    om264 = torch.linspace(*cs.WINDOW, cs.W_FLAGSHIP, dtype=torch.float64, device=dev)
    step = cs.W_FLAGSHIP // cs.DOS_RUNG_LANES

    def case(npt, om):
        H = fourier_points(h.c, (frac_nodes(npt, 3, dev) * period).contiguous(), h.offset, h.period).reshape(-1, 3, 3)
        K, W = H.shape[0], om.shape[0]
        w = torch.ones(K, dtype=torch.float64, device=dev)
        eta = torch.full_like(om, cs.ETA)
        sc = (2 * np.pi) ** 3 / npt**3

        def launcher(lib):
            lib.dos_trace_num_chunks.argtypes = [LL]
            lib.dos_trace_num_chunks.restype = LL
            lib.dos_trace_weighted_sum_launch.argtypes = [VP] * 6 + [LL, INT, INT, DBL, INT, VP]
            out = torch.empty(W, dtype=torch.float64, device=dev)
            part = torch.empty((lib.dos_trace_num_chunks(K), W), dtype=torch.float64, device=dev)
            args = (H.data_ptr(), w.data_ptr(), om.data_ptr(), eta.data_ptr(), part.data_ptr(), out.data_ptr(), K, W,
                    3, -sc / np.pi, 0, stream)
            return (lambda: lib.dos_trace_weighted_sum_launch(*args)), (lambda: out)
        return launcher, obs.dos_trace_weighted_sum_plain(H, w, om, eta, sc)

    return [("ptr264", 10, None, *case(cs.NPT, om264)),
            ("rung8", 5, None, *case(cs.DOS_RUNG_NPT, om264[::step].contiguous()))]


# sigma_trace.cu: K27
GUARD = "          if (!(den >= lo && den < 0x1p1022)) {\n"
GUARD2 = "constexpr double kGuard2 = 4194304.0;  // 2048^2\n"
REDO = "__device__ void direct3("
PIPELINE = """      double d0[4], n0s[kNum][4], d1[4], n1s[kNum][4];
      products(0, d0, n0s);
      for (int n0 = 0; n0 < nk; n0 += 16) {
        const bool second = n0 + 8 < nk;
        if (second) products(n0 + 8, d1, n1s);
        finish(n0, d0, n0s);
        if (second) {
          if (n0 + 16 < nk) products(n0 + 16, d0, n0s);
          finish(n0 + 8, d1, n1s);
        }
      }
"""
SERIAL = """      double d0[4], n0s[kNum][4];
      for (int n0 = 0; n0 < nk; n0 += 8) {
        products(n0, d0, n0s);
        finish(n0, d0, n0s);
      }
"""
BOUNDS27 = "__global__ void __launch_bounds__(kThreads)\nsigma_trace_dmma("


def trace_variants(src):
    p = lambda old, new: patch("sigma_trace", src, old, new)  # noqa: E731
    return {"noguard": p(GUARD, "          if (out_of_range(den)) {\n"),
            "direct": p(GUARD, "          if (true) {\n"),
            "guard8192": p(GUARD2, "constexpr double kGuard2 = 67108864.0;\n"),
            "guard32768": p(GUARD2, "constexpr double kGuard2 = 1073741824.0;\n"),
            "minblocks5": p(BOUNDS27, BOUNDS27.replace("(kThreads)", "(kThreads, 5)")),
            "minblocks4": p(BOUNDS27, BOUNDS27.replace("(kThreads)", "(kThreads, 4)")),
            "pipelined": p(SERIAL, PIPELINE),
            "noinline": p(REDO, REDO.replace("__device__ void", "__device__ __noinline__ void"))}


def trace_cases(torch, cs, dev, stream):
    """(tag, reps, skip(name), launcher(lib) -> (go, result), want) of K27's sums."""
    from autobzcore_torch import FBZ, load_bz
    from autobzcore_torch.models import selfenergy as se
    from autobzcore_torch.models.tight_binding import flagship_series

    h = flagship_series(device=dev)
    (H,), w, sc, _ = se._grid(h, load_bz(FBZ(), np.eye(3)), cs.SE_NPT, jacobian=False)
    ws = np.linspace(-8.0, 8.0, cs.SE_SIGMA_POINTS)
    sigma = se.SigmaInterpolant(ws, cs.fermi_liquid_sigma(np, ws), device=dev)
    Z = se._zmat(torch.linspace(*cs.WINDOW, cs.SE_OMEGAS, dtype=torch.float64, device=dev), sigma, 3).contiguous()
    Zpole = cs.k27_pole_lanes(np, torch, np.random.default_rng(29), H, cs.K27_POLE_LANES, cs.K27_POLE_ETA)
    K = H.shape[0]

    def case(Zc, diag):
        W, J = Zc.shape[0], 3 if diag else 1

        def launcher(lib):
            lib.sigma_trace_num_chunks.argtypes = [LL]
            lib.sigma_trace_num_chunks.restype = LL
            lib.sigma_trace_sum_launch.argtypes = [VP] * 5 + [LL, INT, INT, INT, DBL, VP]
            out = torch.empty((W, J), dtype=torch.float64, device=dev)
            part = torch.empty((lib.sigma_trace_num_chunks(K), W, J), dtype=torch.float64, device=dev)
            args = (H.data_ptr(), w.data_ptr(), Zc.data_ptr(), part.data_ptr(), out.data_ptr(), K, W, 3, int(diag),
                    -sc / np.pi, stream)
            return (lambda: lib.sigma_trace_sum_launch(*args)), (lambda: out if diag else out[:, 0])
        return launcher, se.sigma_trace_sum_plain(H, w, Zc, sc, diag)

    return [("trace1000", 5, None, *case(Z, False)), ("diagonal1000", 5, None, *case(Z, True)),
            ("trace64poles", 10, None, *case(Zpole, False))]


# lindhard_chi0.cu: K25, this design's text and the previous design's
CHI0_LOOP = ("    if (worker) {\n      double re0", "    const int nt = wi < W ? np * mm : 0;")
CHI0_BUILD = ("    for (int it = threadIdx.x; it < np * m; it += blockDim.x) {\n",
              "    for (int p = threadIdx.x; p < np; p += kThreads) {\n")


def patch_any(name, src, olds, new):
    """Apply the first of the alternative patches ``olds`` that the source
    holds; ``new(old)`` gives the replacement."""
    for old in olds:
        if src.count(old) == 1:
            return src.replace(old, new(old))
    sys.exit(f"{name}.cu holds none of the texts this variant patches:\n{olds}")


def chi0_variants(src):
    p = lambda olds, new: patch_any("lindhard_chi0", src, olds, new)  # noqa: E731
    noloop = p(CHI0_LOOP, lambda old: old.replace("if (worker) {", "if (worker && np < 0) {") if "worker" in old
               else "    const int nt = 0;")
    # constant terms in place of the build, then the build's loop taken out
    fill = ("    for (int j = threadIdx.x; j < np * mm; j += blockDim.x) ts[j] = make_double2(1e-3, 0.25 * (j % 7));\n")
    nobuild = p(CHI0_BUILD, lambda old: fill + old.replace("< np * m;", "< 0;").replace("< np;", "< 0;"))
    out = {"noloop": noloop, "nobuild": nobuild}
    if "#pragma unroll 2\n" in src:
        out["nounroll"] = src.replace("#pragma unroll 2\n", "#pragma unroll 1\n")
    return out


def chi0_cases(torch, cs, dev, stream):
    """(tag, reps, skip(name), launcher(lib) -> (go, result), want) of K25."""
    from autobzcore_torch import FBZ, load_bz
    from autobzcore_torch.models import lindhard as li
    from autobzcore_torch.models.tight_binding import flagship_series

    slv = li.LindhardSolver(flagship_series(device=dev), load_bz(FBZ(), np.eye(3)), cs.LH_NPT, cs.LH_BETA,
                            eta=cs.LH_ETA)
    e, f, U = slv._e, slv._f, slv._U
    K, m, npt = e.numel() // 3, 3, cs.LH_NPT
    shift = (ctypes.c_int * 3)(npt // 8, 0, 0)
    sc = slv._vol / npt**3

    def case(om):
        W = om.shape[0]

        def launcher(lib):
            lib.chi0_num_blocks.argtypes = [LL, INT]
            lib.chi0_num_blocks.restype = LL
            lib.chi0_launch.argtypes = [VP, VP, VP, INT, INT, ctypes.POINTER(INT), INT, VP, INT, DBL, DBL, VP, VP,
                                        VP]
            out = torch.empty(W, dtype=torch.complex128, device=dev)
            part = torch.empty((lib.chi0_num_blocks(K, m), W), dtype=torch.complex128, device=dev)
            args = (e.data_ptr(), f.data_ptr(), U.data_ptr(), 3, npt, shift, m, om.data_ptr(), W, cs.LH_ETA, sc,
                    part.data_ptr(), out.data_ptr(), stream)
            return (lambda: lib.chi0_launch(*args)), (lambda: out)
        return launcher, li.chi0_plain(e, f, U, (npt // 8, 0, 0), om, cs.LH_ETA, sc)

    om100 = torch.linspace(0.0, cs.LH_OMEGA_MAX, cs.LH_OMEGAS, dtype=torch.float64, device=dev)
    om9 = torch.linspace(0.0, cs.LH_OMEGA_MAX, 9, dtype=torch.float64, device=dev)
    return [("map100", 20, None, *case(om100)), ("cert9", 20, None, *case(om9))]


# ggr_dos.cu: K13
GGR_BOX_EVAL = "          pair_val[i] = in.value(sh.sf + q, kThreads, sh.sE[j], x, nullptr) ? x : 0.0;\n"
GGR_GAUSS_EVAL = ("            const bool i0 = in.value(sh.sf + q, kThreads, En, x0, sh.tab) && t0;\n"
                  "            const bool i1 = in.value(sh.sf + q + 1, kThreads, En, x1, sh.tab) && t1;\n")
GGR_WALK = "for (int j = rlo + tid; j < rhi; j += kThreads) {"  # Gaussian mode's
GGR_BALLOT_WALK = "for (int j0 = rlo + warp * 32; j0 < rhi; j0 += kThreads) {"  # box mode's
PLAIN_WALK = """        for (int j = rlo + tid; j < rhi; j += kThreads) {
          double a = sh.acc[j];
          for (int q = 0; q < nt; ++q) {
            const int2 sp = sh.sup[q];
            const int p = sh.off[q] + (j - sp.x) - r0;
            if (j >= sp.x && j < sp.y && p >= 0 && p < np) a = add(a, pair_val[p]);
          }
          sh.acc[j] = a;
        }
"""


def ggr_variants(src):
    p = lambda s, old, new: patch("ggr_dos", s, old, new)  # noqa: E731
    noeval = p(p(src, GGR_BOX_EVAL, "          pair_val[i] = sh.sE[j];\n"), GGR_GAUSS_EVAL,
               "            x0 = x1 = En;\n            const bool i0 = t0, i1 = t1;\n")
    nowalk = p(p(src, GGR_WALK, "for (int j = rlo + tid; j < rlo; j += kThreads) {"), GGR_BALLOT_WALK,
               "for (int j0 = rlo + warp * 32; j0 < rlo; j0 += kThreads) {")
    head = src.index("        " + GGR_BALLOT_WALK)
    tail = src.index("        __syncthreads();\n      }\n    }\n  }\n", head)
    pairs = "constexpr int kPairs = 1536;"

    return {"noeval": noeval, "nowalk": nowalk,
            "chunk512": p(src, "constexpr int kChunkE = 1024;", "constexpr int kChunkE = 512;"),
            "pairs1024": p(src, pairs, "constexpr int kPairs = 1024;"),
            "pairs3072": p(src, pairs, "constexpr int kPairs = 3072;"),
            "pairs6144": p(src, pairs, "constexpr int kPairs = 6144;"),
            "plainwalk": src[:head] + PLAIN_WALK + src[tail:]}


def ggr_cases(torch, cs, dev, stream):
    """(tag, reps, skip(name), launcher(lib) -> (go, result), want) of K13."""
    from autobzcore_torch import FBZ, GGR, InversionSymIBZ, load_bz
    from autobzcore_torch.dos import AdaptiveGaussianBroadening
    from autobzcore_torch.dos import ggr as G
    from autobzcore_torch.models.tight_binding import flagship_series, synthetic_wannier

    h = flagship_series(device=dev)
    bz = load_bz(FBZ(), np.eye(3))
    box = GGR(npt=cs.NPT).init_cacheval(h, 0.0, bz)
    gauss = AdaptiveGaussianBroadening(npt=cs.NPT).init_cacheval(h, 0.0, bz)
    s30 = synthetic_wannier(cs.BANDS30, nr=5, device=dev)
    box30 = GGR(npt=cs.BANDS30_NPT).init_cacheval(s30, 0.0, load_bz(InversionSymIBZ(), np.eye(3)))
    E = torch.as_tensor(np.linspace(*cs.WINDOW, cs.LTM_ENERGIES), device=dev)
    E30 = torch.as_tensor(np.linspace(*cs.BANDS30_WINDOW, cs.BANDS30_ENERGIES), device=dev)

    def case(c, En, gaussian):
        K, m = c["energies"].shape
        W = En.shape[0]
        if gaussian:
            mode, a, nrm, b, vtol, scale = 0, c["sigma"], c["norm"], 0.0, 0.0, c["inv_total"]
            want = G.gaussian_sum(c["energies"], a, nrm, c["weights"], En, scale)
        else:
            mode, a, nrm, b, vtol, scale = c["velocities"].shape[1], c["velocities"], None, c["b"], c["vtol"], 1.0
            want = G.ggr_box_sum(c["energies"], a, c["weights"], En, b, vtol)

        def launcher(lib):
            lib.ggr_dos_num_blocks.argtypes = [LL, INT, INT]
            lib.ggr_dos_num_blocks.restype = LL
            lib.ggr_dos_launch.argtypes = [INT, VP, VP, VP, VP, LL, INT, VP, INT, DBL, DBL, DBL, VP, VP, VP]
            out = torch.empty(W, dtype=torch.float64, device=dev)
            part = torch.empty((W, lib.ggr_dos_num_blocks(K, m, W)), dtype=torch.float64, device=dev)
            args = (mode, c["energies"].data_ptr(), a.data_ptr(), None if nrm is None else nrm.data_ptr(),
                    c["weights"].data_ptr(), K, m, En.data_ptr(), W, b, vtol, scale, part.data_ptr(),
                    out.data_ptr(), stream)
            return (lambda: lib.ggr_dos_launch(*args)), (lambda: out)
        return launcher, want

    return [("box1001", 10, None, *case(box, E, False)), ("gauss1001", 5, None, *case(gauss, E, True)),
            ("box30", 10, None, *case(box30, E30, False))]


# gm_pool.cu: K16
MERGE_OWN = "    for (int i = 0; i < kFast; ++i) {\n      mv[i] = %s[i];\n      ms[i] = %s[i];\n    }\n"


def pool_variants(src):
    p = lambda old, new: patch("gm_pool", src, old, new)  # noqa: E731
    return {"noscatter": p("        if (j < nb && at >= n0 && at < n0 + nb) continue;\n", "        continue;\n"),
            "noloads": p("          x[i] = s < cap ? p[s * stride] : 0.0;\n", "          x[i] = 0.25 * s;\n"),
            "noselect": p("    live = sh.live;\n  }\n", "    live = sh.live;\n  }\n  return;\n"),
            "rounds": p("  if (nb <= kFast) {\n", "  if (nb < 0) {\n"),
            "top1": p("    for (int base = tid; base < cap; base += kThreads * kBatch) {\n",
                      "    tv[0] = bv;\n    ts[0] = bs;\n"
                      "    for (int base = tid; base < 0; base += kThreads * kBatch) {\n"),
            "warpmerge0": p("    warp_merge(tv, ts, nb, mv, ms);\n", MERGE_OWN % ("tv", "ts")),
            "nochildren": p("    if (s >= 0) {\n", "    if (s < -1) {\n")}


def pool_cases(torch, cs, dev, stream):
    """(tag, reps, skip(name), launcher(lib) -> (go, result), want) of K16:
    the step of phase 23's trip (33 lanes x cap 4096 x d = 3, one value,
    nbisect 4) on a started pool of 33 random lanes whose n leaves room for
    the timed steps; the result is tot_err after one step."""
    from autobzcore_torch.ops import genz_malik as tgm

    rng = np.random.default_rng(16)
    L, cap, d, nb = cs.IAI_OMEGAS, 4096, 3, 4
    n = rng.integers(50, 400, L)
    live = np.arange(cap)[None, :] < n[:, None]
    put = lambda a, dt=torch.float64: torch.as_tensor(a, dtype=dt, device=dev)  # noqa: E731
    pool = tgm.GMPool(c=put(np.where(live[..., None], rng.random((L, cap, d)), 0.0)),
                      h=put(np.where(live[..., None], rng.random((L, cap, d)) * 0.1, 0.0)),
                      err=put(np.where(live, rng.random((L, cap)), 0.0)),
                      sd=put(np.where(live, rng.integers(0, d, (L, cap)), 0), torch.int32),
                      val=put(np.where(live, rng.normal(size=(L, cap)), 0.0)), n=put(n, torch.int64),
                      evals=put(np.zeros(L)), atol=put(np.zeros(L)), rtol=0.0, max_evals=1e300, npts=33,
                      active=torch.ones(L, dtype=torch.bool, device=dev))
    tgm.gm_pool_begin_plain(pool, nb)
    cval = put(rng.normal(size=(L, 2 * nb)))
    cerr = put(rng.random((L, 2 * nb)) * 1e-3)
    csd = put(rng.integers(0, d, (L, 2 * nb)), torch.int32)
    ref = pool.clone()
    tgm.gm_pool_step_plain(ref, nb, cval, cerr, csd)

    def launcher(lib):
        lib.gm_pool_launch.argtypes = [INT] + [VP] * 18 + [LL, INT, INT, INT, INT, DBL, DBL, DBL, VP]
        q = pool.clone()
        args = (1, q.c.data_ptr(), q.h.data_ptr(), q.err.data_ptr(), q.sd.data_ptr(), q.val.data_ptr(),
                q.n.data_ptr(), q.evals.data_ptr(), q.tot_val.data_ptr(), q.tot_err.data_ptr(), q.tol.data_ptr(),
                q.atol.data_ptr(), q.active.data_ptr(), q.idx.data_ptr(), q.cc.data_ptr(), q.hh.data_ptr(),
                cval.data_ptr(), cerr.data_ptr(), csd.data_ptr(), L, cap, d, 1, nb, float(2 * nb * 33), 0.0,
                1e300, stream)
        return (lambda: lib.gm_pool_launch(*args)), (lambda: q.tot_err)
    return [("step", 100, None, launcher, ref.tot_err)]


SOURCES = {"fourier_points": (fourier_variants, fourier_cases),
           "transport_gamma": (transport_variants, transport_cases),
           "sigma_pairs": (sigma_variants, sigma_cases),
           "tetra_dos": (tetra_variants, tetra_cases),
           "lindhard_chi0": (chi0_variants, chi0_cases),
           "dos_trace": (dos_variants, dos_cases),
           "sigma_trace": (trace_variants, trace_cases),
           "ggr_dos": (ggr_variants, ggr_cases),
           "gm_pool": (pool_variants, pool_cases)}


def main():
    argv = sys.argv[1:]
    if not argv or argv[0] not in SOURCES:
        sys.exit(__doc__)
    source = argv.pop(0)
    out_dir, others, only, base = None, {}, None, None
    while argv:
        flag = argv.pop(0)
        if flag == "--out" and argv:
            out_dir = Path(argv.pop(0))
        elif flag == "--base" and argv:
            base = Path(argv.pop(0)).read_text()
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
    srcs = {"package": text, **make_variants(text if base is None else base)}
    if base is not None:
        srcs["base"] = base
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
