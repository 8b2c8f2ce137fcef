#!/usr/bin/env python3
"""Time variants of K1 and K11 (``autobzcore_torch/csrc/fourier_points.cu``)
on one NVIDIA GPU, at the main path's shapes, against their plain versions.

    python3 tools/fourier_variants.py [--other NAME=SOURCE.cu ...] [--out DIR]

Each variant is a copy of the package's source, changed by a text patch,
built on its own with the package's nvcc flags into a library of its own
under ``build/autobzcore_torch/variants/``:

- ``package``: the source as it is;
- ``ctiles=N`` (N = 1, 2, 3, 5, 9): the column tiles forced to N (at most
  one a four outputs), where the package chooses them from the point tiles
  and the SM count;
- ``nostore``: the epilogue's stores taken out (its outputs are garbage):
  the most that any cheaper epilogue could save;
- ``staged``: the epilogue staged through shared memory (a warp's 16 points
  by its column tile), so that each warp writes whole lines of the (K, R,
  V) output.

``--other NAME=SOURCE.cu`` adds another source with the same C entry points
as it is, for example the parent's (``git show HEAD~1:...`` into a file).
Shapes: K1 and K11 (R = 4, V = 9) on the flagship at the 1e6 points of the
100^3 grid, K11 at a GGR init / transport pack chunk (its first 4,096
points), K1 at a k-path's 3,787 points. Each variant is timed in two rounds,
by events, by torch.profiler's device time and by the host time of its
ctypes launch. The last line is a JSON object of the numbers; with ``--out
DIR`` a copy goes to ``DIR/fourier_variants.json``.
"""
import ctypes
import importlib.util
import json
import subprocess
import sys
from concurrent.futures import ThreadPoolExecutor
from pathlib import Path

REPO = Path(__file__).resolve().parent.parent
sys.path.insert(0, str(REPO))

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


def patch(src, old, new):
    if src.count(old) != 1:
        sys.exit(f"fourier_points.cu no longer holds the text this variant patches:\n{old}")
    return src.replace(old, new)


def variants(src):
    out = {"package": src}
    for n in (1, 2, 3, 5, 9):
        out[f"ctiles={n}"] = patch(src, TILES, f"  ctiles = {n} < (VP + 3) / 4 ? {n} : (VP + 3) / 4;\n" + TILES)
    out["nostore"] = patch(src, EPILOGUE, EPILOGUE.replace("if (j < G.VP) {", "if (j < G.VP && acc[nt][0] == 1e300) {"))
    staged = patch(src, EPILOGUE, STAGED)
    staged = patch(staged, SMEM, "  const int smem = G.CS * slab_bytes + kWarps * 16 * 4 * TN * 16;\n")
    out["staged"] = patch(staged, OPT_IN, "cudaFuncAttributeMaxDynamicSharedMemorySize, kSmemBudget + kWarps * 16 * 36 * 16)")
    return out


def main():
    argv = sys.argv[1:]
    out_dir, others = None, {}
    while argv:
        flag = argv.pop(0)
        if flag == "--out" and argv:
            out_dir = Path(argv.pop(0))
        elif flag == "--other" and argv and "=" in argv[0]:
            name, path = argv.pop(0).split("=", 1)
            others[name] = Path(path).read_text()
        else:
            sys.exit(__doc__)

    import torch

    from autobzcore_torch.algorithms.ptr import frac_nodes
    from autobzcore_torch.models.tight_binding import flagship_series
    from autobzcore_torch.ops import cuda_lib
    from autobzcore_torch.ops import fourier_eval as fe

    if not torch.cuda.is_available():
        sys.exit("needs a CUDA card")
    spec = importlib.util.spec_from_file_location("chip_smoke", REPO / "chip_smoke.py")
    cs = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(cs)
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True, timeout=60).stdout.strip()
    print(smi, flush=True)
    srcs = variants((REPO / "autobzcore_torch" / "csrc" / "fourier_points.cu").read_text())
    srcs.update(others)
    vdir = cuda_lib.BUILD_DIR / "variants"
    vdir.mkdir(parents=True, exist_ok=True)

    def build(item):
        i, (name, text) = item
        (vdir / f"v{i}.cu").write_text(text)
        r = subprocess.run([cuda_lib.nvcc_path(), *cuda_lib.NVCC_FLAGS, "-shared", str(vdir / f"v{i}.cu"), "-o",
                            str(vdir / f"v{i}.so")], capture_output=True, text=True, timeout=600)
        if r.returncode:
            sys.exit(f"{name}: build failed\n{r.stdout[-3000:]}{r.stderr[-3000:]}")
        return name, vdir / f"v{i}.so"

    with ThreadPoolExecutor(len(srcs)) as ex:
        paths = dict(ex.map(build, enumerate(srcs.items())))
    vp, ll, i, dbl = ctypes.c_void_p, ctypes.c_longlong, ctypes.c_int, ctypes.c_double
    libs = {}
    for name, path in paths.items():
        lib = ctypes.CDLL(str(path))
        lib.fourier_points_launch.argtypes = [vp, vp, vp, ll] + [i] * 7 + [dbl] * 3 + [i, vp]
        lib.fourier_points_derivs_launch.argtypes = [vp, vp, vp, ll] + [i] * 7 + [dbl] * 3 + [
            i, i, ctypes.POINTER(i), vp]
        libs[name] = lib

    dev = torch.device("cuda", 0)
    h = flagship_series(device=dev)
    Xg = (frac_nodes(cs.NPT, 3, dev) * torch.as_tensor(h.period, device=dev)).contiguous()
    orders = fe.jacobian_orders(3)
    flat = (ctypes.c_int * 12)(*[o for order in orders for o in order])
    stream = torch.cuda.current_stream(dev).cuda_stream
    want = {False: fe.fourier_points_plain(h.c, Xg, h.offset, h.period),
            True: fe.fourier_points_derivs_plain(h.c, Xg, h.offset, h.period, orders)}
    shapes = (("k1_1e6", Xg.shape[0], False, 10), ("k11_1e6", Xg.shape[0], True, 10),
              ("k11_4096", 4096, True, 300), ("k1_3787", 3787, False, 300))

    def launcher(lib, K, deriv):
        X = Xg[:K]
        out = torch.empty((K, 4 if deriv else 1, 3, 3), dtype=torch.complex128, device=dev)
        head = (h.c.data_ptr(), X.data_ptr(), out.data_ptr(), K, 3, 5, 5, 5, *h.offset, *h.period, 9)
        fn, args = ((lib.fourier_points_derivs_launch, head + (4, flat, stream)) if deriv else
                    (lib.fourier_points_launch, head + (stream,)))

        def go():
            err = fn(*args)
            if err:
                raise RuntimeError(f"CUDA error {err} at launch")
        return go, out

    res = {"card": smi}
    for rnd in range(2):
        for name, lib in libs.items():
            for shape, K, deriv, reps in shapes:
                if name.startswith("ctiles") and K > 4096:
                    continue  # the point tiles alone fill the card there
                go, out = launcher(lib, K, deriv)
                go()
                torch.cuda.synchronize()
                w = want[deriv][:K]
                rel = float(((out if deriv else out[:, 0]) - w).abs().max() / w.abs().max())
                r = {"rel": rel, "ms": cs.cuda_ms(go, reps), "device_ms": cs.device_ms(go, min(reps, 100)),
                     "host_us": cs.host_us(go, reps)}
                res.setdefault(f"{name}:{shape}", []).append(r)
                dm = "not captured" if r["device_ms"] is None else f"{r['device_ms']:.5f} ms"
                print(f"round {rnd} {name} {shape}: rel {rel:.2e}, events {r['ms']:.5f} ms, device {dm}, "
                      f"host {r['host_us']:.1f} us", flush=True)
                del out
            torch.cuda.empty_cache()
    if out_dir is not None:
        out_dir.mkdir(parents=True, exist_ok=True)
        (out_dir / "fourier_variants.json").write_text(json.dumps(res, indent=1))
    print(json.dumps(res), flush=True)


if __name__ == "__main__":
    main()
