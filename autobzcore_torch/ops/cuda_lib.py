"""Build and bind the port's CUDA kernels.

All of ``autobzcore_torch/csrc/*.cu`` compile with ``nvcc`` for ``sm_90a``,
one compiler process per source, all started together, and link into one
shared library with a plain C interface, loaded with ``ctypes``. The build
runs at the first kernel launch in a process (never at import), into
``build/autobzcore_torch/``, and again only when a source or header is
newer than the library.
"""
from __future__ import annotations

import ctypes
import os
import shutil
import subprocess
import tempfile
import threading
import time
from pathlib import Path

from .._build import BUILD_DIR, PACKAGE_DIR, build_shared, is_stale

SOURCES = tuple(sorted((PACKAGE_DIR / "csrc").glob("*.cu")))
HEADERS = tuple(sorted((PACKAGE_DIR / "csrc").glob("*.cuh")))
LIBRARY = BUILD_DIR / "libautobz_kernels.so"
ARCH = ("-gencode", "arch=compute_90a,code=sm_90a")
NVCC_FLAGS = ARCH + ("-std=c++17", "-O3", "-Xcompiler", "-fPIC", "-Xptxas", "-v")

_LOCK = threading.Lock()
_LIB = None


def nvcc_path():
    """The CUDA compiler: ``nvcc`` on PATH, else under ``$CUDA_HOME`` or
    ``/usr/local/cuda``; raises when there is none."""
    found = shutil.which("nvcc")
    if found:
        return found
    for root in (os.environ.get("CUDA_HOME"), "/usr/local/cuda"):
        if root and (Path(root) / "bin" / "nvcc").exists():
            return str(Path(root) / "bin" / "nvcc")
    raise RuntimeError("nvcc not found: the CUDA kernels need the CUDA toolkit")


def _bind(lib):
    vp, ll, i, dbl = ctypes.c_void_p, ctypes.c_longlong, ctypes.c_int, ctypes.c_double
    lib.fourier_points_launch.argtypes = [vp, vp, vp, ll, i, i, i, i, i, i, i,
                                          dbl, dbl, dbl, i, vp]
    lib.fourier_points_launch.restype = i
    lib.dos_trace_num_chunks.argtypes = [ll]
    lib.dos_trace_num_chunks.restype = ll
    lib.dos_trace_weighted_sum_launch.argtypes = [vp, vp, vp, vp, vp, vp, ll, i, i,
                                                  dbl, i, vp]
    lib.dos_trace_weighted_sum_launch.restype = i
    lib.fourier_contract_launch.argtypes = [vp] * 4 + [ll, i, ll, i, i, ll, i, dbl, vp]
    lib.fourier_contract_launch.restype = i
    lib.gk_leaf_dos_launch.argtypes = [vp] * 14 + [ll, ll, i, i, i, i, i, i, dbl, vp]
    lib.gk_leaf_dos_launch.restype = i
    lib.gk_pool_select_launch.argtypes = [vp] * 11 + [ll, i, i, dbl, vp]
    lib.gk_pool_select_launch.restype = i
    lib.gk_pool_update_launch.argtypes = [vp] * 19 + [ll, i, i, i, dbl, i, vp]
    lib.gk_pool_update_launch.restype = i
    lib.gk_rule_reduce_launch.argtypes = [vp] * 9 + [ll, i, i, i, i, vp]
    lib.gk_rule_reduce_launch.restype = i
    lib.gk_pool_seed_launch.argtypes = [vp] * 19 + [ll, i, i, i, i, dbl, vp]
    lib.gk_pool_seed_launch.restype = i
    lib.gk_coarsen_launch.argtypes = [vp] * 9 + [ll, i, i, dbl, dbl, vp]
    lib.gk_coarsen_launch.restype = i
    lib.eigvalsh_small_launch.argtypes = [vp, vp, ll, i, vp]
    lib.eigvalsh_small_launch.restype = i
    lib.lorentz_num_blocks.argtypes = [ll, i]
    lib.lorentz_num_blocks.restype = ll
    lib.lorentzian_sum_launch.argtypes = [vp, vp, ll, i, vp, i, dbl, dbl, vp, vp, vp]
    lib.lorentzian_sum_launch.restype = i
    lib.fullgrid_tail_launch.argtypes = [vp, vp, ll, ll, i, i, vp, i, dbl, dbl, vp, vp, vp]
    lib.fullgrid_tail_launch.restype = i
    lib.tetra_num_blocks.argtypes = [ll, i]
    lib.tetra_num_blocks.restype = ll
    lib.tetra_dos_launch.argtypes = [vp, ll, i, i, vp, i, dbl, dbl, i, vp, vp, vp]
    lib.tetra_dos_launch.restype = i
    return lib


def build_kernels(timeout=600):
    """Compile the kernel library from the sources, one ``nvcc -c`` per
    source in parallel, then link; returns (seconds, the compilers' output,
    which holds ptxas' register and spill report)."""
    t0 = time.perf_counter()
    nvcc = nvcc_path()
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    with tempfile.TemporaryDirectory(dir=BUILD_DIR) as tmp:
        objs = [Path(tmp) / (src.stem + ".o") for src in SOURCES]
        procs = [subprocess.Popen([nvcc, *NVCC_FLAGS, "-c", str(src), "-o", str(obj)],
                                  stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
                 for src, obj in zip(SOURCES, objs)]
        logs, failed = [], []
        try:
            for src, proc in zip(SOURCES, procs):
                out, _ = proc.communicate(timeout=timeout)
                logs.append(f"{src.name}:\n{out}")
                if proc.returncode != 0:
                    failed.append(src.name)
        finally:
            for proc in procs:
                if proc.poll() is None:
                    proc.kill()
                    proc.wait()
        if failed:
            raise RuntimeError(f"nvcc failed on {', '.join(failed)}:\n" + "\n".join(logs))
        logs.append(build_shared([nvcc, *ARCH, "-shared"], objs, LIBRARY, timeout=timeout))
    return time.perf_counter() - t0, "\n".join(logs)


def load_kernels():
    """ctypes handle of the kernel library, building it first if needed."""
    global _LIB
    with _LOCK:
        if _LIB is None:
            if is_stale(LIBRARY, SOURCES + HEADERS):
                build_kernels()
            _LIB = _bind(ctypes.CDLL(str(LIBRARY)))
        return _LIB


def check_launch(err, name):
    """Raise if a launch function returned a CUDA error code."""
    if err != 0:
        raise RuntimeError(f"{name}: CUDA error {err} at launch")
