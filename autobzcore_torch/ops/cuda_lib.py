"""Build and bind the port's CUDA kernels.

All of ``autobzcore_torch/csrc/*.cu`` compile with ``nvcc`` for ``sm_90a``
into one shared library with a plain C interface, loaded with ``ctypes``.
The build runs at the first kernel launch in a process (never at import),
into ``build/autobzcore_torch/``, and again only when a source is newer than
the library.
"""
from __future__ import annotations

import ctypes
import os
import shutil
import threading
import time
from pathlib import Path

from .._build import BUILD_DIR, PACKAGE_DIR, build_shared, is_stale

SOURCES = tuple(sorted((PACKAGE_DIR / "csrc").glob("*.cu")))
LIBRARY = BUILD_DIR / "libautobz_kernels.so"
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
              "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v")

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
                                                  dbl, vp]
    lib.dos_trace_weighted_sum_launch.restype = i
    return lib


def build_kernels():
    """Compile the kernel library from the sources; returns (seconds, the
    compiler's output, which holds ptxas' register and spill report)."""
    t0 = time.perf_counter()
    log = build_shared([nvcc_path(), *NVCC_FLAGS], SOURCES, LIBRARY)
    return time.perf_counter() - t0, log


def load_kernels():
    """ctypes handle of the kernel library, building it first if needed."""
    global _LIB
    with _LOCK:
        if _LIB is None:
            if is_stale(LIBRARY, SOURCES):
                build_kernels()
            _LIB = _bind(ctypes.CDLL(str(LIBRARY)))
        return _LIB


def check_launch(err, name):
    """Raise if a launch function returned a CUDA error code."""
    if err != 0:
        raise RuntimeError(f"{name}: CUDA error {err} at launch")
