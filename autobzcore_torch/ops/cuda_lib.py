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

import torch

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
    lib.fourier_points_derivs_launch.argtypes = [vp, vp, vp, ll, i, i, i, i, i, i, i,
                                                 dbl, dbl, dbl, i, i, ctypes.POINTER(i), vp]
    lib.fourier_points_derivs_launch.restype = i
    lib.band_velocity_launch.argtypes = [vp, vp, vp, ll, i, i, ll, ll, vp]
    lib.band_velocity_launch.restype = i
    lib.band_velocity_eigh_launch.argtypes = [vp, vp, vp, ll, i, i, vp]
    lib.band_velocity_eigh_launch.restype = i
    lib.ggr_dos_launch.argtypes = [i, vp, vp, vp, vp, ll, i, vp, i, dbl, dbl, dbl, vp, vp, vp]
    lib.ggr_dos_launch.restype = i
    lib.dos_trace_num_chunks.argtypes = [ll]
    lib.dos_trace_num_chunks.restype = ll
    lib.dos_trace_weighted_sum_launch.argtypes = [vp, vp, vp, vp, vp, vp, ll, i, i,
                                                  dbl, i, vp]
    lib.dos_trace_weighted_sum_launch.restype = i
    lib.fourier_contract_launch.argtypes = [vp] * 4 + [ll, i, ll, i, i, ll, i, dbl, vp]
    lib.fourier_contract_launch.restype = i
    lib.gk_leaf_dos_launch.argtypes = [vp] * 14 + [ll, ll, i, i, i, i, i, i, dbl, vp]
    lib.gk_leaf_dos_launch.restype = i
    lib.gk_leaf_dos_solve_smem.argtypes = [i] * 6
    lib.gk_leaf_dos_solve_smem.restype = ll
    lib.gk_leaf_dos_solve_launch.argtypes = [vp] * 20 + [ll, ll] + [i] * 7 + [dbl, dbl, dbl, vp]
    lib.gk_leaf_dos_solve_launch.restype = i
    pool = ctypes.POINTER(vp)  # a pool's pointers, as one array
    lib.gk_pool_start_launch.argtypes = [pool, vp, vp, i] + [vp] * 8 + [ll, i, i, i, dbl, dbl] + [i] * 4 + [vp]
    lib.gk_pool_start_launch.restype = i
    lib.gk_pool_seed_launch.argtypes = ([pool] + [vp] * 5 + [i] + [vp] * 8 + [ll, i, i, i, dbl, dbl]
                                        + [i] * 5 + [vp])
    lib.gk_pool_seed_launch.restype = i
    lib.gk_pool_step_launch.argtypes = [pool] + [vp] * 9 + [ll, ll, i, i, i, dbl, dbl] + [i] * 3 + [vp]
    lib.gk_pool_step_launch.restype = i
    lib.gk_rule_reduce_launch.argtypes = [vp] * 9 + [ll, i, i, i, i, vp]
    lib.gk_rule_reduce_launch.restype = i
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
    lib.ggr_dos_num_blocks.argtypes = [ll, i, i]
    lib.ggr_dos_num_blocks.restype = ll
    lib.tetra_dos_num_blocks.argtypes = [ll, i, i, i]
    lib.tetra_dos_num_blocks.restype = ll
    lib.tetra_dos_launch.argtypes = [vp, ll, i, i, vp, i, dbl, dbl, i, vp, vp, vp]
    lib.tetra_dos_launch.restype = i
    lib.gm_rule_reduce_launch.argtypes = [vp] * 8 + [ll, i, i, i, i, dbl, vp]
    lib.gm_rule_reduce_launch.restype = i
    lib.gm_leaf_dos_launch.argtypes = [vp] * 10 + [ll, i, i, i, i, dbl, dbl, vp]
    lib.gm_leaf_dos_launch.restype = i
    lib.gm_pool_launch.argtypes = [i] + [vp] * 18 + [ll, i, i, i, i, dbl, dbl, dbl, vp]
    lib.gm_pool_launch.restype = i
    lib.fixed_rule_reduce_launch.argtypes = [vp] * 4 + [ll, i, i, i, vp]
    lib.fixed_rule_reduce_launch.restype = i
    lib.velocity_pairs_max_bands.argtypes = [i]
    lib.velocity_pairs_max_bands.restype = i
    lib.velocity_pairs_launch.argtypes = [vp, vp, vp, vp, ll, i, i, ll, ll, vp]
    lib.velocity_pairs_launch.restype = i
    lib.transport_gamma_num_chunks.argtypes = [ll]
    lib.transport_gamma_num_chunks.restype = ll
    lib.transport_gamma_max_bands.argtypes = []
    lib.transport_gamma_max_bands.restype = i
    lib.transport_gamma_launch.argtypes = [vp, vp, ll, i, i, vp, vp, vp, vp, ll, i, dbl, vp, vp, vp]
    lib.transport_gamma_launch.restype = i
    lib.fermi_count_num_chunks.argtypes = [ll, i]
    lib.fermi_count_num_chunks.restype = ll
    lib.fermi_count_launch.argtypes = [vp, vp, ll, i, dbl, dbl, vp, vp, vp]
    lib.fermi_count_launch.restype = i
    lib.berry_pairs_max_bands.argtypes = [i, i]
    lib.berry_pairs_max_bands.restype = i
    lib.berry_pairs_launch.argtypes = [vp] * 9 + [ll, i, i, ll, ll, dbl, i, vp]
    lib.berry_pairs_launch.restype = i
    lib.plaquette_flux_num_chunks.argtypes = [ll, ll]
    lib.plaquette_flux_num_chunks.restype = ll
    lib.plaquette_flux_launch.argtypes = [vp, i, i, i, i, vp, vp, vp]
    lib.plaquette_flux_launch.restype = i
    lib.wilson_loops_launch.argtypes = [vp, i, i, i, i, vp, vp]
    lib.wilson_loops_launch.restype = i
    lib.zone_average_num_rows.argtypes = [ll, i, i, i, i, i]
    lib.zone_average_num_rows.restype = ll
    lib.zone_average_launch.argtypes = [vp, vp, vp, ll, i, i, i, i, dbl, dbl, ll, vp, vp, vp]
    lib.zone_average_launch.restype = i
    lib.chi0_num_blocks.argtypes = [ll, i]
    lib.chi0_num_blocks.restype = ll
    lib.chi0_max_bands.argtypes = []
    lib.chi0_max_bands.restype = i
    lib.chi0_launch.argtypes = [vp, vp, vp, i, i, ctypes.POINTER(i), i, vp, i, dbl, dbl, vp, vp, vp]
    lib.chi0_launch.restype = i
    lib.cooper_num_chunks.argtypes = [ll, i]
    lib.cooper_num_chunks.restype = ll
    lib.cooper_launch.argtypes = [vp, vp, i, i, ctypes.POINTER(i), i, dbl, dbl, vp, vp, vp]
    lib.cooper_launch.restype = i
    lib.sigma_max_bands.argtypes = []
    lib.sigma_max_bands.restype = i
    lib.sigma_trace_num_chunks.argtypes = [ll]
    lib.sigma_trace_num_chunks.restype = ll
    lib.sigma_trace_sum_launch.argtypes = [vp] * 5 + [ll, i, i, i, dbl, vp]
    lib.sigma_trace_sum_launch.restype = i
    lib.sigma_trace_points_launch.argtypes = [vp, vp, ll, vp, ll, i, vp]
    lib.sigma_trace_points_launch.restype = i
    lib.sigma_pairs_num_chunks.argtypes = [ll]
    lib.sigma_pairs_num_chunks.restype = ll
    lib.sigma_pairs_sum_launch.argtypes = [vp] * 5 + [i, vp, vp, ll, i, i, i, dbl, vp]
    lib.sigma_pairs_sum_launch.restype = i
    lib.sigma_pairs_points_launch.argtypes = [vp, vp, vp, ll, vp, ll, i, i, vp]
    lib.sigma_pairs_points_launch.restype = i
    lib.sigma_spectral_num_rows.argtypes = [ll]
    lib.sigma_spectral_num_rows.restype = ll
    lib.sigma_spectral_sum_launch.argtypes = [vp, vp, vp, i, vp, vp, ll, i, i, dbl, vp]
    lib.sigma_spectral_sum_launch.restype = i
    lib.sigma_spectral_points_launch.argtypes = [vp, vp, ll, i, vp, ll, i, dbl, vp]
    lib.sigma_spectral_points_launch.restype = i
    lib.spectral_path_max_bands.argtypes = []
    lib.spectral_path_max_bands.restype = i
    lib.spectral_path_launch.argtypes = [vp, vp, vp, ll, i, i, dbl, dbl, vp]
    lib.spectral_path_launch.restype = i
    lib.band_expect_max_bands.argtypes = []
    lib.band_expect_max_bands.restype = i
    lib.band_expect_launch.argtypes = [vp, vp, vp, ll, i, i, vp]
    lib.band_expect_launch.restype = i
    lib.transport_points_max_bands.argtypes = []
    lib.transport_points_max_bands.restype = i
    lib.transport_points_launch.argtypes = [vp] * 6 + [ll, i, i, ll, ll, dbl, vp]
    lib.transport_points_launch.restype = i
    lib.transport_points_eigh_launch.argtypes = [vp, ll, vp, ll, ll, vp, ll, dbl, vp, ll, dbl, vp, ll, i, i, dbl, vp]
    lib.transport_points_eigh_launch.restype = i
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


def sass_counts(library, opcode, name_part):
    """For each entry function of ``library`` whose name holds ``name_part``:
    how many SASS instructions start with ``opcode`` (e.g. ``"DMMA"``), read
    from ``cuobjdump --dump-sass``, the toolkit's disassembler beside nvcc."""
    tool = shutil.which("cuobjdump") or str(Path(nvcc_path()).parent / "cuobjdump")
    sass = subprocess.run([tool, "--dump-sass", str(library)], capture_output=True, text=True,
                          timeout=300, check=True).stdout
    counts, name = {}, None
    for line in sass.splitlines():
        if "Function :" in line:
            name = line.split("Function :", 1)[1].strip()
            if name_part in name:
                counts[name] = 0
        elif name in counts:
            op = line.split("*/", 1)[1].strip() if "*/" in line else ""
            if op.lstrip("@!P0123456789T ").startswith(opcode):
                counts[name] += 1
    return counts


def load_kernels():
    """ctypes handle of the kernel library, building it first if needed.
    Once loaded, the handle is returned without taking the lock."""
    global _LIB
    lib = _LIB
    if lib is not None:
        return lib
    with _LOCK:
        if _LIB is None:
            if is_stale(LIBRARY, SOURCES + HEADERS):
                build_kernels()
            _LIB = _bind(ctypes.CDLL(str(LIBRARY)))
        return _LIB


def stream_handle(device):
    """The raw handle (an int) of PyTorch's current stream on the CUDA
    ``device``, for a kernel launch: the value of
    ``torch.cuda.current_stream(device).cuda_stream`` without building a
    stream object."""
    index = device.index
    return torch._C._cuda_getCurrentRawStream(torch.cuda.current_device() if index is None else index)


def check_launch(err, name):
    """Raise if a launch function returned a CUDA error code."""
    if err != 0:
        raise RuntimeError(f"{name}: CUDA error {err} at launch")
