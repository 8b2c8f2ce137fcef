"""Lazy g++ build and ctypes binding of the host symmetry-reduction kernel
(``symptr.cpp``); ``ops/symptr.py`` falls back to numpy without it."""
from __future__ import annotations

import ctypes
import shutil
import subprocess
import threading

from .._build import BUILD_DIR, PACKAGE_DIR, build_shared, is_stale

_LOCK = threading.Lock()
_LIB = None
_TRIED = False


def load_symptr_lib():
    """Return the ctypes handle of the symptr library, or None when no C++
    compiler can build it."""
    global _LIB, _TRIED
    with _LOCK:
        if _TRIED:
            return _LIB
        _TRIED = True
        src = PACKAGE_DIR / "native" / "symptr.cpp"
        out = BUILD_DIR / "_symptr.so"
        if is_stale(out, [src]):
            if shutil.which("g++") is None:
                return None
            base = ["g++", "-O3", "-shared", "-fPIC", "-std=c++17"]
            try:
                build_shared(base + ["-fopenmp"], [src], out, timeout=120)
            except (RuntimeError, OSError, subprocess.TimeoutExpired):
                try:
                    build_shared(base, [src], out, timeout=120)
                except (RuntimeError, OSError, subprocess.TimeoutExpired):
                    return None
        try:
            lib = ctypes.CDLL(str(out))
        except OSError:
            return None
        lib.symptr_canonicalize.argtypes = [
            ctypes.c_int64, ctypes.c_int64, ctypes.c_int64,
            ctypes.POINTER(ctypes.c_int64), ctypes.POINTER(ctypes.c_int64),
        ]
        lib.symptr_canonicalize.restype = None
        _LIB = lib
        return _LIB
