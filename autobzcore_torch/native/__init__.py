"""Native (C++) host kernels, built on demand with a numpy fallback."""
from .build import load_symptr_lib

__all__ = ["load_symptr_lib"]
