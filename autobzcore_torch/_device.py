"""Dtype defaults and device checks.

The port computes in float64/complex128 everywhere: the H100 has native FP64,
so none of the reference's split-complex or two-float emulation is needed.
Every entry point that places data takes ``device=`` and defaults to the
card (``DEFAULT_DEVICE``); the CPU runs only when the caller names it, and a
CUDA device that is not present raises instead of degrading.
"""
from __future__ import annotations

import torch

REAL = torch.float64
COMPLEX = torch.complex128
DEFAULT_DEVICE = "cuda"


def as_device(device=DEFAULT_DEVICE) -> torch.device:
    """``torch.device`` for ``device`` (a string, index or device), raising
    ``RuntimeError`` if it names a CUDA device this process cannot use."""
    dev = torch.device(device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(f"device {dev} requested but CUDA is not available")
    return dev


def check_tensor(t, name, *, device=None, dtype=None, ndim=None, shape=None):
    """Raise ``ValueError`` unless ``t`` is a contiguous tensor with the given
    device type, dtype, rank and (where not None) dimension sizes."""
    if not isinstance(t, torch.Tensor):
        raise TypeError(f"{name} must be a torch.Tensor, got {type(t).__name__}")
    if device is not None:
        # a torch.device is compared as it is (building one costs a call)
        on = t.device
        if on != (device if isinstance(device, torch.device) else torch.device(device)):
            raise ValueError(f"{name} is on {on}, expected {device}")
    if dtype is not None and t.dtype != dtype:
        raise ValueError(f"{name} has dtype {t.dtype}, expected {dtype}")
    if ndim is not None and t.ndim != ndim:
        raise ValueError(f"{name} has {t.ndim} dims, expected {ndim}")
    if shape is not None:
        for i, (got, want) in enumerate(zip(t.shape, shape)):
            if want is not None and got != want:
                raise ValueError(f"{name} has shape {tuple(t.shape)}; dim {i} must be {want}")
    if not t.is_contiguous():
        raise ValueError(f"{name} must be contiguous")
