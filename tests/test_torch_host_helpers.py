"""The host helpers every kernel wrapper calls (``_device.check_tensor``,
``ops.cuda_lib.load_kernels``): each of ``check_tensor``'s branches raises
the same exception type with the same message whether ``device`` is given
as a string or as a ``torch.device``, and a loaded kernel library is
returned without taking the build lock."""
import threading

import pytest
import torch

from autobzcore_torch._device import check_tensor
from autobzcore_torch.ops import cuda_lib

T = torch.zeros((3, 4), dtype=torch.float64)


@pytest.mark.parametrize("t,kwargs,exc,message", [
    ([1.0], {}, TypeError, "x must be a torch.Tensor, got list"),
    (T, {"device": "meta"}, ValueError, "x is on cpu, expected meta"),
    (T, {"device": torch.device("meta")}, ValueError, "x is on cpu, expected meta"),
    (T, {"dtype": torch.float32}, ValueError, "x has dtype torch.float64, expected torch.float32"),
    (T, {"ndim": 3}, ValueError, "x has 2 dims, expected 3"),
    (T, {"shape": (3, 5)}, ValueError, "x has shape (3, 4); dim 1 must be 5"),
    (T, {"shape": (2, None)}, ValueError, "x has shape (3, 4); dim 0 must be 2"),
    (T.t(), {}, ValueError, "x must be contiguous"),
    (T, {"device": "cpu", "dtype": torch.float64, "ndim": 2, "shape": (3, None)}, None, None),
    (T, {"device": torch.device("cpu"), "shape": (None, 4, 7)}, None, None),
], ids=["type", "device-str", "device-obj", "dtype", "ndim", "shape", "shape-none", "contiguous", "ok-str",
        "ok-obj"])
def test_check_tensor_branches_keep_their_exceptions(t, kwargs, exc, message):
    if exc is None:
        check_tensor(t, "x", **kwargs)
        return
    with pytest.raises(exc) as info:
        check_tensor(t, "x", **kwargs)
    assert str(info.value) == message


def test_loaded_kernel_library_is_returned_without_the_lock(monkeypatch):
    sentinel = object()
    monkeypatch.setattr(cuda_lib, "_LIB", sentinel)
    got = []
    with cuda_lib._LOCK:  # held: a lookup that took it would wait here
        worker = threading.Thread(target=lambda: got.append(cuda_lib.load_kernels()))
        worker.start()
        worker.join(timeout=10)
    assert got == [sentinel]
