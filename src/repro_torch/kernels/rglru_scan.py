"""ctypes wrapper of the hand-written CUDA RG-LRU scan kernel
(``csrc/rglru_scan.cu``; it replaces the Pallas TPU kernel
``repro/kernels/rglru_scan.py::rglru_scan``).

Built at first use by ``build.py``.  The wrapper checks device, dtype
(float32), shapes and contiguity, allocates the output with
``torch.empty``, launches on the current stream, raises on a non-zero
``cudaError_t`` and counts the launch in ``LAUNCHES["rglru_scan"]``.
"""
from __future__ import annotations

import ctypes

import torch

from repro_torch.kernels.build import (CudaLibrary, check, device_of,
                                       launched, stream)

_p, _i = ctypes.c_void_p, ctypes.c_int
LIB = CudaLibrary(
    "rglru_scan.cu",
    {"rglru_scan_launch": [_p, _p, _p, _i, _i, _i, _i, _p]},
    kernels=("rglru_scan",))


def rglru_scan(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """a, b [B, S, W] float32 on the card -> h [B, S, W], h_t = a_t·h_{t-1}
    + b_t from a zero state."""
    device = device_of(a)
    if a.dim() != 3:
        raise ValueError(f"a must be [B, S, W], got {tuple(a.shape)}")
    B, S, W = a.shape
    check("a", a, torch.float32, a.shape, device)
    check("b", b, torch.float32, a.shape, device)
    if B > 65535:
        raise ValueError(f"B = {B} exceeds the kernel's grid")
    out = torch.empty_like(a)
    if out.numel() == 0:
        return out
    err = LIB.lib().rglru_scan_launch(a.data_ptr(), b.data_ptr(),
                                      out.data_ptr(), B, S, W, device.index,
                                      stream(device))
    launched(err, "rglru_scan")
    return out
