"""ctypes wrapper of the hand-written CUDA RG-LRU scan backward
(``csrc/rglru_scan_bwd.cu``).  The TPU kernel
``repro/kernels/rglru_scan.py::rglru_scan`` has no backward: JAX
differentiates the plain scan, whose gradient this kernel computes for the
port's forward kernel.  ``ops.rglru_scan`` pairs the two in a
``torch.autograd.Function``; the plain twin is ``ref.rglru_scan_bwd``.

Built at first use by ``build.py``.  The wrapper checks device, dtype
(float32), shapes and contiguity as the forward's does, allocates da and db
with ``torch.empty``, launches on the current stream, raises on a non-zero
``cudaError_t`` and counts the launch in ``LAUNCHES["rglru_scan_bwd"]``.
"""
from __future__ import annotations

import ctypes
from typing import Tuple

import torch

from repro_torch.kernels.build import (CudaLibrary, check, device_of,
                                       launched, stream)

_p, _i = ctypes.c_void_p, ctypes.c_int
LIB = CudaLibrary(
    "rglru_scan_bwd.cu",
    {"rglru_scan_bwd_launch": [_p] * 5 + [_i] * 4 + [_p]},
    kernels=("rglru_scan_bwd",))


def rglru_scan_bwd(a: torch.Tensor, h: torch.Tensor, dy: torch.Tensor
                   ) -> Tuple[torch.Tensor, torch.Tensor]:
    """a, the forward's output h and its cotangent dy, [B, S, W] float32 on
    the card -> (da, db): g_t = dy_t + a_{t+1}·g_{t+1}, db_t = g_t, da_t =
    g_t·h_{t-1}."""
    device = device_of(a)
    if a.dim() != 3:
        raise ValueError(f"a must be [B, S, W], got {tuple(a.shape)}")
    B, S, W = a.shape
    for name, t in (("a", a), ("h", h), ("dy", dy)):
        check(name, t, torch.float32, a.shape, device)
    if B > 65535:
        raise ValueError(f"B = {B} exceeds the kernel's grid")
    da, db = torch.empty_like(a), torch.empty_like(a)
    if a.numel() == 0:
        return da, db
    err = LIB.lib().rglru_scan_bwd_launch(
        a.data_ptr(), h.data_ptr(), dy.data_ptr(), da.data_ptr(),
        db.data_ptr(), B, S, W, device.index, stream(device))
    launched(err, "rglru_scan_bwd")
    return da, db
