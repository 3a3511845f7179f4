"""ctypes wrapper of the hand-written CUDA RMSNorm kernel
(``csrc/rmsnorm.cu``; it replaces the Pallas TPU kernel
``repro/kernels/rmsnorm.py::rmsnorm``).

Built at first use by ``build.py``.  The wrapper checks device, dtype (x
float32 or bfloat16, scale float32), shapes and contiguity, allocates the
output with ``torch.empty``, launches on the current stream, raises on a
non-zero ``cudaError_t`` and counts the launch in ``LAUNCHES["rmsnorm"]``.
"""
from __future__ import annotations

import ctypes

import torch

from repro_torch.kernels.build import (DTYPES, CudaLibrary, check,
                                       device_of, launched, stream)

_p, _i, _f = ctypes.c_void_p, ctypes.c_int, ctypes.c_float
LIB = CudaLibrary(
    "rmsnorm.cu",
    {"rmsnorm_launch": [_p, _p, _p, _i, _i, _f, _i, _i, _p]},
    kernels=("rmsnorm",))


def rmsnorm(x: torch.Tensor, scale: torch.Tensor,
            eps: float = 1e-6) -> torch.Tensor:
    """x [..., d] on the card; scale [d] float32 -> x · rsqrt(mean(x²) +
    eps) · scale in x's dtype."""
    device = device_of(x)
    if x.dim() == 0 or x.shape[-1] == 0:
        raise ValueError(f"x must have a non-empty last axis, got "
                         f"{tuple(x.shape)}")
    if x.dtype not in DTYPES:
        raise TypeError(f"x has dtype {x.dtype}; the kernel takes float32 "
                        f"or bfloat16")
    d = x.shape[-1]
    check("x", x, x.dtype, x.shape, device)
    check("scale", scale, torch.float32, (d,), device)
    rows = x.numel() // d
    if rows >= 2 ** 31:
        raise ValueError(f"{rows} rows exceed the kernel's grid")
    out = torch.empty_like(x)
    if rows == 0:
        return out
    err = LIB.lib().rmsnorm_launch(
        x.data_ptr(), scale.data_ptr(), out.data_ptr(), rows, d, float(eps),
        DTYPES[x.dtype], device.index, stream(device))
    launched(err, "rmsnorm")
    return out
