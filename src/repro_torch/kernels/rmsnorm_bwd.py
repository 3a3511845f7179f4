"""ctypes wrapper of the hand-written CUDA RMSNorm backward
(``csrc/rmsnorm_bwd.cu``).  The TPU kernel
``repro/kernels/rmsnorm.py::rmsnorm`` has no backward: JAX differentiates
the plain path, whose gradient this kernel computes for the port's forward
kernel.  ``ops.rmsnorm`` pairs the two in a ``torch.autograd.Function``;
the plain twin is ``ref.rmsnorm_bwd``.

Built at first use by ``build.py``.  The wrapper checks device, dtype (x
and dy float32 or bfloat16, scale float32), shapes and contiguity,
allocates dx, dscale and the per-block partial rows of dscale with
``torch.empty``, chooses the plan from (rows, d) alone (``bwd_plan``),
launches on the current stream (the rows, then the fixed-order sum of the
partials), raises on a non-zero ``cudaError_t`` and counts the call in
``LAUNCHES["rmsnorm_bwd"]``.
"""
from __future__ import annotations

import ctypes
from typing import Tuple

import torch

from repro_torch.kernels.build import (DTYPES, CudaLibrary, check,
                                       device_of, launched, stream)

_p, _i, _f = ctypes.c_void_p, ctypes.c_int, ctypes.c_float
LIB = CudaLibrary(
    "rmsnorm_bwd.cu",
    {"rmsnorm_bwd_launch": [_p] * 6 + [_i, _i, _f] + [_i] * 6 + [_p]},
    kernels=("rmsnorm_bwd",))

PARTIALS = 256     # the partial rows of dscale the plan aims for
MAX_NPT = 32       # columns a thread keeps in registers


def _pow2(n: int) -> int:
    return 1 << max(0, n - 1).bit_length()


def bwd_plan(rows: int, d: int) -> Tuple[int, int, int, int]:
    """(threads a row, columns a thread, rows a block, blocks) for ``rows``
    rows of width ``d``: 32 threads a row up to d = 256, then 64, 128 and
    256 (eight or more columns each); about ``PARTIALS`` blocks of
    consecutive rows.  The kernel's orders of summation follow from this
    plan alone."""
    tpr = min(256, max(32, _pow2(-(-d // 8))))
    npt = _pow2(-(-d // tpr))
    if npt > MAX_NPT:
        raise ValueError(f"d = {d} exceeds the kernel's {256 * MAX_NPT}")
    rpb = -(-rows // PARTIALS)
    return tpr, npt, rpb, -(-rows // rpb)


def rmsnorm_bwd(x: torch.Tensor, scale: torch.Tensor, dy: torch.Tensor,
                eps: float = 1e-6) -> Tuple[torch.Tensor, torch.Tensor]:
    """x, dy [..., d] on the card; scale [d] float32 -> (dx in x's dtype,
    dscale [d] float32) for ``y = rmsnorm(x, scale, eps)``."""
    device = device_of(x)
    if x.dim() == 0 or x.shape[-1] == 0:
        raise ValueError(f"x must have a non-empty last axis, got "
                         f"{tuple(x.shape)}")
    if x.dtype not in DTYPES:
        raise TypeError(f"x has dtype {x.dtype}; the kernel takes float32 "
                        f"or bfloat16")
    d = x.shape[-1]
    check("x", x, x.dtype, x.shape, device)
    check("dy", dy, x.dtype, x.shape, device)
    check("scale", scale, torch.float32, (d,), device)
    rows = x.numel() // d
    if rows >= 2 ** 31:
        raise ValueError(f"{rows} rows exceed the kernel's grid")
    dx = torch.empty_like(x)
    if rows == 0:
        return dx, torch.zeros_like(scale)
    tpr, npt, rpb, n_part = bwd_plan(rows, d)
    dscale = torch.empty_like(scale)
    partial = torch.empty((n_part, d), dtype=torch.float32, device=device)
    err = LIB.lib().rmsnorm_bwd_launch(
        x.data_ptr(), scale.data_ptr(), dy.data_ptr(), dx.data_ptr(),
        dscale.data_ptr(), partial.data_ptr(), rows, d, float(eps),
        DTYPES[x.dtype], tpr, npt, rpb, n_part, device.index, stream(device))
    launched(err, "rmsnorm_bwd")
    return dx, dscale
