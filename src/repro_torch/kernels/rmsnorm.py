"""ctypes wrapper of the hand-written CUDA RMSNorm kernel
(``csrc/rmsnorm.cu``; it replaces the Pallas TPU kernel
``repro/kernels/rmsnorm.py::rmsnorm``).

Built at first use by ``build.py``.  The wrapper checks device, dtype (x
float32 or bfloat16, scale float32), shapes and contiguity, allocates the
output with ``torch.empty``, chooses the launch configuration from d and the
dtype alone (``launch_plan``), launches on the current stream, raises on a
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
    {"rmsnorm_launch": [_p, _p, _p, _i, _i, _f, _i, _i, _i, _i, _p]},
    kernels=("rmsnorm",))

CHUNK_BYTES = 16          # a thread's loads and stores: 8 bf16 or 4 f32
WARP_LAYOUT_MAX_D = 1024  # up to here a (half-)warp a row, shuffles only
MAX_THREADS = 1024
MAX_CHUNKS = 8            # chunks a thread keeps in registers


def _pow2(n: int) -> int:
    return 1 << max(0, n - 1).bit_length()


def launch_plan(d: int, dtype: torch.dtype) -> tuple:
    """(threads a row, 16-byte chunks a thread) for rows of width d.

    The kernel's order of summation follows from this plan alone, so it
    depends on (d, dtype) and never on the row count.  16 or 32 threads:
    the warp layout (several rows a block, shuffles only); 64 to 1024: a
    block a row, two chunks a thread up to 1024 threads, then 4 or 8, then
    0 (the thread re-reads its chunks to write).
    """
    vec = CHUNK_BYTES // torch.empty((), dtype=dtype).element_size()
    chunks = -(-d // vec)
    if d <= WARP_LAYOUT_MAX_D:
        lanes = 16 if chunks <= 16 else 32
        return lanes, _pow2(-(-chunks // lanes))
    threads = min(MAX_THREADS, -(-chunks // 64) * 32)
    nv = _pow2(-(-chunks // threads))
    return threads, nv if nv <= MAX_CHUNKS else 0


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
    threads, nv = launch_plan(d, x.dtype)
    err = LIB.lib().rmsnorm_launch(
        x.data_ptr(), scale.data_ptr(), out.data_ptr(), rows, d, float(eps),
        DTYPES[x.dtype], threads, nv, device.index, stream(device))
    launched(err, "rmsnorm")
    return out
