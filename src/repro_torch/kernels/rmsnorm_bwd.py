"""ctypes wrapper of the hand-written CUDA RMSNorm backward
(``csrc/rmsnorm_bwd.cu``).  The TPU kernel
``repro/kernels/rmsnorm.py::rmsnorm`` has no backward: JAX differentiates
the plain path, whose gradient this kernel computes for the port's forward
kernel.  ``ops.rmsnorm`` pairs the two in a ``torch.autograd.Function``;
the plain twin is ``ref.rmsnorm_bwd``.

Built at first use by ``build.py``.  The wrapper checks device, dtype (x
and dy float32 or bfloat16, scale float32), shapes and contiguity,
allocates dx, dscale and the per-block and per-group partial rows of
dscale with ``torch.empty``, keeps one zero-initialised int32 ticket
buffer per stream (each launch leaves it zero), chooses the plan from
(rows, d, dtype) alone (``bwd_plan``), launches one kernel on the current
stream (the rows, then the fixed-order sums of the partials by the blocks
that draw the last tickets), raises on a non-zero ``cudaError_t`` and
counts the launch in ``LAUNCHES["rmsnorm_bwd"]``.
"""
from __future__ import annotations

import ctypes
import math
from typing import Dict, Tuple

import torch

from repro_torch.kernels.build import (DTYPES, CudaLibrary, check,
                                       device_of, launched, stream)

_p, _i, _f = ctypes.c_void_p, ctypes.c_int, ctypes.c_float
LIB = CudaLibrary(
    "rmsnorm_bwd.cu",
    {"rmsnorm_bwd_launch": [_p] * 8 + [_i, _i, _f] + [_i] * 7 + [_p]},
    kernels=("rmsnorm_bwd",))

CHUNK_BYTES = 16   # a thread's loads and stores: 8 bf16 or 4 f32
CHUNKS = 2         # 16-byte chunks a thread keeps in registers (4 past
#                    MAX_TPR · 2 chunks)
BLOCK = 512        # a block's threads
MAX_TPR = 512      # threads a row
PARTIALS = 132     # blocks the plan aims for: one on each of 132 SMs
_COUNTERS: Dict[Tuple[int, int], torch.Tensor] = {}


def _pow2(n: int) -> int:
    return 1 << max(0, n - 1).bit_length()


def bwd_plan(rows: int, d: int, dtype: torch.dtype = torch.bfloat16
             ) -> Tuple[int, int, int, int, int]:
    """(threads a row, chunks a thread, rows a block, blocks, blocks a
    group) for ``rows`` rows of width ``d``.

    A row's 16-byte chunks go ``CHUNKS`` to a thread (one for a one-chunk
    row, four past ``MAX_TPR · CHUNKS``), so a row takes a power of two of
    threads, from 1 to ``MAX_TPR``; a block of ``BLOCK`` threads walks
    its rows ``BLOCK // tpr`` at a time, and about ``PARTIALS`` blocks
    cover the rows.  The blocks' partial rows of dscale are summed in
    groups of about √blocks, then the groups' sums.  Every order of
    summation in the kernel follows from this plan alone."""
    vec = CHUNK_BYTES // torch.empty((), dtype=dtype).element_size()
    chunks = -(-d // vec)
    tpr = min(MAX_TPR, _pow2(-(-chunks // CHUNKS)))
    nv = _pow2(-(-chunks // tpr))
    if nv > 2 * CHUNKS:
        raise ValueError(f"d = {d} exceeds the kernel's "
                         f"{MAX_TPR * 2 * CHUNKS * vec}")
    rg = max(1, BLOCK // tpr)
    rpb = -(-(-(-rows // PARTIALS)) // rg) * rg
    n_part = -(-rows // rpb)
    return tpr, nv, rpb, n_part, math.isqrt(n_part - 1) + 1


def _tickets(device: torch.device, n: int) -> torch.Tensor:
    """At least ``n`` int32 zeros for the current stream of ``device``
    (each launch leaves its tickets zero)."""
    key = (device.index, torch.cuda.current_stream(device).cuda_stream)
    buf = _COUNTERS.get(key)
    if buf is None or buf.numel() < n:
        buf = _COUNTERS[key] = torch.zeros(n, dtype=torch.int32,
                                           device=device)
    return buf


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
    tpr, nv, rpb, n_part, group = bwd_plan(rows, d, x.dtype)
    n_groups = -(-n_part // group)
    dscale = torch.empty_like(scale)
    partial = torch.empty((n_part + n_groups, d), dtype=torch.float32,
                          device=device)
    err = LIB.lib().rmsnorm_bwd_launch(
        x.data_ptr(), scale.data_ptr(), dy.data_ptr(), dx.data_ptr(),
        dscale.data_ptr(), partial.data_ptr(), partial[n_part].data_ptr(),
        _tickets(device, n_groups + 1).data_ptr(), rows, d, float(eps),
        DTYPES[x.dtype], tpr, nv, rpb, n_part, group, device.index,
        stream(device))
    launched(err, "rmsnorm_bwd")
    return dx, dscale
