"""ctypes wrapper of the hand-written CUDA backward passes of the MoE
block's two row gathers (``csrc/moe_gather_bwd.cu``).  No TPU kernel
computes them: JAX differentiates the reference's gathers
(``repro/models/moe.py::_moe_shard``) as scatter-adds.  ``ops.MoEDispatch``
and ``ops.MoECombine`` pair each with its forward gather; the plain twins
are ``ref.moe_dispatch_bwd`` and ``ref.moe_combine_bwd``.

Built at first use by ``build.py``.  Each wrapper checks device, dtype (the
rows float32 or bfloat16, the maps int64), shapes and contiguity, allocates
its output with ``torch.empty``, chooses the chunking from d, the dtype and
the operands' alignment alone (``plan``), launches one kernel on the
current stream, raises on a non-zero ``cudaError_t`` and counts the launch
in ``LAUNCHES["moe_dispatch_bwd"]`` or ``LAUNCHES["moe_combine_bwd"]``.
"""
from __future__ import annotations

import ctypes
from typing import Tuple

import torch

from repro_torch.kernels.build import (DTYPES, CudaLibrary, check,
                                       device_of, launched, stream)

_p, _i, _l = ctypes.c_void_p, ctypes.c_int, ctypes.c_int64
LIB = CudaLibrary(
    "moe_gather_bwd.cu",
    {"moe_dispatch_bwd_launch": [_p] * 3 + [_l, _i, _l] + [_i] * 5 + [_p],
     "moe_combine_bwd_launch": [_p] * 3 + [_l] + [_i] * 5 + [_p]},
    kernels=("moe_dispatch_bwd", "moe_combine_bwd"))

CHUNK_BYTES = 16   # a thread's loads and stores: 8 bf16 or 4 f32
MAX_TPR = 32       # threads a row


def plan(d: int, dtype: torch.dtype, *tensors: torch.Tensor
         ) -> Tuple[int, int, int]:
    """(elements a chunk, chunks a row, threads a row) for rows of ``d``
    elements: 16-byte chunks where ``d`` fills them and every tensor is
    16-byte aligned, else one element a chunk; a power of two of threads a
    row, at most ``MAX_TPR``."""
    elt = dtype.itemsize
    vec = CHUNK_BYTES // elt
    if (d * elt) % CHUNK_BYTES or any(t.data_ptr() % CHUNK_BYTES
                                      for t in tensors):
        vec = 1
    chunks = d // vec
    return vec, chunks, min(MAX_TPR, 1 << max(0, chunks - 1).bit_length())


def _rows(name: str, t: torch.Tensor) -> None:
    if t.dim() != 2:
        raise ValueError(f"{name} must be [rows, d], got {tuple(t.shape)}")
    if t.dtype not in DTYPES:
        raise TypeError(f"{name} has dtype {t.dtype}; the kernel takes "
                        f"float32 or bfloat16")


def moe_dispatch_bwd(dbuf: torch.Tensor, tok_slot: torch.Tensor
                     ) -> torch.Tensor:
    """dbuf [n_slots, d] on the card, tok_slot [T, k] int64 (each token's
    slots in ascending order, ``n_slots`` where it holds none) -> dx [T,
    d] in dbuf's dtype: each token's rows of dbuf summed in that order,
    each partial sum rounded to the dtype."""
    device = device_of(dbuf)
    _rows("dbuf", dbuf)
    if tok_slot.dim() != 2:
        raise ValueError(f"tok_slot must be [T, k], got "
                         f"{tuple(tok_slot.shape)}")
    (n_slots, d), (T, k) = dbuf.shape, tok_slot.shape
    check("dbuf", dbuf, dbuf.dtype, (n_slots, d), device)
    check("tok_slot", tok_slot, torch.int64, (T, k), device)
    dx = torch.empty((T, d), dtype=dbuf.dtype, device=device)
    if dx.numel() == 0:
        return dx
    vec, chunks, tpr = plan(d, dbuf.dtype, dbuf, dx)
    err = LIB.lib().moe_dispatch_bwd_launch(
        dbuf.data_ptr(), tok_slot.data_ptr(), dx.data_ptr(), T, k, n_slots,
        DTYPES[dbuf.dtype], vec, chunks, tpr, device.index, stream(device))
    launched(err, "moe_dispatch_bwd")
    return dx


def moe_combine_bwd(drows: torch.Tensor, src: torch.Tensor) -> torch.Tensor:
    """drows [A, d] on the card, src [n_slots] int64 (the row of drows
    each slot takes, -1 for none) -> dy [n_slots, d] in drows' dtype."""
    device = device_of(drows)
    _rows("drows", drows)
    if src.dim() != 1:
        raise ValueError(f"src must be [n_slots], got {tuple(src.shape)}")
    d, n_slots = drows.shape[1], src.shape[0]
    check("drows", drows, drows.dtype, drows.shape, device)
    check("src", src, torch.int64, (n_slots,), device)
    dy = torch.empty((n_slots, d), dtype=drows.dtype, device=device)
    if dy.numel() == 0:
        return dy
    vec, chunks, tpr = plan(d, drows.dtype, drows, dy)
    err = LIB.lib().moe_combine_bwd_launch(
        drows.data_ptr(), src.data_ptr(), dy.data_ptr(), n_slots,
        DTYPES[drows.dtype], vec, chunks, tpr, device.index, stream(device))
    launched(err, "moe_combine_bwd")
    return dy
