"""ctypes wrapper of the hand-written CUDA flash-attention kernel
(``csrc/flash_attention.cu``; it replaces the Pallas TPU kernel
``repro/kernels/flash_attention.py::flash_attention``).

Built at first use by ``build.py``.  The wrapper checks device, dtype
(float32 or bfloat16, one for q, k and v), shapes, head_dim (16, 32, 64,
128 or 256) and contiguity, allocates the output with ``torch.empty``, launches
on the current stream, raises on a non-zero ``cudaError_t`` and counts the
launch in ``LAUNCHES["flash_attention"]``.
"""
from __future__ import annotations

import ctypes
import math

import torch

from repro_torch.kernels.build import (CudaLibrary, check, device_of,
                                       launched, stream)

_p, _i, _f = ctypes.c_void_p, ctypes.c_int, ctypes.c_float
LIB = CudaLibrary(
    "flash_attention.cu",
    {"flash_attention_launch": [_p, _p, _p, _p, _i, _i, _i, _i, _i, _i, _i,
                                _i, _f, _i, _i, _p]},
    kernels=("flash_attention",))
DTYPES = {torch.float32: 0, torch.bfloat16: 1}
HEAD_DIMS = (16, 32, 64, 128, 256)


def check_attention_inputs(q: torch.Tensor, k: torch.Tensor,
                           v: torch.Tensor, q_dims: int) -> torch.device:
    """Device, dtype, head_dim, alignment and contiguity shared by the
    attention kernels; q has ``q_dims`` dimensions, k and v four."""
    device = device_of(q)
    if q.dim() != q_dims or k.dim() != 4:
        raise ValueError(f"q must have {q_dims} dims and k, v four, got "
                         f"{tuple(q.shape)} and {tuple(k.shape)}")
    if q.dtype not in DTYPES:
        raise TypeError(f"q has dtype {q.dtype}; the kernel takes float32 "
                        f"or bfloat16")
    hd = q.shape[-1]
    if hd not in HEAD_DIMS:
        raise ValueError(f"head_dim {hd} is not one of {HEAD_DIMS}")
    check("q", q, q.dtype, q.shape, device)
    check("k", k, q.dtype, k.shape, device)
    check("v", v, q.dtype, k.shape, device)
    Hkv = k.shape[2]
    if k.shape[3] != hd or Hkv == 0 or q.shape[-2] % Hkv != 0:
        raise ValueError(f"q {tuple(q.shape)} and k {tuple(k.shape)}: "
                         f"head_dim must agree and Hq be a multiple of Hkv")
    for name, t in (("q", q), ("k", k), ("v", v)):
        if t.data_ptr() % 16:
            raise ValueError(f"{name} must be 16-byte aligned")
    return device


def flash_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, *,
                    causal: bool = True, window: int = 0) -> torch.Tensor:
    """q [B,Sq,Hq,hd]; k/v [B,Sk,Hkv,hd] on the card -> [B,Sq,Hq,hd] in
    q's dtype.  Any Sq and Sk; query head h reads kv head h // (Hq/Hkv)."""
    device = check_attention_inputs(q, k, v, q_dims=4)
    B, Sq, Hq, hd = q.shape
    Sk, Hkv = k.shape[1], k.shape[2]
    if k.shape[0] != B or Sk == 0:
        raise ValueError(f"k {tuple(k.shape)} does not match q "
                         f"{tuple(q.shape)}")
    if window > 0 and Sq - Sk >= window:
        raise ValueError("rows past Sk + window - 1 would see no key")
    out = torch.empty_like(q)
    if out.numel() == 0:
        return out
    err = LIB.lib().flash_attention_launch(
        q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(), B, Sq, Sk,
        Hq, Hkv, hd, int(bool(causal)), int(window), 1.0 / math.sqrt(hd),
        DTYPES[q.dtype], device.index, stream(device))
    launched(err, "flash_attention")
    return out
