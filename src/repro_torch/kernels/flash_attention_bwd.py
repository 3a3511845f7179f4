"""ctypes wrapper of the hand-written CUDA flash-attention backward
(``csrc/flash_attention_bwd.cu``).  The TPU kernel
``repro/kernels/flash_attention.py::flash_attention`` has no backward: JAX
differentiates the plain path, whose gradient this kernel computes for the
port's forward kernel.  ``ops.flash_attention`` pairs the two in a
``torch.autograd.Function``; the plain twin is
``ref.flash_attention_bwd``.

Built at first use by ``build.py``.  The wrapper checks q, k and v as the
forward's wrapper does and o and dO against q, allocates dQ, dK, dV and the
rows' float32 log-sum-exp and rowsum(dO∘O) scratch with ``torch.empty``,
launches on the current stream (two kernels: dQ with the row statistics,
then dK and dV), raises on a non-zero ``cudaError_t`` and counts the call
in ``LAUNCHES["flash_attention_bwd"]``.
"""
from __future__ import annotations

import ctypes
import math
from typing import Tuple

import torch

from repro_torch.kernels.build import (DTYPES, CudaLibrary, check, launched,
                                       stream)
from repro_torch.kernels.flash_attention import check_attention_inputs

_p, _i, _f = ctypes.c_void_p, ctypes.c_int, ctypes.c_float
LIB = CudaLibrary(
    "flash_attention_bwd.cu",
    {"flash_attention_bwd_launch": [_p] * 10 + [_i] * 8 + [_f, _i, _i, _p]},
    kernels=("flash_attention_bwd",))


def flash_attention_bwd(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                        o: torch.Tensor, do: torch.Tensor, *,
                        causal: bool = True, window: int = 0
                        ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """q, o, dO [B,Sq,Hq,hd]; k, v [B,Sk,Hkv,hd] on the card, one dtype ->
    (dQ, dK, dV) in that dtype, for ``o = flash_attention(q, k, v,
    causal=causal, window=window)``."""
    device = check_attention_inputs(q, k, v, q_dims=4)
    check("o", o, q.dtype, q.shape, device)
    check("do", do, q.dtype, q.shape, device)
    for name, t in (("o", o), ("do", do)):
        if t.data_ptr() % 16:
            raise ValueError(f"{name} must be 16-byte aligned")
    B, Sq, Hq, hd = q.shape
    Sk, Hkv = k.shape[1], k.shape[2]
    if k.shape[0] != B or Sk == 0:
        raise ValueError(f"k {tuple(k.shape)} does not match q "
                         f"{tuple(q.shape)}")
    if B > 65535 or Hq > 65535:
        raise ValueError(f"B = {B}, Hq = {Hq} exceed the kernel's grid")
    dq, dk, dv = (torch.empty_like(t) for t in (q, k, v))
    if q.numel() == 0:
        return dq, dk.zero_(), dv.zero_()
    lse = torch.empty((B, Hq, Sq), dtype=torch.float32, device=device)
    dvec = torch.empty_like(lse)
    err = LIB.lib().flash_attention_bwd_launch(
        q.data_ptr(), k.data_ptr(), v.data_ptr(), o.data_ptr(),
        do.data_ptr(), dq.data_ptr(), dk.data_ptr(), dv.data_ptr(),
        lse.data_ptr(), dvec.data_ptr(), B, Sq, Sk, Hq, Hkv, hd,
        int(bool(causal)), int(window), 1.0 / math.sqrt(hd),
        DTYPES[q.dtype], device.index, stream(device))
    launched(err, "flash_attention_bwd")
    return dq, dk, dv
