"""ctypes wrapper of the hand-written CUDA decode-attention kernel
(``csrc/decode_attention.cu``; it replaces the Pallas TPU kernel
``repro/kernels/decode_attention.py::decode_attention``).

Built at first use by ``build.py``.  ``pos`` is a host int: the kernel
reads only the kept cache slots, whose range the host computes.  A 0-d
tensor is read with ``.item()``, which synchronises with the card.  The
wrapper checks its inputs as the flash wrapper does, allocates the output
with ``torch.empty``, launches on the current stream, raises on a non-zero
``cudaError_t`` and counts the launch in
``LAUNCHES["decode_attention"]``.
"""
from __future__ import annotations

import ctypes
import math
from typing import Union

import torch

from repro_torch.kernels.build import CudaLibrary, launched, stream
from repro_torch.kernels.flash_attention import DTYPES, check_attention_inputs

_p, _i, _f = ctypes.c_void_p, ctypes.c_int, ctypes.c_float
LIB = CudaLibrary(
    "decode_attention.cu",
    {"decode_attention_launch": [_p, _p, _p, _p, _i, _i, _i, _i, _i, _i, _i,
                                 _f, _i, _i, _p]},
    kernels=("decode_attention",))


def decode_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                     pos: Union[int, torch.Tensor], *,
                     window: int = 0) -> torch.Tensor:
    """q [B,Hq,hd]; k/v [B,S,Hkv,hd] on the card; attend to cache slots
    kpos <= pos (and pos - kpos < window where a window is set) ->
    [B,Hq,hd] in q's dtype."""
    device = check_attention_inputs(q, k, v, q_dims=3)
    B, Hq, hd = q.shape
    S, Hkv = k.shape[1], k.shape[2]
    if k.shape[0] != B or S == 0:
        raise ValueError(f"k {tuple(k.shape)} does not match q "
                         f"{tuple(q.shape)}")
    pos = int(pos.item()) if torch.is_tensor(pos) else int(pos)
    if pos < 0:
        raise ValueError(f"pos must be >= 0, got {pos}")
    hi = min(pos, S - 1)
    lo = max(0, pos - window + 1) if window > 0 else 0
    out = torch.empty_like(q)
    if out.numel() == 0:
        return out
    err = LIB.lib().decode_attention_launch(
        q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(), B, S, Hkv,
        Hq // Hkv, hd, lo, hi, 1.0 / math.sqrt(hd), DTYPES[q.dtype],
        device.index, stream(device))
    launched(err, "decode_attention")
    return out
