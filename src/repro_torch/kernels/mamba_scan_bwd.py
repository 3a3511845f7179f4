"""ctypes wrapper of the hand-written CUDA Mamba selective-scan backward
(``csrc/mamba_scan_bwd.cu``).  The TPU kernel
``repro/kernels/mamba_scan.py::mamba_scan`` has no backward: JAX
differentiates the plain scan, whose gradient this kernel computes for the
port's forward kernel.  ``ops.mamba_scan_with_state`` pairs the two in a
``torch.autograd.Function``; the plain twin is ``ref.mamba_scan_bwd``.

The kernel walks the sequence in chunks of ``ref.CHECKPOINT_EVERY`` steps
from the last to the first, each started from a state checkpoint: on the
training path the forward's (``mamba_scan.mamba_scan_with_checkpoints``),
otherwise a first launch computes them from a and b.  a and b come in
through a TMA-fed ring in shared memory; h of a chunk stays in registers.

Built at first use by ``build.py``.  The wrapper checks device, dtype
(float32), shapes, the state size, alignment and contiguity as the
forward's does, allocates da, db, dC, the checkpoints where none are given
and the 32-channel groups' partials of dC (``[B, ⌈D/32⌉, S, N]``) with
``torch.empty``, launches the kernels and the fixed-order sum of the
partials on the current stream, raises on a non-zero ``cudaError_t`` and
counts the call in ``LAUNCHES["mamba_scan_bwd"]``.
"""
from __future__ import annotations

import ctypes
from typing import Optional, Tuple

import torch

from repro_torch.kernels.build import (CudaLibrary, check, device_of,
                                       launched, stream)
from repro_torch.kernels.mamba_scan import STATE_SIZES
from repro_torch.kernels.ref import CHECKPOINT_EVERY, DC_GROUP

_p, _i = ctypes.c_void_p, ctypes.c_int
LIB = CudaLibrary(
    "mamba_scan_bwd.cu",
    {"mamba_scan_bwd_launch": [_p] * 6 + [_i] + [_p] * 4 + [_i] * 6 + [_p]},
    kernels=("mamba_scan_bwd",))


def mamba_scan_bwd(a: torch.Tensor, b: torch.Tensor, C: torch.Tensor,
                   dy: torch.Tensor, dh_last: Optional[torch.Tensor] = None,
                   h_chk: Optional[torch.Tensor] = None
                   ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """a, b [B, S, D, N], C [B, S, N], dy [B, S, D], optionally dh_last
    [B, D, N] and the forward's checkpoints h_chk [B, ⌈S/T⌉ - 1, D, N],
    float32 on the card -> (da, db, dC), the gradient of
    ``mamba_scan_with_state``."""
    device = device_of(a)
    if a.dim() != 4:
        raise ValueError(f"a must be [B, S, D, N], got {tuple(a.shape)}")
    B, S, D, N = a.shape
    if N not in STATE_SIZES:
        raise ValueError(f"state size N = {N} is not one of {STATE_SIZES}")
    check("a", a, torch.float32, a.shape, device)
    check("b", b, torch.float32, a.shape, device)
    check("C", C, torch.float32, (B, S, N), device)
    check("dy", dy, torch.float32, (B, S, D), device)
    aligned = [("a", a), ("b", b), ("C", C)]
    if dh_last is not None:
        check("dh_last", dh_last, torch.float32, (B, D, N), device)
        aligned.append(("dh_last", dh_last))
    T = CHECKPOINT_EVERY
    chk_shape = (B, max(S - 1, 0) // T, D, N)
    if h_chk is not None:
        check("h_chk", h_chk, torch.float32, chk_shape, device)
    if B > 65535:
        raise ValueError(f"B = {B} exceeds the kernel's grid")
    for name, t in aligned:
        if t.data_ptr() % 16:
            raise ValueError(f"{name} must be 16-byte aligned")
    da, db = torch.empty_like(a), torch.empty_like(a)
    dC = torch.empty((B, S, N), dtype=torch.float32, device=device)
    if a.numel() == 0:
        return da, db, dC.zero_()
    make_chk = h_chk is None
    if make_chk:
        h_chk = torch.empty(chk_shape, dtype=torch.float32, device=device)
    part = torch.empty((B, -(-D // DC_GROUP), S, N), dtype=torch.float32,
                       device=device)
    err = LIB.lib().mamba_scan_bwd_launch(
        a.data_ptr(), b.data_ptr(), C.data_ptr(), dy.data_ptr(),
        None if dh_last is None else dh_last.data_ptr(),
        h_chk.data_ptr() if h_chk.numel() else None, int(make_chk),
        da.data_ptr(), db.data_ptr(), part.data_ptr(), dC.data_ptr(),
        B, S, D, N, T, device.index, stream(device))
    launched(err, "mamba_scan_bwd")
    return da, db, dC
