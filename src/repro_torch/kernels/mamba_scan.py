"""ctypes wrapper of the hand-written CUDA Mamba selective-scan kernel
(``csrc/mamba_scan.cu``; it replaces the Pallas TPU kernel
``repro/kernels/mamba_scan.py::mamba_scan``).

Built at first use by ``build.py``.  The wrapper checks device, dtype
(float32), shapes, the state size (N of 4, 8, 12 or 16: the kernel loads N
floats as N/4 float4s and keeps the state in registers), alignment and
contiguity, allocates ``y`` and ``h_last`` with ``torch.empty``, launches
on the current stream, raises on a non-zero ``cudaError_t`` and counts the
launch in ``LAUNCHES["mamba_scan"]``.

Two entry points of the one kernel: ``mamba_scan_with_state`` (the Pallas
contract and the last state; serving and prefill) and
``mamba_scan_with_checkpoints`` (training: also the state at the end of
every ``ref.CHECKPOINT_EVERY`` steps, which the backward kernel starts its
chunks from).  Both count as ``mamba_scan`` launches.
"""
from __future__ import annotations

import ctypes
from typing import Tuple

import torch

from repro_torch.kernels.build import (CudaLibrary, check, device_of,
                                       launched, stream)
from repro_torch.kernels.ref import CHECKPOINT_EVERY

_p, _i = ctypes.c_void_p, ctypes.c_int
LIB = CudaLibrary(
    "mamba_scan.cu",
    {"mamba_scan_launch": [_p, _p, _p, _p, _p, _i, _i, _i, _i, _i, _p],
     "mamba_scan_chk_launch": [_p] * 6 + [_i] * 6 + [_p]},
    kernels=("mamba_scan",))
STATE_SIZES = (4, 8, 12, 16)


def _checked(a: torch.Tensor, b: torch.Tensor, C: torch.Tensor):
    """The forward's guards; returns (device, (B, S, D, N))."""
    device = device_of(a)
    if a.dim() != 4:
        raise ValueError(f"a must be [B, S, D, N], got {tuple(a.shape)}")
    B, S, D, N = a.shape
    if N not in STATE_SIZES:
        raise ValueError(f"state size N = {N} is not one of {STATE_SIZES}")
    check("a", a, torch.float32, a.shape, device)
    check("b", b, torch.float32, a.shape, device)
    check("C", C, torch.float32, (B, S, N), device)
    if B > 65535:
        raise ValueError(f"B = {B} exceeds the kernel's grid")
    for name, t in (("a", a), ("b", b), ("C", C)):
        if t.data_ptr() % 16:
            raise ValueError(f"{name} must be 16-byte aligned")
    return device, (B, S, D, N)


def mamba_scan_with_state(a: torch.Tensor, b: torch.Tensor,
                          C: torch.Tensor
                          ) -> Tuple[torch.Tensor, torch.Tensor]:
    """a, b [B, S, D, N], C [B, S, N] float32 on the card -> (y [B, S, D],
    h_last [B, D, N]): h_t = a_t ⊙ h_{t-1} + b_t from zero, y_t = h_t·C_t."""
    device, (B, S, D, N) = _checked(a, b, C)
    y = torch.empty((B, S, D), dtype=torch.float32, device=device)
    h_last = torch.empty((B, D, N), dtype=torch.float32, device=device)
    if a.numel() == 0:
        return y, h_last.zero_()
    err = LIB.lib().mamba_scan_launch(
        a.data_ptr(), b.data_ptr(), C.data_ptr(), y.data_ptr(),
        h_last.data_ptr(), B, S, D, N, device.index, stream(device))
    launched(err, "mamba_scan")
    return y, h_last


def mamba_scan_with_checkpoints(a: torch.Tensor, b: torch.Tensor,
                                C: torch.Tensor
                                ) -> Tuple[torch.Tensor, torch.Tensor,
                                           torch.Tensor]:
    """``mamba_scan_with_state`` (the same bits) and h_chk [B, ⌈S/T⌉ - 1,
    D, N], the state h_{cT-1} for c = 1 .. ⌈S/T⌉ - 1, T =
    ``CHECKPOINT_EVERY``."""
    device, (B, S, D, N) = _checked(a, b, C)
    T = CHECKPOINT_EVERY
    y = torch.empty((B, S, D), dtype=torch.float32, device=device)
    h_last = torch.empty((B, D, N), dtype=torch.float32, device=device)
    h_chk = torch.empty((B, max(S - 1, 0) // T, D, N), dtype=torch.float32,
                        device=device)
    if a.numel() == 0:
        return y, h_last.zero_(), h_chk
    err = LIB.lib().mamba_scan_chk_launch(
        a.data_ptr(), b.data_ptr(), C.data_ptr(), y.data_ptr(),
        h_last.data_ptr(), h_chk.data_ptr() if h_chk.numel() else None,
        B, S, D, N, T, device.index, stream(device))
    launched(err, "mamba_scan")
    return y, h_last, h_chk
