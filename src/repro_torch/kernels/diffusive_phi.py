"""ctypes wrappers of the hand-written CUDA kernels for the diffusive φ
update (``csrc/diffusive_phi.cu``; it replaces the Pallas TPU kernels
``repro/kernels/diffusive_phi.py::diffusive_phi`` and
``::diffusive_phi_sparse``).

Built at first use by ``build.py`` (no ``--use_fast_math``: IEEE division
keeps ``1/F`` and the final ``/ (deg + 1)`` bit-identical to PyTorch's).
Each wrapper checks device, dtype, shape and contiguity, allocates its
output with ``torch.empty``, launches on the current stream, raises on a
non-zero ``cudaError_t``, and adds one to its entry of ``LAUNCHES``.
"""
from __future__ import annotations

import ctypes

import torch

from repro_torch.kernels.build import (BUILD_DIR, LAUNCHES,  # noqa: F401
                                       NVCC_FLAGS, CudaLibrary, check,
                                       device_of, launched, reset_launches,
                                       stream)

_p, _i = ctypes.c_void_p, ctypes.c_int
LIB = CudaLibrary(
    "diffusive_phi.cu",
    {"diffusive_phi_launch": [_p, _p, _p, _p, _i, _i, _i, _p],
     "diffusive_phi_sparse_launch": [_p, _p, _p, _p, _p, _i, _i, _i, _i,
                                     _p]},
    kernels=("diffusive_phi", "diffusive_phi_sparse"))
SOURCE = LIB.source
library_path = LIB.path
build = LIB.build


def diffusive_phi(inv_phi: torch.Tensor, F: torch.Tensor,
                  d_tx_masked: torch.Tensor) -> torch.Tensor:
    """Eq. 10, dense, on the card.  inv_phi [R, N], F [R, N], d_tx_masked
    [R, N, N] float32 (NEG = -1e30 off-link) -> inv_phi' [R, N]."""
    device = device_of(inv_phi)
    if inv_phi.dim() != 2:
        raise ValueError("inv_phi must be [R, N]")
    R, N = inv_phi.shape
    if R * N >= 2 ** 31:
        raise ValueError(f"R·N = {R * N} rows do not fit one launch")
    f32 = torch.float32
    check("inv_phi", inv_phi, f32, (R, N), device)
    check("F", F, f32, (R, N), device)
    check("d_tx_masked", d_tx_masked, f32, (R, N, N), device)
    out = torch.empty((R, N), dtype=f32, device=device)
    if R * N == 0:
        return out
    err = LIB.lib().diffusive_phi_launch(
        inv_phi.data_ptr(), F.data_ptr(), d_tx_masked.data_ptr(),
        out.data_ptr(), R, N, device.index, stream(device))
    launched(err, "diffusive_phi")
    return out


def diffusive_phi_sparse(inv_phi: torch.Tensor, F: torch.Tensor,
                         d_tx_masked: torch.Tensor,
                         nbr: torch.Tensor) -> torch.Tensor:
    """Eq. 10 over neighbour lists, on the card.  inv_phi [R, N], F [R, N],
    d_tx_masked [R, N, K] float32 (NEG on invalid/off-link slots), nbr
    [R, N, K] int32 in [0, N) -> inv_phi' [R, N].  A row with an index
    outside [0, N) comes out NaN."""
    device = device_of(inv_phi)
    if d_tx_masked.dim() != 3:
        raise ValueError("d_tx_masked must be [R, N, K]")
    R, N, K = d_tx_masked.shape
    if R * N >= 2 ** 31:
        raise ValueError(f"R·N = {R * N} rows do not fit one launch")
    f32 = torch.float32
    check("inv_phi", inv_phi, f32, (R, N), device)
    check("F", F, f32, (R, N), device)
    check("d_tx_masked", d_tx_masked, f32, (R, N, K), device)
    check("nbr", nbr, torch.int32, (R, N, K), device)
    out = torch.empty((R, N), dtype=f32, device=device)
    if R * N == 0:
        return out
    err = LIB.lib().diffusive_phi_sparse_launch(
        inv_phi.data_ptr(), F.data_ptr(), d_tx_masked.data_ptr(),
        nbr.data_ptr(), out.data_ptr(), R, N, K, device.index,
        stream(device))
    launched(err, "diffusive_phi_sparse")
    return out
