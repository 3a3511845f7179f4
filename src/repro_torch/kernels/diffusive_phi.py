"""ctypes wrappers of the hand-written CUDA kernels for the diffusive φ
update (``csrc/diffusive_phi.cu``; it replaces the Pallas TPU kernels
``repro/kernels/diffusive_phi.py::diffusive_phi`` and
``::diffusive_phi_sparse``).  ``diffusive_phi`` and
``diffusive_phi_sparse`` keep the Pallas kernels' contract;
``phi_update`` and ``phi_update_sparse`` are the whole updates of
``core.diffusive.phi_update_op`` and ``::phi_update_op_sparse`` in one
launch each, which the simulator calls.  Every launcher equals its plain
version in ``ref.py`` on every input, NaN for NaN.

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
                                       sm_count, stream)

_p, _i = ctypes.c_void_p, ctypes.c_int
LIB = CudaLibrary(
    "diffusive_phi.cu",
    {"diffusive_phi_launch": [_p, _p, _p, _p, _i, _i, _i, _p],
     "diffusive_phi_sparse_launch": [_p, _p, _p, _p, _p, _i, _i, _i, _i,
                                     _p],
     "phi_update_launch": [_p, _p, _p, _p, _p, _i, _i, _i, _i, _p],
     "phi_update_sparse_launch": [_p, _p, _p, _p, _p, _p, _i, _i, _i, _i,
                                  _p]},
    kernels=("diffusive_phi", "diffusive_phi_sparse", "phi_update",
             "phi_update_sparse"))
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


# the widest swarm phi_update takes: its 1/φ row fills a block's 227 KB of
# shared memory (one run's delays are then 13.5 GB; wider swarms take the
# sparse path)
MAX_UPDATE_N = 232448 // 4


def update_chunk(R: int, N: int, sms: int) -> int:
    """Rows a block of ``phi_update``: a multiple of its 8 warps, from one
    to eight rows a warp, so that the grid is about eight blocks an SM
    deep.  Each block divides its run's 1/φ row once, so larger chunks
    spread that over more rows.  No chunk changes a result."""
    per_block = -(-R * N // (8 * sms))
    return min(64, max(8, -(-per_block // 8) * 8))


def phi_update(phi: torch.Tensor, F: torch.Tensor, adj: torch.Tensor,
               d_tx: torch.Tensor) -> torch.Tensor:
    """The dense φ update, on the card, in one launch.  phi, F [R, N]
    float32; adj [R, N, N] bool; d_tx [R, N, N] float32 -> φ' [R, N]:
    1 / ((1/F_i + max_{k: adj_ik} (d_tx_ik + 1/φ_k)) / (deg_i + 1)), or F_i
    where node i has no neighbour."""
    device = device_of(phi)
    if phi.dim() != 2:
        raise ValueError("phi must be [R, N]")
    R, N = phi.shape
    if R * N >= 2 ** 31:
        raise ValueError(f"R·N = {R * N} rows do not fit one launch")
    if N > MAX_UPDATE_N:
        raise ValueError(f"N = {N} exceeds the {MAX_UPDATE_N} nodes whose "
                         f"1/φ row fits shared memory; take the sparse path")
    f32 = torch.float32
    check("phi", phi, f32, (R, N), device)
    check("F", F, f32, (R, N), device)
    check("adj", adj, torch.bool, (R, N, N), device)
    check("d_tx", d_tx, f32, (R, N, N), device)
    out = torch.empty((R, N), dtype=f32, device=device)
    if R * N == 0:
        return out
    err = LIB.lib().phi_update_launch(
        phi.data_ptr(), F.data_ptr(), adj.data_ptr(), d_tx.data_ptr(),
        out.data_ptr(), R, N, update_chunk(R, N, sm_count(device.index)),
        device.index, stream(device))
    launched(err, "phi_update")
    return out


def phi_update_sparse(phi: torch.Tensor, F: torch.Tensor, adj_e: torch.Tensor,
                      nbr: torch.Tensor, d_tx_e: torch.Tensor) -> torch.Tensor:
    """The neighbour-list φ update, on the card, in one launch.  phi, F
    [R, N] float32; adj_e [R, N, K] bool; nbr [R, N, K] int32; d_tx_e
    [R, N, K] float32 -> φ' [R, N]: 1 / ((1/F_i + max_{k: adj_e_ik}
    (d_tx_e_ik + 1/φ[nbr_ik])) / (deg_i + 1)), or F_i where the row has no
    link.  A row with an on-link index outside [0, N) comes out NaN."""
    device = device_of(phi)
    if adj_e.dim() != 3:
        raise ValueError("adj_e must be [R, N, K]")
    R, N, K = adj_e.shape
    if R * N >= 2 ** 31:
        raise ValueError(f"R·N = {R * N} rows do not fit one launch")
    f32 = torch.float32
    check("phi", phi, f32, (R, N), device)
    check("F", F, f32, (R, N), device)
    check("adj_e", adj_e, torch.bool, (R, N, K), device)
    check("nbr", nbr, torch.int32, (R, N, K), device)
    check("d_tx_e", d_tx_e, f32, (R, N, K), device)
    out = torch.empty((R, N), dtype=f32, device=device)
    if R * N == 0:
        return out
    err = LIB.lib().phi_update_sparse_launch(
        phi.data_ptr(), F.data_ptr(), adj_e.data_ptr(), nbr.data_ptr(),
        d_tx_e.data_ptr(), out.data_ptr(), R, N, K, device.index,
        stream(device))
    launched(err, "phi_update_sparse")
    return out
