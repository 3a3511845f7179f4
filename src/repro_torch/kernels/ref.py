"""Plain PyTorch versions of the port's kernels: the oracles the CUDA
kernels are held against, and the CPU path.

Arithmetic is op for op that of ``repro/kernels/ref.py``: the candidate
``d_tx + 1/φ_k``, a max over the row, the degree counted as an f32 sum of
``d_tx > NEG/2``, then ``(1/F + max) / (deg + 1)``, or ``1/F`` where the
degree is 0.  A max, an exact count and one IEEE division leave no room for
rounding differences, so the kernels must equal these bit for bit.
"""
from __future__ import annotations

import torch

NEG = -1e30


def _combine(inv_phi: torch.Tensor, F: torch.Tensor, cand: torch.Tensor,
             d_tx_masked: torch.Tensor) -> torch.Tensor:
    worst = cand.amax(dim=-1)
    deg = (d_tx_masked > NEG / 2).to(inv_phi.dtype).sum(dim=-1)
    inv_new = (1.0 / F + worst) / (deg + 1.0)
    return torch.where(deg > 0, inv_new, 1.0 / F)


def diffusive_phi(inv_phi: torch.Tensor, F: torch.Tensor,
                  d_tx_masked: torch.Tensor) -> torch.Tensor:
    """Eq. 10, dense.  inv_phi [.., N] (s/GFLOP), F [.., N], d_tx_masked
    [.., N, N] with NEG off-link.  Returns inv_phi' [.., N]."""
    cand = d_tx_masked + inv_phi[..., None, :]
    return _combine(inv_phi, F, cand, d_tx_masked)


def diffusive_phi_sparse(inv_phi: torch.Tensor, F: torch.Tensor,
                         d_tx_masked: torch.Tensor,
                         nbr: torch.Tensor) -> torch.Tensor:
    """Eq. 10 over neighbour lists.  inv_phi [R, N], F [R, N], d_tx_masked
    [R, N, K] (NEG on invalid/off-link slots), nbr [R, N, K] int32 (0 on
    invalid slots).  Returns inv_phi' [R, N]."""
    R, N, K = d_tx_masked.shape
    p = torch.gather(inv_phi, 1, nbr.reshape(R, N * K).long()).view(R, N, K)
    return _combine(inv_phi, F, d_tx_masked + p, d_tx_masked)
