"""Aggregated computation capability, the paper's diffusive metric (Eq. 10).

    1/φ_i(t+1) = 1/(|M_i(t)|+1) · ( 1/F_i + max_{k∈M_i(t)} ( d^tx_{i,k}(t) + 1/φ_k(t) ) )

Port of ``repro/core/diffusive.py``.  Every function takes ``[N]`` or
batched ``[R, N]`` operands (``[.., N, N]`` adjacency, ``[.., N, K]``
lists); the ``*_op`` forms are the simulator's hot path and dispatch
through ``kernels.ops`` (a CUDA kernel for CUDA tensors, the plain version
on the CPU).  Isolated nodes (|M_i| = 0) keep φ_i = F_i: the dense and the
sparse update are one fused kernel each, fallback included.
"""
from __future__ import annotations

from typing import Optional, Tuple

import torch

from repro_torch.kernels import ops, ref

NEG = -1e30


def neighbor_mask(snr_db: torch.Tensor, snr_min_db: float) -> torch.Tensor:
    """Eq. 9: M_i(t) = { j != i : SNR_ij >= SNR_min }.  snr_db [.., N, N]."""
    n = snr_db.shape[-1]
    eye = torch.eye(n, dtype=torch.bool, device=snr_db.device)
    return (snr_db >= snr_min_db) & ~eye


# One synchronous iteration of Eq. 10 in plain tensor algebra, dense and
# over fixed-width neighbour lists (adj_e/nbr/d_tx_e [.., N, K]): the twins
# of the fused kernels, kept in kernels/ref.py beside them.
phi_update = ref.phi_update
phi_update_sparse = ref.phi_update_sparse


def _batched(fn, first, *args):
    if first.dim() == 1:
        return fn(first[None], *(a[None] for a in args))[0]
    return fn(first, *args)


def phi_update_op(phi, F, adj, d_tx):
    """Kernel-dispatched ``phi_update``: [N] or [R, N] operands; on the
    card one launch of the fused kernel."""
    return _batched(ops.phi_update, phi.contiguous(), F.contiguous(),
                    adj.contiguous(), d_tx.contiguous())


def gather_rows(v: torch.Tensor, idx: torch.Tensor) -> torch.Tensor:
    """v [.., N] gathered at idx [.., N, K] -> [.., N, K] (per batch row)."""
    flat = idx.reshape(*idx.shape[:-2], -1).long()
    return torch.gather(v, -1, flat).view(idx.shape)


def phi_update_op_sparse(phi, F, adj_e, nbr, d_tx_e):
    """Kernel-dispatched ``phi_update_sparse``: [N]/[N, K] or
    [R, N]/[R, N, K] operands; on the card one launch of the fused
    kernel."""
    return _batched(ops.phi_update_sparse, phi.contiguous(), F.contiguous(),
                    adj_e.contiguous(), nbr.to(torch.int32).contiguous(),
                    d_tx_e.contiguous())


def phi_fixpoint(F, adj, d_tx, iters: int = 16,
                 phi0: Optional[torch.Tensor] = None
                 ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Iterate Eq. 10 ``iters`` times; returns (phi, residuals [iters]) with
    residual_t = max |1/φ_{t+1} - 1/φ_t| (geometric convergence check)."""
    phi = F if phi0 is None else phi0
    res = []
    for _ in range(iters):
        nxt = phi_update(phi, F, adj, d_tx)
        res.append((1.0 / nxt - 1.0 / phi).abs().amax())
        phi = nxt
    return phi, torch.stack(res)


def phi_bounds_ok(phi, F, adj) -> torch.Tensor:
    """Invariant 0 < φ_i <= F_i + Σ_{k∈M_i} F_k (times 1 + 1e-5)."""
    upper = F + (adj.to(F.dtype) @ F[..., None])[..., 0]
    return torch.all((phi > 0) & (phi <= upper * (1 + 1e-5)))
