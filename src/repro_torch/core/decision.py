"""Task-transfer decision (paper Eqs. 11-13), port of
``repro/core/decision.py`` on [.., N] operands.

    U_i(t)   = T_i(t) / φ_i(t)                         (utilization, Eq. 11)
    k*       = argmin_{k ∈ M_i(t)} U_k(t)              (Eq. 12)
    transfer ⇔ U_i - U_{k*} > γ                        (Eq. 13)

Ties go to the lowest node id (``torch.argmin`` returns the first minimum),
as in the reference; targets are int32, -1 where a node has no neighbour.
"""
from __future__ import annotations

from typing import NamedTuple

import torch

from repro_torch.core.diffusive import gather_rows

BIG = 1e30


class TransferDecision(NamedTuple):
    utilization: torch.Tensor   # [.., N]  U_i
    target: torch.Tensor        # [.., N]  int32 k* (-1 if no neighbour)
    transfer: torch.Tensor      # [.., N]  bool, Eq. 13 predicate


def utilization(queued_gflops: torch.Tensor, phi: torch.Tensor
                ) -> torch.Tensor:
    """Eq. 11.  queued_gflops T_i >= 0, phi > 0."""
    return queued_gflops / torch.clamp_min(phi, 1e-9)


def _decide(U, cand, k_star, has_nbr, gamma):
    U_star = cand.amin(dim=-1)
    do = has_nbr & ((U - U_star) > gamma)
    return TransferDecision(U, torch.where(has_nbr, k_star, -1).to(
        torch.int32), do)


def transfer_decision(queued_gflops, phi, adj, gamma: float
                      ) -> TransferDecision:
    """Eqs. 11-13 for every node: queued_gflops/phi [.., N], adj [.., N, N]."""
    U = utilization(queued_gflops, phi)
    cand = torch.where(adj, U[..., None, :], BIG)
    k_star = cand.argmin(dim=-1).to(torch.int32)
    return _decide(U, cand, k_star, adj.any(dim=-1), gamma)


def transfer_decision_sparse(queued_gflops, phi, adj_e, nbr, gamma: float
                             ) -> TransferDecision:
    """Eqs. 11-13 over id-sorted neighbour lists adj_e/nbr [.., N, K]; the
    lowest-id tie-break of the dense path carries over."""
    U = utilization(queued_gflops, phi)
    cand = torch.where(adj_e, gather_rows(U, nbr), BIG)
    slot = cand.argmin(dim=-1, keepdim=True)
    k_star = torch.gather(nbr, -1, slot)[..., 0].to(torch.int32)
    return _decide(U, cand, k_star, adj_e.any(dim=-1), gamma)
