"""Algorithm 1, the per-epoch decision logic, as one function: port of
``repro/core/protocol.py`` on [.., N] tensors.

``decision_epoch`` reads only one-hop-visible state (adjacency, neighbour
φ/U); the vectorised form computes every node's decision at once.
"""
from __future__ import annotations

from typing import NamedTuple, Tuple

import torch

from repro_torch.core.decision import TransferDecision, transfer_decision
from repro_torch.core.diffusive import phi_update
from repro_torch.core.early_exit import (CongestionState, congestion_update,
                                         exit_boundary_layers, exit_label,
                                         init_congestion)


class ProtocolState(NamedTuple):
    phi: torch.Tensor               # [.., N] aggregated capability
    congestion: CongestionState     # (prev_T, D) per node


class EpochDecision(NamedTuple):
    decision: TransferDecision      # utilization / target / transfer
    exit_layers: torch.Tensor       # [.., N] layers to execute (Eq. 16)
    exit_lbl: torch.Tensor          # [.., N] 0=full 1=medium 2=high
    state: ProtocolState


def init_protocol(F: torch.Tensor) -> ProtocolState:
    return ProtocolState(phi=F, congestion=init_congestion(
        F.shape[-1], F.shape[:-1], F.device, F.dtype))


def decision_epoch(state: ProtocolState, *, F, adj, d_tx, queued_gflops,
                   gamma: float, dt: float, alpha: float,
                   tau_med: float, tau_high: float,
                   exit_points: Tuple[int, int, int],
                   finalize_layers: int,
                   early_exit_enabled: bool = True) -> EpochDecision:
    """One decision epoch at every node (Alg. 1 lines 2-11)."""
    phi = phi_update(state.phi, F, adj, d_tx)                  # line 2
    dec = transfer_decision(queued_gflops, phi, adj, gamma)    # lines 3-5
    cong = congestion_update(state.congestion, queued_gflops, dt, alpha)
    if early_exit_enabled:                                     # lines 10-11
        lbl = exit_label(cong.D, tau_med, tau_high)
    else:
        lbl = torch.zeros_like(cong.D, dtype=torch.int32)
    layers = exit_boundary_layers(lbl, exit_points, finalize_layers)
    return EpochDecision(dec, layers, lbl, ProtocolState(phi, cong))
