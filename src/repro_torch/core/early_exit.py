"""Congestion-aware early exit (paper Eqs. 14-16), port of
``repro/core/early_exit.py``.

    ΔT_i = (T_i(t) - T_i(t-1)) / Δt                    (Eq. 14)
    D_i  ← D_i + α (ΔT_i - D_i)                        (Eq. 15, EMA)
    ξ_i  = L_full | L1 | L2  by τ_med / τ_high          (Eq. 16)
"""
from __future__ import annotations

from typing import NamedTuple, Tuple

import torch

from repro_torch.core.fp import div, fma


class CongestionState(NamedTuple):
    prev_T: torch.Tensor    # [.., N] previous outstanding GFLOPs
    D: torch.Tensor         # [.., N] smoothed derivative


def congestion_update(state: CongestionState, T: torch.Tensor, dt: float,
                      alpha: float) -> CongestionState:
    """Eqs. 14-15 (the EMA step is one fused multiply-add, as XLA
    computes it)."""
    dT = div(T - state.prev_T, dt)
    return CongestionState(T, fma(alpha, dT - state.D, state.D))


def congestion_update_eager(state: CongestionState, T: torch.Tensor,
                            dt: float, alpha: float) -> CongestionState:
    """Eqs. 14-15 rounded as the reference computes them op by op, outside
    ``jit`` (its serve engine): one IEEE division by ``dt``, then a
    multiply and an add, each rounded on its own (no fused multiply-add and
    no reciprocal, which only XLA's compiled loops apply)."""
    dT = (T - state.prev_T) / dt
    return CongestionState(T, state.D + alpha * (dT - state.D))


def _select3(label: torch.Tensor, v2, v1, v0, dtype) -> torch.Tensor:
    # filled in ``dtype``: a where between two Python floats would take
    # torch's default dtype first
    out = torch.full_like(label, v0, dtype=dtype)
    out.masked_fill_(label == 1, v1)
    return out.masked_fill_(label == 2, v2)


def exit_label(D: torch.Tensor, tau_med: float, tau_high: float
               ) -> torch.Tensor:
    """Eq. 16 -> {0: L_full, 1: L1 (medium), 2: L2 (high)}, int32."""
    mid = torch.where(D > tau_med, 1, 0)
    return torch.where(D > tau_high, 2, mid).to(torch.int32)


def exit_boundary_layers(label: torch.Tensor,
                         exit_points: Tuple[int, int, int],
                         finalize_layers: int) -> torch.Tensor:
    """Layers executed per label: L_full, L2 + finalize, L1 + finalize
    (each truncated exit capped at L_full)."""
    L1, L2, L_full = exit_points
    med = min(L2 + finalize_layers, L_full)
    high = min(L1 + finalize_layers, L_full)
    return _select3(label, high, med, L_full, torch.int32)


def exit_accuracy(label: torch.Tensor,
                  accuracy_levels: Tuple[float, float, float]
                  ) -> torch.Tensor:
    """Table 2 accuracies [high-congestion, medium, full], float32."""
    acc_high, acc_med, acc_full = accuracy_levels
    return _select3(label, acc_high, acc_med, acc_full, torch.float32)
