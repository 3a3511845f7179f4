"""Core protocol of the paper (Eqs. 9-16) on batched ``[R, ...]`` tensors:
the diffusive aggregated-computation-capability metric (Eq. 10), the
utilization-threshold task transfer (Eqs. 11-13) and the congestion-aware
early exit (Eqs. 14-16), composed in ``decision_epoch`` (Alg. 1).  The
public API is the reference's (``repro.core``), name for name."""
from repro_torch.core.decision import (TransferDecision, transfer_decision,
                                       utilization)
from repro_torch.core.diffusive import (neighbor_mask, phi_bounds_ok,
                                        phi_fixpoint, phi_update)
from repro_torch.core.early_exit import (CongestionState, congestion_update,
                                         exit_accuracy, exit_boundary_layers,
                                         exit_label, init_congestion)
from repro_torch.core.protocol import (EpochDecision, ProtocolState,
                                       decision_epoch, init_protocol)

__all__ = [
    "phi_update", "phi_fixpoint", "phi_bounds_ok", "neighbor_mask",
    "utilization", "transfer_decision", "TransferDecision",
    "CongestionState", "init_congestion", "congestion_update", "exit_label",
    "exit_boundary_layers", "exit_accuracy",
    "ProtocolState", "EpochDecision", "init_protocol", "decision_epoch",
]
