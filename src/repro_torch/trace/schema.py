"""TaskRecord, HopRecord and state-stream layouts, port of
``repro/trace/schema.py`` (DESIGN.md §10.1, §10.5, §12).

One task (or one delivered hop) is one fixed-width float32 row; integral
fields are exact up to 2**24.  The simulator's buffers carry a leading run
axis, ``[R, capacity, F]``, and an unwritten slot has ``seq = -1``.  The
host-side ``*_np`` rows are float64: the serve engine builds them on the
host, where nothing is rounded through float32.
"""
from __future__ import annotations

import numpy as np
import torch

FIELDS = ("seq", "src", "dst", "created_t", "completed_t", "exit_label",
          "layers", "hops", "energy_j", "tx_time_s")
(SEQ, SRC, DST, CREATED_T, COMPLETED_T, EXIT_LABEL, LAYERS, HOPS, ENERGY_J,
 TX_TIME_S) = range(len(FIELDS))
NUM_FIELDS = len(FIELDS)

# exit_label values beyond the paper's 0/1/2 congestion ladder
DROPPED = 3

INT_FIELDS = ("seq", "src", "dst", "exit_label", "layers", "hops")


def _pack(cols) -> torch.Tensor:
    dev = next(c.device for c in cols if torch.is_tensor(c))
    cols = [c.float() if torch.is_tensor(c) else
            torch.full((), c, dtype=torch.float32, device=dev) for c in cols]
    return torch.stack(torch.broadcast_tensors(*cols), dim=-1)


def pack(seq, src, dst, created_t, completed_t, exit_label, layers, hops,
         energy_j, tx_time_s) -> torch.Tensor:
    """Stack per-task fields (tensors or numbers, broadcast; at least one
    a tensor) into ``[..., NUM_FIELDS]`` float32 rows."""
    return _pack((seq, src, dst, created_t, completed_t, exit_label, layers,
                  hops, energy_j, tx_time_s))


def pack_np(seq, src, dst, created_t, completed_t, exit_label, layers, hops,
            energy_j=0.0, tx_time_s=0.0) -> np.ndarray:
    """Host-side single-record row (float64: the caller's clock domain is
    not rounded through float32)."""
    return np.asarray([seq, src, dst, created_t, completed_t, exit_label,
                       layers, hops, energy_j, tx_time_s], np.float64)


def empty_buffer(capacity: int, runs: int = 1, device=None) -> torch.Tensor:
    """Unwritten ``[runs, capacity, NUM_FIELDS]`` buffer (seq = -1)."""
    return torch.full((runs, capacity, NUM_FIELDS), -1.0,
                      dtype=torch.float32, device=device)


HOP_FIELDS = ("seq", "src", "dst", "t_depart", "t_arrive", "bits",
              "boundary_layer", "stall_ticks")
(HOP_SEQ, HOP_SRC, HOP_DST, HOP_T_DEPART, HOP_T_ARRIVE, HOP_BITS,
 HOP_BOUNDARY_LAYER, HOP_STALL_TICKS) = range(len(HOP_FIELDS))
NUM_HOP_FIELDS = len(HOP_FIELDS)

HOP_INT_FIELDS = ("seq", "src", "dst", "boundary_layer", "stall_ticks")


def pack_hop(seq, src, dst, t_depart, t_arrive, bits, boundary_layer,
             stall_ticks) -> torch.Tensor:
    """Stack per-hop field tensors into ``[..., NUM_HOP_FIELDS]`` float32
    rows."""
    return _pack((seq, src, dst, t_depart, t_arrive, bits, boundary_layer,
                  stall_ticks))


def empty_hop_buffer(capacity: int, runs: int = 1,
                     device=None) -> torch.Tensor:
    """Unwritten ``[runs, capacity, NUM_HOP_FIELDS]`` buffer (seq = -1)."""
    return torch.full((runs, capacity, NUM_HOP_FIELDS), -1.0,
                      dtype=torch.float32, device=device)

STATE_GAUGES = ("phi", "queue_depth", "e_comp_j", "e_tx_j", "alive",
                "tx_bits")
(ST_PHI, ST_QUEUE_DEPTH, ST_E_COMP_J, ST_E_TX_J, ST_ALIVE,
 ST_TX_BITS) = range(len(STATE_GAUGES))
NUM_STATE_GAUGES = len(STATE_GAUGES)

SYS_GAUGES = ("t", "tasks_in_flight", "transfers_active", "completed",
              "dropped", "generated", "queue_depth_mean", "queue_depth_max",
              "queue_jain", "phi_mean", "phi_min", "phi_max", "energy_j")
(SYS_T, SYS_TASKS_IN_FLIGHT, SYS_TRANSFERS_ACTIVE, SYS_COMPLETED,
 SYS_DROPPED, SYS_GENERATED, SYS_QUEUE_DEPTH_MEAN, SYS_QUEUE_DEPTH_MAX,
 SYS_QUEUE_JAIN, SYS_PHI_MEAN, SYS_PHI_MIN, SYS_PHI_MAX,
 SYS_ENERGY_J) = range(len(SYS_GAUGES))
NUM_SYS_GAUGES = len(SYS_GAUGES)


def pack_state_sys_np(t, tasks_in_flight, transfers_active, completed,
                      dropped, generated, queue_depth_mean, queue_depth_max,
                      queue_jain, phi_mean=0.0, phi_min=0.0, phi_max=0.0,
                      energy_j=0.0) -> np.ndarray:
    """Host-side single system-gauge row (float64 like ``pack_np``)."""
    return np.asarray([t, tasks_in_flight, transfers_active, completed,
                       dropped, generated, queue_depth_mean, queue_depth_max,
                       queue_jain, phi_mean, phi_min, phi_max, energy_j],
                      np.float64)


from repro_torch.trace.critical import SEGMENTS  # noqa: E402,F401  (moved)
