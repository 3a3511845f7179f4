"""TaskRecord, HopRecord and state-stream layouts: the numpy half of
``repro/trace/schema.py`` (DESIGN.md §10.1), a copy, since that module
imports jax, plus ``SEGMENTS`` of ``repro/trace/critical.py``.

One served sample = one float64 row on the TaskRecord fields; the flight
recorder adds one system-gauge row and one per-stage gauge row per sampled
epoch.  The serve engine builds these rows on the host.
"""
from __future__ import annotations

import numpy as np

FIELDS = ("seq", "src", "dst", "created_t", "completed_t", "exit_label",
          "layers", "hops", "energy_j", "tx_time_s")
(SEQ, SRC, DST, CREATED_T, COMPLETED_T, EXIT_LABEL, LAYERS, HOPS, ENERGY_J,
 TX_TIME_S) = range(len(FIELDS))
NUM_FIELDS = len(FIELDS)

# exit_label values beyond the paper's 0/1/2 congestion ladder
DROPPED = 3

INT_FIELDS = ("seq", "src", "dst", "exit_label", "layers", "hops")


def pack_np(seq, src, dst, created_t, completed_t, exit_label, layers, hops,
            energy_j=0.0, tx_time_s=0.0) -> np.ndarray:
    """Host-side single-record row (float64: the caller's clock domain is
    not rounded through float32)."""
    return np.asarray([seq, src, dst, created_t, completed_t, exit_label,
                       layers, hops, energy_j, tx_time_s], np.float64)


HOP_FIELDS = ("seq", "src", "dst", "t_depart", "t_arrive", "bits",
              "boundary_layer", "stall_ticks")
(HOP_SEQ, HOP_SRC, HOP_DST, HOP_T_DEPART, HOP_T_ARRIVE, HOP_BITS,
 HOP_BOUNDARY_LAYER, HOP_STALL_TICKS) = range(len(HOP_FIELDS))
NUM_HOP_FIELDS = len(HOP_FIELDS)


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


# the four latency segments, in report order; per task they sum exactly
# to the latency
SEGMENTS = ("compute_s", "queue_wait_s", "airtime_s", "stall_s")
