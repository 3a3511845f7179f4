"""Swarm configuration (paper Table 2): the port's own copy of
``repro.configs.base.SwarmConfig``.

Same field names, defaults and meaning as the JAX package's dataclass, so a
config built for one package can be rebuilt field by field for the other
(``SwarmConfig(**dataclasses.asdict(cfg))``).  ``ModelConfig`` comes with the
model-zoo slice of the port.
"""
from __future__ import annotations

from dataclasses import dataclass
from typing import Tuple


@dataclass(frozen=True)
class SwarmConfig:
    num_workers: int = 30
    area_m: float = 20_000.0                 # 20×20 km
    placement_granularity: int = 15
    movement_radius_m: float = 1_000.0
    speed_mps: float = 75.0
    capability_mean: float = 400.0           # GFLOP/s, N(400,100)
    capability_std: float = 100.0
    energy_per_gflop_j: float = 0.02
    task_period_s: float = 0.060             # Markov mean inter-arrival
    # Markov-modulated (bursty) arrivals: per-node ON/OFF chain; long-run
    # mean inter-arrival stays task_period_s, bursts arrive at rate
    # 1/(period*duty) while ON.
    burst_on_s: float = 2.0                  # mean burst duration
    burst_off_s: float = 6.0                 # mean quiet duration
    exit_points: Tuple[int, int, int] = (15, 30, 60)       # L1, L2, L_full
    exit_finalize_layers: int = 3
    exit_thresholds: Tuple[float, float] = (1.5, 2.5)      # τ_med, τ_high
    exit_accuracy: Tuple[float, float, float] = (0.6, 0.9, 0.95)
    tx_power_dbm: float = 30.0
    noise_dbm: float = -85.0
    snr_min_db: float = 3.0
    bandwidth_hz: float = 10e6
    sim_time_s: float = 100.0
    gamma: float = 0.02                      # distributed offload threshold
    decision_period_s: float = 0.200
    random_offload_p: float = 0.2
    random_acyclic_p: float = 0.1
    greedy_offload_p: float = 0.05
    ema_alpha: float = 0.3                   # smoothing α (Eq. 15)
    # --- simulator discretization ---
    tick_s: float = 0.010
    queue_slots: int = 128
    altitude_m: float = 100.0                # two-ray antenna heights
    num_runs: int = 50
    early_exit_enabled: bool = False
    # --- scenario engine: string-keyed model selection ---
    # mobility: circular|random_waypoint|gauss_markov|levy_flight
    mobility_model: str = "circular"
    # channel: two_ray|free_space|log_normal|log_normal_corr|rician|nakagami
    channel_model: str = "two_ray"
    fault_model: str = "none"                # none|markov
    # random-waypoint / Gauss-Markov / Lévy mobility parameters
    speed_min_mps: float = 25.0
    speed_max_mps: float = 100.0
    gm_alpha: float = 0.85                   # Gauss-Markov velocity memory
    gm_sigma_mps: float = 20.0               # Gauss-Markov velocity noise
    levy_alpha: float = 1.6                  # Pareto tail of Lévy hop length
    # free-space / log-normal / fading channel parameters
    carrier_hz: float = 2.4e9
    pathloss_exp: float = 2.0
    shadowing_sigma_db: float = 6.0          # log-normal shadowing std
    rician_k_db: float = 6.0                 # Rician K-factor (LoS/NLoS dB)
    nakagami_m: float = 2.0                  # Nakagami shape (1 = Rayleigh)
    shadow_corr_m: float = 500.0             # Gudmundson decorrelation
    # node fault/churn (markov): mean dwell times of the up/down chain
    fault_mean_up_s: float = 30.0
    fault_mean_down_s: float = 5.0
    # --- neighbor representation ---
    # "dense": [N, N] adjacency/capacity; "sparse": fixed-width [N, K]
    # neighbor lists from the spatial-hash search in swarm/neighbors.py,
    # exact vs dense whenever neighbor_k covers the true max degree.
    neighbor_mode: str = "dense"             # dense|sparse
    neighbor_k: int = 16                     # neighbor-list width K
    # bucket-grid knobs (0 = derived from N, K and the channel range)
    neighbor_range_m: float = 0.0
    neighbor_cell_cap: int = 0
    # task profile (illustrative detection CNN)
    task_layers: int = 60
    task_gflops_total: float = 12.0
    # --- telemetry streams of the JAX package; the port takes 0 only ---
    trace_capacity: int = 0
    trace_hop_capacity: int = 0
    trace_state_every: int = 0
    trace_state_nodes: int = 0
