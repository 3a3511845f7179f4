"""Configurations: the port's own copies of ``repro.configs``.

* ``SwarmConfig`` (paper Table 2), a copy of
  ``repro.configs.base.SwarmConfig``;
* ``ModelConfig`` and ``reduced``, copies of ``repro.configs.base``'s, and
  the architectures the port runs (``ARCHS``, ``get_config``).

Same field names, defaults and meaning as the JAX package's dataclasses, so
a config built for one package can be rebuilt field by field for the other
(``SwarmConfig(**dataclasses.asdict(cfg))``).  The sub-configs of the other
model families (``MoEConfig``, ``SSMConfig``, ``HybridConfig``,
``EncDecConfig``) come with those families; until then their fields stay
``None``.
"""
from __future__ import annotations

import dataclasses
from dataclasses import dataclass
from typing import Optional, Tuple


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


# ---------------------------------------------------------------------------
# Model configuration
# ---------------------------------------------------------------------------


@dataclass(frozen=True)
class ModelConfig:
    name: str
    family: str                       # dense | moe | hybrid | ssm | encdec | vlm
    num_layers: int
    d_model: int
    num_heads: int
    num_kv_heads: int
    d_ff: int
    vocab_size: int
    head_dim: int = 0                 # 0 => d_model // num_heads
    qk_norm: bool = False             # qwen3 per-head RMS norm on q/k
    qkv_bias: bool = False            # qwen2 QKV bias
    attn_out_bias: bool = False
    rope_theta: float = 1_000_000.0
    mrope_sections: Tuple[int, ...] = ()   # qwen2-vl M-RoPE (sums to head_dim//2)
    norm: str = "rmsnorm"             # rmsnorm | layernorm
    act: str = "swiglu"               # swiglu | geglu | gelu
    tie_embeddings: bool = False
    learned_pos: bool = False         # whisper: learned absolute positions
    frontend: str = "none"            # none | patch_stub | audio_stub
    # sub-configs of the families the port does not run yet
    moe: Optional[object] = None
    ssm: Optional[object] = None
    hybrid: Optional[object] = None
    encdec: Optional[object] = None
    # Early-exit head layers (paper §4.3): indices of layer boundaries at which
    # a truncated inference may produce logits. 0 entries => [L//4, L//2].
    exit_layers: Tuple[int, ...] = ()
    # numerics
    param_dtype: str = "float32"
    compute_dtype: str = "bfloat16"
    # training-side knobs of the JAX package (kept for field parity)
    remat_policy: str = "nothing"     # nothing | dots | none
    attn_chunk: int = 1024            # q-chunk size for the chunked ref attention
    scan_layers: bool = True
    cast_weights_bf16: bool = False
    loss_chunk: int = 0
    serve_param_fsdp: bool = True
    pure_dp: bool = False

    # ---- derived ---------------------------------------------------------
    @property
    def head_dim_(self) -> int:
        if self.num_heads == 0:
            return 0
        return self.head_dim or (self.d_model // self.num_heads)

    @property
    def q_groups(self) -> int:
        return self.num_heads // max(self.num_kv_heads, 1)

    @property
    def exit_layers_(self) -> Tuple[int, ...]:
        if self.exit_layers:
            return self.exit_layers
        L = self.num_layers
        return (max(L // 4, 1), max(L // 2, 2))

    def param_count(self) -> int:
        """Analytic parameter count (embeddings included once if tied);
        the dense and vlm families, the ones whose layers the port has."""
        if self.family not in ("dense", "vlm"):
            raise NotImplementedError(
                f"param_count of the {self.family!r} family is not ported "
                f"(ROADMAP.md)")
        d, hd = self.d_model, self.head_dim_
        Hq, Hkv = self.num_heads, self.num_kv_heads
        attn = d * (Hq * hd) + 2 * d * (Hkv * hd) + (Hq * hd) * d
        if self.qkv_bias:
            attn += (Hq + 2 * Hkv) * hd
        mlp = (3 if self.act in ("swiglu", "geglu") else 2) * d * self.d_ff
        total = self.num_layers * (attn + mlp + 2 * d)
        emb = self.vocab_size * d
        total += emb if self.tie_embeddings else 2 * emb
        return int(total)


def reduced(cfg: ModelConfig) -> ModelConfig:
    """Tiny same-family variant for CPU tests (same code paths), as
    ``repro.configs.base.reduced`` makes it for the dense family."""
    if cfg.family != "dense":
        raise NotImplementedError(
            f"reduced() of the {cfg.family!r} family is not ported "
            f"(ROADMAP.md)")
    return dataclasses.replace(
        cfg, name=cfg.name + "-smoke", num_layers=2, d_model=64, num_heads=4,
        num_kv_heads=min(cfg.num_kv_heads, 2) or 1, d_ff=128, head_dim=16,
        vocab_size=256, attn_chunk=32, scan_layers=cfg.scan_layers)


# qwen3-1.7b — 28L d_model=2048 16H (GQA kv=8) d_ff=6144, qk_norm
# [hf:Qwen/Qwen3-8B family]; repro/configs/qwen3_1_7b.py
QWEN3_1_7B = ModelConfig(
    name="qwen3-1.7b",
    family="dense",
    num_layers=28,
    d_model=2048,
    num_heads=16,
    num_kv_heads=8,
    d_ff=6144,
    vocab_size=151_936,
    head_dim=128,
    qk_norm=True,
    rope_theta=1_000_000.0,
    tie_embeddings=True,
)

ARCHS = {c.name: c for c in (QWEN3_1_7B,)}

# architectures of the JAX package that the port does not run yet
NOT_PORTED = ("falcon-mamba-7b", "granite-moe-1b-a400m", "qwen2-7b",
              "qwen2-vl-2b", "qwen2.5-14b", "qwen3-4b", "qwen3-moe-30b-a3b",
              "recurrentgemma-9b", "whisper-medium")


def get_config(arch_id: str) -> ModelConfig:
    if arch_id in ARCHS:
        return ARCHS[arch_id]
    if arch_id in NOT_PORTED:
        raise NotImplementedError(
            f"architecture {arch_id!r} is not ported yet; ROADMAP.md lists "
            f"the slices to come (ported: {sorted(ARCHS)})")
    raise KeyError(f"unknown arch {arch_id!r}; known: "
                   f"{sorted(ARCHS) + list(NOT_PORTED)}")
