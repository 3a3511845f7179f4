"""Configurations: the port's own copies of ``repro.configs``.

* ``SwarmConfig`` (paper Table 2), a copy of
  ``repro.configs.base.SwarmConfig``;
* ``ModelConfig``, ``MoEConfig``, ``SSMConfig``, ``HybridConfig``,
  ``EncDecConfig`` and ``reduced``, copies of ``repro.configs.base``'s,
  and the architectures (``ARCHS``, ``get_config``): the dense
  qwen3-1.7b, qwen3-4b, qwen2-7b and qwen2.5-14b, the moe
  granite-moe-1b-a400m and qwen3-moe-30b-a3b, the vlm qwen2-vl-2b,
  falcon-mamba-7b (ssm), recurrentgemma-9b (hybrid) and whisper-medium
  (encdec): every architecture of the JAX package;
* ``ShapeConfig``, the four cells ``TRAIN_4K``, ``PREFILL_32K``,
  ``DECODE_32K``, ``LONG_500K`` (``ALL_SHAPES``, by name ``SHAPES`` and
  ``get_shape``) and ``shape_applicable``,
  copies of ``repro.configs.base``'s, which ``input_partition_specs``
  takes.

Same field names, defaults and meaning as the JAX package's dataclasses, so
a config built for one package can be rebuilt field by field for the other
(``SwarmConfig(**dataclasses.asdict(cfg))``).
"""
from __future__ import annotations

import dataclasses
import math
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
class MoEConfig:
    num_experts: int = 0
    experts_per_token: int = 0
    d_ff_expert: int = 0
    capacity_factor: float = 1.25
    router_norm_topk: bool = True     # qwen3-style renormalized top-k gate
    router_aux_loss: float = 0.0      # load-balance aux loss coefficient


@dataclass(frozen=True)
class SSMConfig:
    d_state: int = 16
    d_conv: int = 4
    expand: int = 2
    dt_rank: int = 0                  # 0 => ceil(d_model / 16)
    chunk: int = 64                   # selective-scan chunk length (plain path)
    chunk_remat: bool = False         # a training lever of the JAX package


@dataclass(frozen=True)
class HybridConfig:
    # RecurrentGemma/Griffin-style block pattern, repeated over depth.
    pattern: Tuple[str, ...] = ("rec", "rec", "attn")
    lru_width: int = 0                # 0 => d_model
    conv_width: int = 4
    window: int = 2048                # local-attention window
    # RG-LRU constant `c` (power applied to the recurrence gate).
    c: float = 8.0


@dataclass(frozen=True)
class EncDecConfig:
    encoder_layers: int = 0
    source_positions: int = 1500      # whisper-medium 30 s of audio frames
    max_target_positions: int = 32_768  # learned-pos table size (covers cells)
    # the conv frontend is a stub: the encoder takes precomputed frame
    # embeddings [B, source_positions, d_model].


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
    moe: Optional[MoEConfig] = None
    ssm: Optional[SSMConfig] = None
    hybrid: Optional[HybridConfig] = None
    encdec: Optional[EncDecConfig] = None
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
    def is_subquadratic(self) -> bool:
        """True if long-context decode (500k) is tractable: SSM state or
        bounded local-attention window instead of a full-length KV cache."""
        return self.family in ("ssm", "hybrid")

    @property
    def exit_layers_(self) -> Tuple[int, ...]:
        if self.exit_layers:
            return self.exit_layers
        L = self.num_layers
        return (max(L // 4, 1), max(L // 2, 2))

    def param_count(self) -> int:
        """Analytic parameter count (embeddings included once if tied), as
        the JAX package counts it (encdec: its learned position tables
        left out, as there)."""
        d, hd = self.d_model, self.head_dim_
        Hq, Hkv = self.num_heads, self.num_kv_heads
        attn = d * (Hq * hd) + 2 * d * (Hkv * hd) + (Hq * hd) * d
        if self.qkv_bias:
            attn += (Hq + 2 * Hkv) * hd
        mlp = (3 if self.act in ("swiglu", "geglu") else 2) * d * self.d_ff
        if self.family == "moe":
            m = self.moe
            moe_mlp = (m.num_experts * 3 * d * m.d_ff_expert
                       + d * m.num_experts)
            total = self.num_layers * (attn + moe_mlp + 2 * d)
        elif self.family == "ssm":
            s = self.ssm
            d_in = s.expand * d
            dt_rank = s.dt_rank or math.ceil(d / 16)
            blk = (d * 2 * d_in + d_in * s.d_conv
                   + d_in * (dt_rank + 2 * s.d_state) + dt_rank * d_in
                   + d_in * s.d_state + d_in  # A_log, D
                   + d_in * d + d)
            total = self.num_layers * blk
        elif self.family == "hybrid":
            h = self.hybrid
            w = h.lru_width or d
            rec = (2 * d * w + w * h.conv_width + 3 * w  # Λ, gates' diag params
                   + 2 * w * (w // 8)                     # block-diag input gates (a/x)
                   + w * d + 2 * d)
            att = attn + mlp + 2 * d
            n_att = sum(1 for i in range(self.num_layers)
                        if h.pattern[i % len(h.pattern)] == "attn")
            total = n_att * att + (self.num_layers - n_att) * rec
        elif self.family == "encdec":
            e = self.encdec
            enc = e.encoder_layers * (attn + mlp + 2 * d)
            dec = self.num_layers * (2 * attn + mlp + 3 * d)
            total = enc + dec
        else:  # dense / vlm
            total = self.num_layers * (attn + mlp + 2 * d)
        emb = self.vocab_size * d
        total += emb if self.tie_embeddings else 2 * emb
        return int(total)

    def active_param_count(self) -> int:
        """Active params per token (MoE: top-k experts only)."""
        if self.family != "moe":
            return self.param_count()
        m = self.moe
        d = self.d_model
        dense_moe = self.num_layers * m.num_experts * 3 * d * m.d_ff_expert
        active_moe = (self.num_layers * m.experts_per_token * 3 * d
                      * m.d_ff_expert)
        return int(self.param_count() - dense_moe + active_moe)


# ---------------------------------------------------------------------------
# Input shapes (the dry-run's cells), copies of repro.configs.base's
# ---------------------------------------------------------------------------


@dataclass(frozen=True)
class ShapeConfig:
    name: str
    kind: str           # train | prefill | decode
    seq_len: int
    global_batch: int


TRAIN_4K = ShapeConfig("train_4k", "train", 4_096, 256)
PREFILL_32K = ShapeConfig("prefill_32k", "prefill", 32_768, 32)
DECODE_32K = ShapeConfig("decode_32k", "decode", 32_768, 128)
LONG_500K = ShapeConfig("long_500k", "decode", 524_288, 1)

ALL_SHAPES = (TRAIN_4K, PREFILL_32K, DECODE_32K, LONG_500K)


def shape_applicable(cfg: ModelConfig, shape: ShapeConfig
                     ) -> Tuple[bool, str]:
    """Assignment skip rules. Returns (runnable, reason-if-skipped)."""
    if shape.name == "long_500k" and not cfg.is_subquadratic:
        return False, ("long_500k requires sub-quadratic attention; "
                       f"{cfg.name} is pure full-attention (skip per brief)")
    return True, ""


def reduced(cfg: ModelConfig) -> ModelConfig:
    """Tiny same-family variant for CPU tests (same code paths), as
    ``repro.configs.base.reduced`` makes it."""
    kw = dict(
        name=cfg.name + "-smoke",
        num_layers=len(cfg.hybrid.pattern) + 2 if cfg.family == "hybrid"
        else 2,
        d_model=64, num_heads=4, num_kv_heads=min(cfg.num_kv_heads, 2) or 1,
        d_ff=128, head_dim=16, vocab_size=256, attn_chunk=32,
        scan_layers=cfg.scan_layers)
    if cfg.mrope_sections:
        kw["mrope_sections"] = (2, 3, 3)   # sums to head_dim//2 = 8
    if cfg.moe:
        # capacity_factor = E guarantees zero drops (worst case: every
        # assignment routes to one expert), making smoke tests exact.
        kw["moe"] = dataclasses.replace(
            cfg.moe, num_experts=4, experts_per_token=2, d_ff_expert=32,
            capacity_factor=4.0)
    if cfg.ssm:
        kw["ssm"] = dataclasses.replace(cfg.ssm, d_state=4, chunk=8)
    if cfg.hybrid:
        kw["hybrid"] = dataclasses.replace(cfg.hybrid, lru_width=64,
                                           window=16)
    if cfg.encdec:
        kw["encdec"] = dataclasses.replace(
            cfg.encdec, encoder_layers=2, source_positions=24)
    return dataclasses.replace(cfg, **kw)


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

# falcon-mamba-7b — 64L d_model=4096 attention-free mamba1, ssm_state=16
# [arXiv:2410.05355]; repro/configs/falcon_mamba_7b.py
FALCON_MAMBA_7B = ModelConfig(
    name="falcon-mamba-7b",
    family="ssm",
    num_layers=64,
    d_model=4096,
    num_heads=0,
    num_kv_heads=0,
    d_ff=0,
    vocab_size=65_024,
    ssm=SSMConfig(d_state=16, d_conv=4, expand=2, chunk=64),
)

# recurrentgemma-9b — 38L d_model=4096 16H (MQA kv=1) d_ff=12288, RG-LRU +
# local attention 1:2 [arXiv:2402.19427]; repro/configs/recurrentgemma_9b.py
RECURRENTGEMMA_9B = ModelConfig(
    name="recurrentgemma-9b",
    family="hybrid",
    num_layers=38,
    d_model=4096,
    num_heads=16,
    num_kv_heads=1,
    d_ff=12_288,
    vocab_size=256_000,
    head_dim=256,
    act="geglu",
    rope_theta=10_000.0,
    tie_embeddings=True,
    hybrid=HybridConfig(pattern=("rec", "rec", "attn"), lru_width=4096,
                        conv_width=4, window=2048, c=8.0),
)

# qwen3-4b — 36L d_model=2560 32H (GQA kv=8) d_ff=9728, qk_norm
# [hf:Qwen/Qwen3-8B family]; repro/configs/qwen3_4b.py
QWEN3_4B = ModelConfig(
    name="qwen3-4b",
    family="dense",
    num_layers=36,
    d_model=2560,
    num_heads=32,
    num_kv_heads=8,
    d_ff=9728,
    vocab_size=151_936,
    head_dim=128,
    qk_norm=True,
    rope_theta=1_000_000.0,
    tie_embeddings=True,
)

# qwen2-7b — 28L d_model=3584 28H (GQA kv=4) d_ff=18944, QKV bias
# [arXiv:2407.10671]; repro/configs/qwen2_7b.py
QWEN2_7B = ModelConfig(
    name="qwen2-7b",
    family="dense",
    num_layers=28,
    d_model=3584,
    num_heads=28,
    num_kv_heads=4,
    d_ff=18_944,
    vocab_size=152_064,
    head_dim=128,
    qkv_bias=True,
    rope_theta=1_000_000.0,
)

# qwen2.5-14b — 48L d_model=5120 40H (GQA kv=8) d_ff=13824, QKV bias
# [hf:Qwen/Qwen2.5 family]; repro/configs/qwen2_5_14b.py
QWEN2_5_14B = ModelConfig(
    name="qwen2.5-14b",
    family="dense",
    num_layers=48,
    d_model=5120,
    num_heads=40,
    num_kv_heads=8,
    d_ff=13_824,
    vocab_size=152_064,
    head_dim=128,
    qkv_bias=True,
    rope_theta=1_000_000.0,
)

# granite-moe-1b-a400m — 24L d_model=1024 16H (GQA kv=8) MoE 32e top-8
# [hf:ibm-granite/granite-3.0-1b-a400m-base];
# repro/configs/granite_moe_1b_a400m.py
GRANITE_MOE_1B_A400M = ModelConfig(
    name="granite-moe-1b-a400m",
    family="moe",
    num_layers=24,
    d_model=1024,
    num_heads=16,
    num_kv_heads=8,
    d_ff=512,                       # MoE expert intermediate size
    vocab_size=49_155,
    head_dim=64,
    rope_theta=10_000.0,
    tie_embeddings=True,
    moe=MoEConfig(num_experts=32, experts_per_token=8, d_ff_expert=512,
                  router_norm_topk=False),
)

# qwen3-moe-30b-a3b — 48L d_model=2048 32H (GQA kv=4) MoE 128e top-8
# [hf:Qwen/Qwen3-30B-A3B]; repro/configs/qwen3_moe_30b_a3b.py
QWEN3_MOE_30B_A3B = ModelConfig(
    name="qwen3-moe-30b-a3b",
    family="moe",
    num_layers=48,
    d_model=2048,
    num_heads=32,
    num_kv_heads=4,
    d_ff=768,                       # MoE expert intermediate size
    vocab_size=151_936,
    head_dim=128,
    qk_norm=True,
    rope_theta=1_000_000.0,
    moe=MoEConfig(num_experts=128, experts_per_token=8, d_ff_expert=768,
                  router_norm_topk=True),
)

# qwen2-vl-2b — 28L d_model=1536 12H (GQA kv=2) d_ff=8960, M-RoPE, dynamic
# resolution (vision frontend stubbed) [arXiv:2409.12191];
# repro/configs/qwen2_vl_2b.py
QWEN2_VL_2B = ModelConfig(
    name="qwen2-vl-2b",
    family="vlm",
    num_layers=28,
    d_model=1536,
    num_heads=12,
    num_kv_heads=2,
    d_ff=8960,
    vocab_size=151_936,
    head_dim=128,
    qkv_bias=True,
    rope_theta=1_000_000.0,
    mrope_sections=(16, 24, 24),    # temporal/height/width; sums to hd//2
    frontend="patch_stub",
    tie_embeddings=True,
)

# whisper-medium — enc-dec, 24L(+24L enc) d_model=1024 16H (MHA)
# d_ff=4096, conv frontend stubbed [arXiv:2212.04356];
# repro/configs/whisper_medium.py
WHISPER_MEDIUM = ModelConfig(
    name="whisper-medium",
    family="encdec",
    num_layers=24,                  # decoder layers
    d_model=1024,
    num_heads=16,
    num_kv_heads=16,
    d_ff=4096,
    vocab_size=51_865,
    head_dim=64,
    norm="layernorm",
    act="gelu",
    learned_pos=True,
    qkv_bias=True,
    attn_out_bias=True,
    frontend="audio_stub",
    tie_embeddings=True,
    encdec=EncDecConfig(encoder_layers=24, source_positions=1500),
)

ARCHS = {c.name: c for c in (
    QWEN3_MOE_30B_A3B, GRANITE_MOE_1B_A400M, QWEN3_1_7B, QWEN3_4B, QWEN2_7B,
    QWEN2_5_14B, RECURRENTGEMMA_9B, QWEN2_VL_2B, WHISPER_MEDIUM,
    FALCON_MAMBA_7B)}
SHAPES = {s.name: s for s in ALL_SHAPES}


def get_config(arch_id: str) -> ModelConfig:
    if arch_id in ARCHS:
        return ARCHS[arch_id]
    raise KeyError(f"unknown arch {arch_id!r}; known: {sorted(ARCHS)}")


def get_shape(shape_id: str) -> ShapeConfig:
    if shape_id in SHAPES:
        return SHAPES[shape_id]
    raise KeyError(f"unknown shape {shape_id!r}; known: {sorted(SHAPES)}")


__all__ = [
    "ARCHS", "SHAPES", "get_config", "get_shape", "reduced",
    "shape_applicable", "ModelConfig", "ShapeConfig", "SwarmConfig",
    "MoEConfig", "SSMConfig", "HybridConfig", "EncDecConfig",
    "TRAIN_4K", "PREFILL_32K", "DECODE_32K", "LONG_500K", "ALL_SHAPES",
]
