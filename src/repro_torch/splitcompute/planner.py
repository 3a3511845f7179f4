"""Stage-plan cost model + local-search refinement; port of
``repro/splitcompute/planner.py`` (numpy, over the port's ``plan_stages``).

The φ-proportional partitioner (``partitioner.py``) is the paper's
placement rule: fully distributed, one-hop information.  This module adds
what a deployed serving system layers on top: an explicit cost model
(per-stage compute time on the assigned executor + boundary-activation
transfer time over the link, the d_tx term of Eq. 10 made concrete) and a
boundary local search that refines the φ seed when global information is
available.

Pipeline metrics for a plan:
  stage_time[i]  = layers_flops[i] / F[exec_i] + act_bytes[b_i] / bw[i-1, i]
  latency        = Σ stage_time            (one request walks every stage)
  throughput     = 1 / max stage_time      (steady state, one in flight per
                                            stage)
"""
from __future__ import annotations

import dataclasses
from typing import Optional, Sequence, Tuple

import numpy as np

from repro_torch.configs import ModelConfig
from repro_torch.splitcompute.partitioner import (StagePlan, plan_stages,
                                                  split_points)


@dataclasses.dataclass(frozen=True)
class PipelineCost:
    stage_times_s: Tuple[float, ...]
    latency_s: float
    throughput_rps: float


def layer_profile(cfg: ModelConfig, seq_len: int, batch: int
                  ) -> Tuple[np.ndarray, np.ndarray]:
    """(per-layer GFLOPs, boundary activation bytes) for a request batch.

    Analytic: a layer costs 2 FLOPs per active parameter and token at
    serve; the boundary tensor is [batch, seq, d_model] in bf16 (+ the
    recurrent state for hybrid/ssm: the state ships with the activation).
    """
    toks = seq_len * batch
    per_layer_params = (cfg.active_param_count()
                        - 2 * cfg.vocab_size * cfg.d_model
                        * (1 if not cfg.tie_embeddings else 0.5)
                        ) / cfg.num_layers
    gflops = np.full(cfg.num_layers, 2.0 * per_layer_params * toks / 1e9)
    act = batch * seq_len * cfg.d_model * 2.0          # bf16 residual stream
    extra = 0.0
    if cfg.family == "ssm":
        extra = batch * cfg.ssm.expand * cfg.d_model * cfg.ssm.d_state * 4.0
    elif cfg.family == "hybrid":
        w = cfg.hybrid.lru_width or cfg.d_model
        extra = batch * (w * 4.0 + cfg.hybrid.window * cfg.num_kv_heads
                         * cfg.head_dim_ * 2.0 * 2)
    act_bytes = np.full(cfg.num_layers + 1, act + extra)
    return gflops, act_bytes


def plan_cost(plan: StagePlan, gflops: np.ndarray, act_bytes: np.ndarray,
              F: Sequence[float], bw_bps: np.ndarray) -> PipelineCost:
    """Evaluate a plan against executor capabilities + link bandwidths."""
    times = []
    b = plan.boundaries
    for i, ex in enumerate(plan.executors):
        comp = float(gflops[b[i]:b[i + 1]].sum()) / F[ex]
        tx = 0.0
        if i > 0:
            prev = plan.executors[i - 1]
            tx = float(act_bytes[b[i]]) * 8.0 / float(bw_bps[prev, ex])
        times.append(comp + tx)
    lat = float(sum(times))
    thr = 1.0 / max(times) if times else 0.0
    return PipelineCost(tuple(times), lat, thr)


def refine_plan(cfg: ModelConfig, plan: StagePlan, gflops, act_bytes,
                F: Sequence[float], bw_bps, *, iters: int = 64,
                objective: str = "throughput") -> Tuple[StagePlan,
                                                        PipelineCost]:
    """Greedy boundary local search from the φ seed: move one boundary one
    legal split point at a time while the objective improves."""
    legal = sorted(set(split_points(cfg)))

    def score(p):
        c = plan_cost(p, gflops, act_bytes, F, bw_bps)
        return (c.throughput_rps if objective == "throughput"
                else -c.latency_s), c

    best_s, best_cost = score(plan)
    best = plan
    for _ in range(iters):
        improved = False
        bl = list(best.boundaries)
        for j in range(1, len(bl) - 1):
            for cand in legal:
                if not (bl[j - 1] < cand < bl[j + 1]) or cand == bl[j]:
                    continue
                nb = tuple(bl[:j] + [cand] + bl[j + 1:])
                p2 = StagePlan(nb, best.executors, best.phi)
                s2, c2 = score(p2)
                if s2 > best_s + 1e-12:
                    best, best_s, best_cost = p2, s2, c2
                    bl = list(nb)
                    improved = True
        if not improved:
            break
    return best, best_cost


def plan_and_refine(cfg: ModelConfig, F: Sequence[float],
                    bw_bps: Optional[np.ndarray] = None, *,
                    seq_len: int = 128, batch: int = 4,
                    objective: str = "throughput"):
    """End to end: φ seed (paper rule) → cost model → refined plan.

    Returns (seed_plan, seed_cost, refined_plan, refined_cost).
    """
    n = len(F)
    if bw_bps is None:
        bw_bps = np.full((n, n), 1e9)        # 1 Gb/s default links
    gflops, act_bytes = layer_profile(cfg, seq_len, batch)
    d_tx = (act_bytes.mean() * 8.0 / bw_bps) / max(gflops.mean(), 1e-9)
    seed = plan_stages(cfg, F, d_tx)
    seed_cost = plan_cost(seed, gflops, act_bytes, F, bw_bps)
    refined, refined_cost = refine_plan(cfg, seed, gflops, act_bytes, F,
                                        bw_bps, objective=objective)
    return seed, seed_cost, refined, refined_cost
