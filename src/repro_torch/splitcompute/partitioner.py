"""φ-driven model partitioning, the paper's technique as a stage placer;
port of ``repro/splitcompute/partitioner.py``.

``plan_stages`` assigns contiguous layer ranges of a decoder-only LM to
heterogeneous executors in proportion to their aggregated computation
capability φ (Eq. 10), run to its fixpoint over a fully connected executor
graph by the port's ``phi_fixpoint``.  The rounding and the tie order
(``np.argsort(-phi)``, a stable quicksort on the same values) are the
reference's, so both packages give the same boundaries and executors.
"""
from __future__ import annotations

import dataclasses
from typing import List, Sequence, Tuple

import numpy as np
import torch

from repro_torch.configs import ModelConfig
from repro_torch.core.diffusive import phi_fixpoint


@dataclasses.dataclass(frozen=True)
class StagePlan:
    boundaries: Tuple[int, ...]   # len = n_stages+1; stage i = [b[i], b[i+1])
    executors: Tuple[int, ...]    # executor id per stage
    phi: Tuple[float, ...]        # aggregated capability per executor


def split_points(cfg: ModelConfig) -> List[int]:
    """Legal vertical split boundaries (layer indices 1..L-1).

    hybrid: superblock granularity (recurrent state + window cache travel
    with the activation, so we only cut between superblocks); others: every
    layer boundary (the residual stream is the one tensor that crosses
    it).
    """
    if cfg.family == "hybrid":
        n = len(cfg.hybrid.pattern)
        return list(range(n, cfg.num_layers - cfg.num_layers % n, n))
    return list(range(1, cfg.num_layers))


def plan_stages(cfg: ModelConfig, F: Sequence[float],
                link_delay_s_per_gflop: Sequence[Sequence[float]] = None,
                n_stages: int = None) -> StagePlan:
    """Partition cfg.num_layers layers over executors proportionally to φ.

    F: raw capability per executor (GFLOP/s-like units).  link_delay:
    [n, n] matrix (s/GFLOP) for the φ diffusion; default = uniform 1e-4.
    Runs on the CPU: n is the number of executors.
    """
    n = len(F)
    n_stages = n_stages or n
    Ft = torch.as_tensor(np.asarray(F, np.float32))
    if link_delay_s_per_gflop is None:
        d_tx = torch.full((n, n), 1e-4, dtype=torch.float32)
    else:
        d_tx = torch.as_tensor(np.asarray(link_delay_s_per_gflop,
                                          np.float32))
    adj = ~torch.eye(n, dtype=torch.bool)   # fully-connected executor graph
    phi, _ = phi_fixpoint(Ft, adj, d_tx, iters=16)
    phi_np = phi.numpy()

    # proportional allocation of layers to the n_stages strongest executors
    order = np.argsort(-phi_np)[:n_stages]
    weights = phi_np[order] / phi_np[order].sum()
    L = cfg.num_layers
    legal = set(split_points(cfg)) | {0, L}
    raw = np.round(np.cumsum(weights) * L).astype(int)
    raw[-1] = L
    bounds = [0]
    for b in raw:
        # the legal split point nearest b above the previous bound
        cand = min(legal, key=lambda p, b=b: (abs(p - int(b))
                                              if p > bounds[-1] else 10**9))
        bounds.append(max(cand, bounds[-1]))
    bounds[-1] = L
    # dedupe while preserving monotonicity
    dedup = [0]
    for b in bounds[1:]:
        if b > dedup[-1]:
            dedup.append(b)
    if dedup[-1] != L:
        dedup.append(L)
    execs = tuple(int(order[i]) for i in range(len(dedup) - 1))
    return StagePlan(tuple(dedup), execs, tuple(float(x) for x in phi_np))
