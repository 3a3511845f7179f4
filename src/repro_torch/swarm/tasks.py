"""ML task model (paper §3.1), port of ``repro/swarm/tasks.py``.

A task is an L-layer sequential DAG with a vertical split point at every
layer boundary: GFLOPs front-loaded, activation sizes decaying from feature
map to vector scale.  The profile is computed in numpy float64 exactly as
the reference computes it, then stored as float32 tensors.
"""
from __future__ import annotations

from typing import NamedTuple

import numpy as np
import torch

from repro_torch.configs import SwarmConfig


class TaskProfile(NamedTuple):
    gflops: torch.Tensor       # [L] per-layer GFLOPs
    cum_gflops: torch.Tensor   # [L+1] cumulative (cum[0] = 0)
    act_bits: torch.Tensor     # [L+1] activation bits crossing boundary l
    bits_per_gflop: float      # mean activation bits per GFLOP (for d_tx)
    total_gflops: float


def make_profile(cfg: SwarmConfig, device=None) -> TaskProfile:
    L = cfg.task_layers
    w = np.linspace(2.0, 0.5, L)
    g = w / w.sum() * cfg.task_gflops_total
    cum = np.concatenate([[0.0], np.cumsum(g)])
    act_bytes = np.concatenate([[0.5e6], np.geomspace(2.0e6, 64e3, L)])
    act_bits = act_bytes * 8.0
    bits_per_gflop = float(act_bits[1:].mean()) / float(g.mean())

    def f32(a):
        return torch.as_tensor(a.astype(np.float32), device=device)

    return TaskProfile(gflops=f32(g), cum_gflops=f32(cum),
                       act_bits=f32(act_bits), bits_per_gflop=bits_per_gflop,
                       total_gflops=float(cfg.task_gflops_total))


def layer_of(profile: TaskProfile, cum_done: torch.Tensor) -> torch.Tensor:
    """Last completed layer boundary for a progress value (partial layer
    work does not count, §3.1 discard-on-offload)."""
    return torch.searchsorted(profile.cum_gflops, cum_done.contiguous(),
                              right=True) - 1


def boundary_bits(profile: TaskProfile, cum_done: torch.Tensor
                  ) -> torch.Tensor:
    """Bits that must be shipped when offloading at the current boundary."""
    lyr = layer_of(profile, cum_done).clamp(0, profile.act_bits.shape[0] - 1)
    return profile.act_bits[lyr]


def snap_to_boundary(profile: TaskProfile, cum_done: torch.Tensor
                     ) -> torch.Tensor:
    """Discard partial-layer progress (§3.1)."""
    lyr = layer_of(profile, cum_done).clamp(0,
                                            profile.cum_gflops.shape[0] - 1)
    return profile.cum_gflops[lyr]
