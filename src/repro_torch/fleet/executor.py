"""Batched execution of Monte-Carlo runs, port of the ``vmap`` backend of
``repro/fleet/executor.py``.

The R runs of one (cfg, strategy, n) point share one explicit run axis:
``keys = split(key, R)`` as in the reference, then one ``run_sim`` over all
R at once.  The sharded and streaming backends, the result store and the
report are later slices of the port (ROADMAP.md).
"""
from __future__ import annotations

from typing import Dict

import torch

from repro_torch import rng
from repro_torch.configs import SwarmConfig
from repro_torch.device import resolve_device
from repro_torch.swarm.simulator import run_sim


def run_batch(key: torch.Tensor, cfg: SwarmConfig, strategy, n: int,
              num_runs: int, device=None) -> Dict[str, torch.Tensor]:
    """Run ``num_runs`` simulations of ``(cfg, strategy, n)`` from ``key``
    (uint32[2]); returns a dict of [num_runs] float32 tensors on the
    device."""
    device = resolve_device(device)
    keys = rng.split(key.to(device), num_runs)
    with torch.no_grad():
        return run_sim(keys, cfg, int(strategy), n)
