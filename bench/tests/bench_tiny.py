"""Reduced configurations and a driver call for the benchmark's CPU tests:
the same harness, program and reference at a few layers of width 64."""
from __future__ import annotations

import copy
import sys
import time
from pathlib import Path

BENCH = Path(__file__).resolve().parents[1]
for p in (str(BENCH.parent / "src"), str(BENCH)):
    if p not in sys.path:
        sys.path.insert(0, p)

from harness.common import find_cell  # noqa: E402


def tiny_model(model):
    m = copy.deepcopy(model)
    m.update(num_hidden_layers=4, hidden_size=64, num_attention_heads=4,
             num_key_value_heads=2, head_dim=16, vocab_size=256,
             intermediate_size=48)
    if m.get("num_local_experts"):
        m.update(num_local_experts=8, num_experts_per_tok=2)
    m["train"] = {"batch": 2, "seq": 32}
    m["serve"] = dict(m["serve"], batch=2, knee_hz=4.0)
    return m


def tiny_cell(name: str):
    cell = find_cell(name)
    if cell.mix["driver"] == "split":
        cell.mix = dict(cell.mix, length={"median": 24, "sigma": 0.5,
                                          "lo": 8, "hi": 48, "multiple": 8},
                        sample=dict(cell.mix["sample"], from_first=0.5))
    return cell


def run_tiny(name: str, seed: int = 2**31 + 5, seconds: float = 0.5,
             fault=None, limits=None):
    """One run of cell ``name`` on the CPU at the reduced sizes."""
    import torch
    from harness import serve, train
    cell = tiny_cell(name)
    if limits is not None:
        cell.limits = limits
    drv = train if cell.mix["driver"] == "train" else serve
    return drv.run(cell, seed, seconds, False, torch.device("cpu"),
                   time.perf_counter(), fault=fault,
                   model=tiny_model(cell.model))
