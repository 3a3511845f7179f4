"""Serving launcher: φ-partitioned split-computing inference over
heterogeneous executors (the paper's protocol driving a real LM); port of
``repro/launch/serve.py``.

    PYTHONPATH=src python -m repro_torch.launch.serve --arch qwen3-1.7b \\
        --requests 32 --batch 4 [--device cpu]

``--arch`` takes the decoder-only architectures, as the reference's
launcher does: the dense qwen3 and qwen2 models, the moe granite-moe-1b-a400m
and qwen3-moe-30b-a3b, and the vlm qwen2-vl-2b (served from token ids).
``main()`` serves the reduced variant of the architecture, as the
reference's launcher does; ``serve()`` takes any config (``chip_smoke.py``
gives it the full-width one).  It runs on CUDA unless given a device and
raises where there is none.
"""
from __future__ import annotations

import argparse
import dataclasses
import time
from typing import List, Optional

import numpy as np
import torch

from repro_torch import rng
from repro_torch.configs import ModelConfig, get_config, reduced
from repro_torch.device import resolve_device
from repro_torch.models import build_model
from repro_torch.models.transformer import LM
from repro_torch.splitcompute import SplitServeEngine, StagePlan, plan_stages


@dataclasses.dataclass
class ServeRun:
    F: np.ndarray                 # executor capabilities, GFLOP/s
    plan: StagePlan
    engine: SplitServeEngine      # its .stats and .results hold the outcome
    tokens: List[torch.Tensor]    # the submitted [batch, seq] int32 tokens
    wall_s: float                 # submit to drained, device synchronised


def _sync(device: torch.device) -> None:
    if device.type == "cuda":
        torch.cuda.synchronize(device)


def serve(cfg: ModelConfig, requests: int, batch: int, seq: int,
          executors: int, burst: int, *, device=None,
          generator: Optional[torch.Generator] = None,
          params: Optional[LM] = None) -> ServeRun:
    """Plan stages over ``executors`` heterogeneous executors, then submit
    ``requests`` requests of ``batch`` x ``seq`` tokens, stepping the engine
    after each, then ``burst`` more at once (which fires the congestion
    early exit), and drain.

    The weights are ``params`` (e.g. bridged from the JAX package), or else
    drawn from ``generator`` (a generator on ``device``; by default seeded
    with 0).  Request tokens are drawn as the reference's launcher draws
    them (``randint`` on successive ``split``s of key 1), with the port's
    bit-exact ``rng``, so both launchers submit the same tokens.
    """
    device = resolve_device(device)
    if params is None:
        if generator is None:
            generator = torch.Generator(device=device).manual_seed(0)
        params = build_model(cfg).init(generator, device)

    # heterogeneous executors (paper Table 2: N(400, 100) GFLOP/s)
    F = np.maximum(np.random.default_rng(0).normal(400, 100, executors),
                   50.0)
    plan = plan_stages(cfg, F)
    eng = SplitServeEngine(cfg, params, plan)
    key = rng.PRNGKey(1)
    tokens = []

    def submit():
        nonlocal key
        key, k = rng.split(key)
        toks = rng.randint(k, (batch, seq), 0, cfg.vocab_size)
        tokens.append(toks)
        eng.submit({"tokens": toks.to(device, torch.int64)})

    _sync(device)
    t0 = time.perf_counter()
    # submit/step share the engine's deterministic epoch clock, so latency
    # is in epoch time, reproducible run to run; wall time is for
    # throughput only
    for _ in range(requests):
        submit()
        eng.step()
    for _ in range(burst):
        submit()
    eng.drain()
    _sync(device)
    return ServeRun(F, plan, eng, tokens, time.perf_counter() - t0)


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", default="qwen3-1.7b")
    ap.add_argument("--requests", type=int, default=16)
    ap.add_argument("--batch", type=int, default=4)
    ap.add_argument("--seq", type=int, default=64)
    ap.add_argument("--executors", type=int, default=4)
    ap.add_argument("--burst", type=int, default=0,
                    help="submit this many extra requests at once to trigger "
                         "the congestion-aware early exit")
    ap.add_argument("--device", default=None,
                    help="torch device (default: cuda, required)")
    args = ap.parse_args(argv)

    cfg = reduced(get_config(args.arch))
    run = serve(cfg, args.requests, args.batch, args.seq, args.executors,
                args.burst, device=args.device)
    stats = run.engine.stats
    print("capabilities:", np.round(run.F, 1).tolist())
    print("φ:", np.round(run.plan.phi, 1).tolist())
    print("stage boundaries:", run.plan.boundaries, "executors:",
          run.plan.executors)
    print(f"served {stats.completed} sequences in {run.wall_s:.2f}s "
          f"({stats.completed / run.wall_s:.1f} seq/s), avg latency "
          f"{stats.avg_latency * 1e3:.1f} epoch-ms, "
          f"{len(run.engine.results)} result tensors stashed")
    print("exit label counts (0=full,1=medium,2=high):", stats.exit_counts)


if __name__ == "__main__":
    main()
