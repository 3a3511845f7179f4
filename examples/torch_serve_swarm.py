"""End-to-end driver of the PyTorch port (the paper's kind: distributed
inference serving); the twin of ``examples/serve_swarm.py``.

A small LM is partitioned at vertical split points by the diffusive
φ-metric over a fleet of heterogeneous executors, then serves batched
requests; a mid-run burst triggers the congestion-aware early exit
(Eqs. 14-16), visibly trading exit depth for latency — the complete paper
mechanism driving real model execution.  Requests are ``torch.Generator``
draws (the reference draws them with ``jax.random``).

    PYTHONPATH=src python examples/torch_serve_swarm.py [--device cpu]

Runs on the card unless ``--device`` names another device, and raises
where there is none.
"""
import argparse

import numpy as np
import torch

from repro_torch.configs import get_config, reduced
from repro_torch.device import resolve_device
from repro_torch.models import build_model
from repro_torch.splitcompute import SplitServeEngine, plan_stages


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--device", default=None,
                    help="torch device (default: cuda, required)")
    args = ap.parse_args(argv)
    device = resolve_device(args.device)

    cfg = reduced(get_config("qwen3-4b"))
    model = build_model(cfg)
    params = model.init(torch.Generator(device=device).manual_seed(0),
                        device)

    # heterogeneous fleet (paper Table 2: capability ~ N(400, 100) GFLOP/s)
    rng = np.random.default_rng(7)
    F = np.maximum(rng.normal(400, 100, 4), 50.0)
    # link delay per unit workload (s/GFLOP) — the d_tx term of Eq. 10
    d_tx = rng.uniform(1e-4, 1e-3, (4, 4))
    plan = plan_stages(cfg, F, d_tx)
    print("fleet capability (GFLOP/s):", np.round(F, 1).tolist())
    print("aggregated capability φ   :", np.round(plan.phi, 1).tolist())
    print("stage boundaries:", plan.boundaries,
          "→ executors:", plan.executors)

    eng = SplitServeEngine(cfg, params, plan, tau_med=0.5, tau_high=1.5)
    gen = torch.Generator(device=device).manual_seed(1)

    # submit/step both use the engine's internal epoch clock (no t_now), so
    # latency is measured in one clock domain and the run is deterministic
    def submit(n):
        for _ in range(n):
            toks = torch.randint(0, cfg.vocab_size, (4, 32), generator=gen,
                                 device=device)
            eng.submit({"tokens": toks})

    # steady phase: requests trickle in, engine keeps up → full-depth exits
    print("\n-- steady phase --")
    for _ in range(8):
        submit(1)
        done = eng.step()
        for rid, logits in done:
            print(f"  request {rid} done: logits {tuple(logits.shape)}")
    steady = dict(eng.stats.exit_counts)

    # burst phase: the event-triggered surge of Fig. 1 → early exits fire
    print("-- burst phase (congestion) --")
    submit(24)
    stats = eng.drain()
    print(f"\nserved {stats.completed} sequences, "
          f"avg latency {stats.avg_latency*1e3:.1f} epoch-ms, "
          f"{len(eng.results)} logits tensors stashed")
    print("exit depth counts  0=full 1=medium 2=high:", stats.exit_counts)
    burst_exits = (stats.exit_counts[1] + stats.exit_counts[2]
                   - steady[1] - steady[2])
    print(f"early exits triggered by the burst: {burst_exits}")
    assert stats.completed > 0 and len(eng.results) == 8 + 24
    return stats


if __name__ == "__main__":
    main()
