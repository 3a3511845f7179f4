"""Where the simulator's time goes on the card: ``python3 tools/profile_sim.py
[--trace-capacity C] [--trace-hop-capacity H] [--trace-state-every E]
[--trace-state-nodes M]``.

Profiles a few epochs of the port's main path (default ``SwarmConfig``:
30 UAVs, 50 runs, dense, Distributed) and of the sparse path (N = 4096,
K = 16, R = 4) with ``torch.profiler``, after warm-up epochs, and prints
per epoch: wall time, CUDA kernel launches, device-busy time (sum of
kernel durations on the one stream), the idle share, and the kernels that
take the most device time.  The flags turn on the telemetry streams
(``SwarmConfig``'s fields of the same names; 0, the default, is off) at
both points; five measured epochs cover one state snapshot at
``--trace-state-every 5``.  Needs a CUDA card.
"""
from __future__ import annotations

import argparse
import dataclasses
import subprocess
import sys
import time
from pathlib import Path

import torch
from torch.profiler import ProfilerActivity, profile

sys.path.insert(0, str(Path(__file__).resolve().parents[1] / "src"))

from repro_torch import rng  # noqa: E402
from repro_torch.configs import SwarmConfig  # noqa: E402
from repro_torch.swarm import simulator as S  # noqa: E402
from repro_torch.swarm.tasks import make_profile  # noqa: E402


def epochs(cfg, n, runs, strategy, warm, measured):
    """Set up R runs and return a closure that steps ``measured`` epochs
    after ``warm`` warm-up epochs have been stepped."""
    keys = rng.split(rng.PRNGKey(0).cuda(), runs)
    k = rng.split(keys)
    st = S.init_state(k[:, 0], cfg, n)
    prof = make_profile(cfg, device="cuda")
    ek = rng.fold_in(k[:, 1], torch.arange(warm + measured, device="cuda"))
    for i in range(warm):
        S._epoch(st, ek[:, i], i, strategy, cfg, prof)
    torch.cuda.synchronize()

    def run():
        for i in range(warm, warm + measured):
            S._epoch(st, ek[:, i], i, strategy, cfg, prof)
        torch.cuda.synchronize()
    return run


def report(label, run, measured):
    with torch.no_grad(), profile(activities=[ProfilerActivity.CPU,
                                              ProfilerActivity.CUDA]) as p:
        t0 = time.perf_counter()
        run()
        wall = time.perf_counter() - t0
    kern = [e for e in p.events() if e.device_type.name == "CUDA"]
    busy_us = sum(e.device_time for e in kern) if kern else 0.0
    print(f"[{label}] per epoch: wall {wall / measured * 1e3:.3f} ms, "
          f"kernels {len(kern) / measured:.0f}, device busy "
          f"{busy_us / measured / 1e3:.3f} ms, idle share "
          f"{1 - busy_us / 1e6 / wall:.4f}" if kern else
          f"[{label}] per epoch: wall {wall / measured * 1e3:.3f} ms, "
          f"device time not measured (the profiler saw no CUDA events)")
    totals = {}
    for e in kern:
        t = totals.setdefault(e.name, [0, 0.0])
        t[0] += 1
        t[1] += e.device_time
    top = sorted(totals.items(), key=lambda kv: -kv[1][1])[:8]
    for name, (count, us) in top:
        print(f"[{label}]   {us / measured / 1e3:9.4f} ms/epoch "
              f"{count / measured:6.0f} launches/epoch  {name[:90]}")


TRACE_FLAGS = ("trace_capacity", "trace_hop_capacity", "trace_state_every",
               "trace_state_nodes")


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    for f in TRACE_FLAGS:
        ap.add_argument("--" + f.replace("_", "-"), type=int, default=0)
    args = ap.parse_args()
    if not torch.cuda.is_available():
        print("profile_sim: no CUDA device", file=sys.stderr)
        return 2
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, check=True).stdout.strip()
    traced = {f: getattr(args, f) for f in TRACE_FLAGS if getattr(args, f)}
    print(f"[device] {smi}; torch {torch.__version__}; telemetry "
          f"{traced or 'off'}")
    tag = " traced" if traced else ""
    cfg = dataclasses.replace(SwarmConfig(), **traced)
    with torch.no_grad():
        dense = epochs(cfg, cfg.num_workers, cfg.num_runs, S.DISTRIBUTED,
                       warm=3, measured=5)
    report(f"dense N=30 R=50 Distributed{tag}", dense, 5)
    sp = dataclasses.replace(cfg, num_workers=4096, neighbor_k=16,
                             neighbor_mode="sparse")
    with torch.no_grad():
        sparse = epochs(sp, 4096, 4, S.DISTRIBUTED, warm=1, measured=5)
    report(f"sparse N=4096 K=16 R=4 Distributed{tag}", sparse, 5)
    return 0


if __name__ == "__main__":
    sys.exit(main())
