"""Find the knee of a split-serving configuration: the highest offered rate
at which the queue ahead of the first stage does not grow over a window.

    python3 bench/sweep.py --config qwen3-1.7b --mix split-steady \\
        --rates 6,8,10,12,14 --seconds 20 [--seed 1]

Each rate serves the mix's lengths as Poisson arrivals at that rate, with
the early exit off, through one engine on one set of weights (drawn and
warmed once); the first stage's queue depth is read before every step.
A rate "grows" when the mean depth over the window's last quarter exceeds
the mean over its second quarter by more than ``SLACK`` requests.  Prints
a JSON line a rate (the median step is its span on the card) and the knee
last.  Runs on the card only.
"""
from __future__ import annotations

import argparse
import json
import sys
import time
from pathlib import Path

BENCH = Path(__file__).resolve().parent
sys.path[:0] = [str(BENCH), str(BENCH.parent / "src")]

# requests of first-stage queue growth, last quarter over second, that
# count as "grows"
SLACK = 2.0


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--config", required=True)
    ap.add_argument("--mix", required=True)
    ap.add_argument("--rates", required=True)
    ap.add_argument("--seconds", type=float, default=20.0)
    ap.add_argument("--seed", type=int, default=1)
    args = ap.parse_args(argv)

    import numpy as np
    import torch
    from harness import program, serve
    from harness.common import BENCH as B, card_limit, load_json
    from harness.weights import draw_weights
    if not torch.cuda.is_available():
        print("the sweep runs on a CUDA card", file=sys.stderr)
        return 2
    model = load_json(B / "configs" / f"{args.config}.json")
    mix = dict(load_json(B / "mixes" / f"{args.mix}.json"),
               arrivals="poisson", tau_med=1e30, tau_high=1e30)
    dev = torch.device("cuda", 0)
    cfg = program.port_config(model)
    params = program.port_lm(cfg, draw_weights(model, args.seed, dev))
    serve.warm(cfg, params, model, mix, args.seed, dev)
    print(f"card: {card_limit()}", file=sys.stderr)
    knee = None
    for rate in [float(r) for r in args.rates.split(",")]:
        m = dict(mix, rate_x_knee=1.0)
        times, lens = serve.schedule(m, rate, args.seconds, f"sweep{rate}")
        eng = program.serve_engine(cfg, None, m, params)
        drv = serve.Driver(eng, model, m, args.seed, dev)
        depth = []
        step = eng.step

        def watched(*a, **k):
            depth.append((time.perf_counter(), len(eng.queues[0])))
            return step(*a, **k)

        eng.step = watched
        t0 = time.perf_counter()
        drv.drive(times, lens, args.seconds, drain=False)
        t = np.array([d[0] - t0 for d in depth])
        q = np.array([d[1] for d in depth], float)
        T = args.seconds
        q2 = q[(t >= T / 4) & (t < T / 2)].mean()
        q4 = q[t >= 3 * T / 4].mean()
        done = [i for i, x in drv.done_at.items() if x <= T]
        grows = bool(q4 - q2 > SLACK)
        print(json.dumps({"rate_hz": rate, "q_second_quarter": q2,
                          "q_last_quarter": q4, "grows": grows,
                          "offered": len(times), "finished": len(done),
                          "step_ms_median": 1e3 * float(np.median(
                              drv.step_s))}), flush=True)
        if not grows and (knee is None or knee == prev):
            knee = rate
        prev = rate
        del eng, drv
        torch.cuda.empty_cache()
    print(json.dumps({"config": args.config, "knee_hz": knee}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
