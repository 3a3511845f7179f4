"""Read the control and the faults of a cell's comparison at the cell's own
size, and judge each by the cell's own limits: the numbers that set the
upper end of each limit, and the proof that each comes out not correct.

    python3 bench/control.py --workload NAME --seeds 11,12,13

Training cells: the reference in float8 (both operands of every product
rounded to e4m3 with a per-tensor scale, forward and backward), and the
float32 reference on half of each batch (the mean over the rest), each
held against the float32 reference by the cell's own numbers
(``train.gaps``) through its checked steps.  A step that returns its
state unchanged reads ``grad_gap`` 1 by construction and needs no run.
Serve cells: the cell's sampled prompts (the sampling rule of
``serve.sample`` over the window of ``BENCHMARK.json``'s ``run_seconds``)
at every depth the engine can serve them at under the mix
(``program.served_depths``: the full depth where the exit is off), the
gap below the float32 reference's best of the token that the float8
reference puts first there.  Since the cell compares each request at the
depth it was served at, the control's reading is the least over the ways
the sampled requests could have been served: each request at its own
depth of least gap.  Every control is passed through ``compare`` with the
cell's limits, and its line says whether it came out ``correct``; a sound
control does not.  One JSON line a seed.  Runs on the card only; the
benchmark's own runs do not run this.  ``bench/tests/test_bench_control.py``
runs ``readings`` at reduced sizes on the CPU.
"""
from __future__ import annotations

import argparse
import gc
import json
import sys
import time
from pathlib import Path

BENCH = Path(__file__).resolve().parent
for _p in (str(BENCH.parent / "src"), str(BENCH)):
    if _p not in sys.path:
        sys.path.insert(0, _p)


def judged(read, limits):
    """A control's readings (each a value, or a (value, where) pair), the
    numbers compared beside the limits, and the verdict."""
    from harness.common import compare, verdict
    values = {k: (v[0] if isinstance(v, (list, tuple)) else v)
              for k, v in read.items()}
    compared = compare(values, limits)
    return {"read": read, "compared": compared,
            "correct": verdict(compared)}


def readings(cell, model, seed: int, device, seconds: float = 30.0,
             limits=None):
    """One seed's control and fault readings of ``cell`` (``model`` its
    configuration, or a reduced one in the tests), each judged under
    ``limits`` (the cell's own by default); ``seconds`` is the window
    whose schedule the serve cells sample."""
    from harness import program
    from harness.weights import draw_weights, request_tokens, train_tokens
    from reference import decoder as ref
    limits = cell.limits if limits is None else limits
    mix = cell.mix
    if mix["driver"] == "train":
        from harness import train
        B, S = model["train"]["batch"], model["train"]["seq"]

        def feed(j):
            x, y = train_tokens(seed, j, B, S, model["vocab_size"], device)
            return {"tokens": x, "labels": y}

        n = train.ref_steps(cell)
        base = train.reference(model, mix, seed, device, ref.FP32, feed, n)
        fp8 = train.reference(model, mix, seed, device, ref.FP8, feed, n)
        half = train.reference(model, mix, seed, device, ref.FP32, feed, n,
                               batch_rows=B // 2)
        return {"seed": seed,
                "fp8": judged(train.gaps(fp8, base), limits),
                "half_batch": judged(train.gaps(half, base), limits),
                "losses": base["losses"]}
    from harness import serve
    _, lens = serve.schedule(mix, model["serve"]["knee_hz"], seconds,
                             "arrivals")
    depths = program.served_depths(program.port_config(model), mix)
    tree = draw_weights(model, seed, device)
    Bs = model["serve"]["batch"]
    per = []                    # (positions, {depth: (widest, mean)})
    for i in serve.sample(lens, mix, seed):
        prompt = request_tokens(seed, i, Bs, int(lens[i]),
                                model["vocab_size"], device)
        per.append((prompt.numel(),
                    ref.control_gaps(tree, model, prompt, depths, ref.FP8)))
    n = sum(k for k, _ in per)
    least = {"logit_gap": max(min(w for w, _ in g.values()) for _, g in per),
             "mean_logit_gap": sum(k * min(m for _, m in g.values())
                                   for k, g in per) / n}
    at_depth = {d: {"logit_gap": max(g[d][0] for _, g in per),
                    "mean_logit_gap": sum(k * g[d][1] for k, g in per) / n}
                for d in depths}
    return {"seed": seed, "depths": depths, "fp8": judged(least, limits),
            "fp8_at_depth": at_depth}


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seeds", required=True)
    args = ap.parse_args(argv)
    import torch
    if not torch.cuda.is_available():
        print("the control runs on a CUDA card", file=sys.stderr)
        return 2
    from harness.common import ROOT, card_limit, find_cell, load_json
    from reference import decoder as ref
    cell = find_cell(args.workload)
    seconds = float(load_json(ROOT / "BENCHMARK.json")["run_seconds"])
    dev = torch.device("cuda", 0)
    ref.plain_mode()
    print(f"card: {card_limit()}", file=sys.stderr)
    for seed in [int(s) for s in args.seeds.split(",")]:
        t0 = time.perf_counter()
        line = readings(cell, cell.model, seed, dev, seconds)
        line["seconds"] = time.perf_counter() - t0
        print(json.dumps(line), flush=True)
        gc.collect()
        torch.cuda.empty_cache()
    return 0


if __name__ == "__main__":
    sys.exit(main())
