"""Run one cell of the benchmark once and print its result line.

    python3 bench/run.py --workload NAME --seed N --seconds S --trace 0|1

The cell's parts are found by name: ``BENCHMARK.json`` at the root of the
checkout names its configuration (``bench/configs/<config>.json``) and
its traffic (``bench/mixes/<traffic>.json``, whose ``driver`` picks the
training or the split-serving driver); its limits are
``bench/limits/<workload>.json`` and each per-layer metric's reader is
``bench/metrics/<metric>.py``.  With ``--trace 0`` the line holds the
cell's end-to-end metrics, with ``--trace 1`` its per-layer ones.

The run needs as many CUDA cards as the cell asks for, and fails (no
result, exit 2) without them; it never falls back to the CPU.  It fails
(exit 3) if a module named ``jax``, ``jaxlib``, ``flax`` or ``repro`` is
loaded once its window has closed.  The last line on standard output is
the result; the numbers compared, each beside its limit, are the last
lines on standard error.
"""
from __future__ import annotations

import time

T_START = time.perf_counter()

import argparse  # noqa: E402
import os  # noqa: E402
import sys  # noqa: E402
from pathlib import Path  # noqa: E402

BENCH = Path(__file__).resolve().parent
sys.path[:0] = [str(BENCH), str(BENCH.parent / "src")]

from harness.common import cache_env  # noqa: E402

os.environ.update(cache_env())


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = ap.parse_args(argv)

    from harness.common import (card_limit, compared_lines, find_cell,
                                forbidden_loaded, result_line)
    cell = find_cell(args.workload)
    chips = int(cell.workload["chips"])

    import torch
    if not torch.cuda.is_available() or torch.cuda.device_count() < chips:
        print(f"this cell needs {chips} CUDA card(s); "
              f"torch.cuda.is_available() is {torch.cuda.is_available()}, "
              f"{torch.cuda.device_count()} found", file=sys.stderr)
        return 2
    torch.cuda.set_device(0)
    if cell.mix["driver"] == "train":
        from harness import train as driver
    else:
        from harness import serve as driver
    out = driver.run(cell, args.seed, args.seconds, bool(args.trace),
                     torch.device("cuda", 0), T_START)
    bad = forbidden_loaded()
    if bad:
        print(f"modules that no run may load were loaded: {bad}",
              file=sys.stderr)
        return 3
    device = {"platform": "gpu", "kind": torch.cuda.get_device_name(0),
              "count": chips}
    print(f"card: {card_limit()}", file=sys.stderr)
    print(result_line(cell, out, bool(args.trace), device), flush=True)
    print(compared_lines(out), file=sys.stderr, flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
