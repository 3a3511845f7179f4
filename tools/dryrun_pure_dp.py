"""The dry-run's cells under the ``pure_dp`` layout, beside the
tensor-parallel ones that ``python -m repro_torch.launch.dryrun`` writes:
each cell through ``launch.dryrun.run_cell`` with ``cfg_override=
replace(get_config(arch), pure_dp=True)``, as ``benchmarks/hillclimb.py``'s
``puredp`` variant drives the reference's dry-run.  Meta tensors under a
fake process group on the CPU: bounds from H100 datasheet figures, not
times.

    python tools/dryrun_pure_dp.py \\
        --cell falcon-mamba-7b:train_4k --cell qwen3-1.7b:train_4k

Writes one JSON a cell under ``build/dryrun/<mesh>_pure_dp/`` (``--out``)
and prints a line a cell: the collective, compute and memory bounds in
seconds, the state's GB a device and ``useful_flop_ratio``.
"""
from __future__ import annotations

import argparse
import dataclasses
import sys
from pathlib import Path

import torch.distributed as dist

sys.path.insert(0, str(Path(__file__).resolve().parents[1] / "src"))

from repro_torch.configs import get_config  # noqa: E402
from repro_torch.launch import dryrun  # noqa: E402


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--cell", action="append", required=True,
                    help="arch:shape")
    ap.add_argument("--mesh", default="single", choices=sorted(dryrun.MESHES))
    ap.add_argument("--out", default=None)
    args = ap.parse_args(argv)
    out = args.out or str(dryrun.OUT / f"{args.mesh}_pure_dp")
    n_fail = 0
    try:
        for cell in args.cell:
            arch, shape = cell.split(":")
            cfg = dataclasses.replace(get_config(arch), pure_dp=True)
            rec = dryrun.run_cell(arch, shape, args.mesh, out,
                                  cfg_override=cfg)
            n_fail += rec["status"] == "FAIL"
            if rec["status"] == "OK" and "roofline" in rec:
                r, b = rec["roofline"], rec["bytes_per_device"]
                print(f"[pure_dp] {arch} x {shape} x {args.mesh}: "
                      f"collective {r['collective_s']:.4g} s, compute "
                      f"{r['compute_s']:.4g} s, memory {r['memory_s']:.4g} "
                      f"s; {b['total'] / 1e9:.4g} GB a device; useful "
                      f"{rec['useful_flop_ratio']:.2f}; dominant "
                      f"{r['dominant']}", flush=True)
    finally:
        if dist.is_initialized():
            dist.destroy_process_group()
    return 1 if n_fail else 0


if __name__ == "__main__":
    raise SystemExit(main())
