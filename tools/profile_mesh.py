"""The mesh path's cost on one card: ``python3 tools/profile_mesh.py
[--arch ARCH] [--steps N]``.

On an NCCL group of one process and a (1, 1) ("data", "model") mesh, at
the full width of ``--arch`` (qwen3-1.7b, the default, or
granite-moe-1b-a400m; random weights from seed 0), two train states: one
through the one-process path (``build_model(cfg)``), one through the mesh
path (``build_model(cfg, mesh)``: the layout, the per-use views, the
sharded clip; a mesh axis of 1 takes no collective).  Two warm steps
each, then turns of ``--steps`` steps (default 5) in the order
one-process, mesh, mesh, one-process, on the synthetic batches of 4 x 512
tokens, each step's wall ended by a synchronise.  It prints each turn's
walls, each path's median, and over one more step of each path
(torch.profiler, CPU and CUDA activities) the kernels launched and the
device-busy time, so that a difference in wall can be told apart from a
difference in device work.  Needs a CUDA card.
"""
from __future__ import annotations

import argparse
import statistics
import subprocess
import sys
import time
from pathlib import Path

import torch
from torch.profiler import ProfilerActivity, profile

sys.path.insert(0, str(Path(__file__).resolve().parents[1] / "src"))

from repro_torch.configs import get_config  # noqa: E402
from repro_torch.data import DataConfig, batch_at  # noqa: E402
from repro_torch.launch import dist  # noqa: E402
from repro_torch.launch import step as step_mod  # noqa: E402
from repro_torch.launch.mesh import make_mesh  # noqa: E402
from repro_torch.models import build_model  # noqa: E402
from repro_torch.optim import OptConfig  # noqa: E402

ARCHS = ("qwen3-1.7b", "granite-moe-1b-a400m")
B, S = 4, 512


def busy(fn) -> tuple:
    """(kernels, device-busy ms) of one call of ``fn`` under the
    profiler."""
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        fn()
        torch.cuda.synchronize()
    kernels = [e for e in prof.events()
               if e.device_type == torch.autograd.DeviceType.CUDA]
    return len(kernels), sum(e.device_time for e in kernels) / 1e3


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--arch", choices=ARCHS, default=ARCHS[0])
    ap.add_argument("--steps", type=int, default=5)
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        print("profile_mesh: no CUDA device", file=sys.stderr)
        return 2
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, check=True, timeout=60).stdout.strip()
    print(f"[device] {smi}; torch {torch.__version__}; {args.arch}; "
          f"{B} x {S} tokens a step")
    torch.backends.cuda.matmul.allow_tf32 = False
    from torch.distributed import HashStore
    dist.init("nccl", store=HashStore(), rank=0, world_size=1)
    try:
        mesh = make_mesh((1, 1), ("data", "model"), "cuda")
        cfg = get_config(args.arch)
        ocfg = OptConfig(lr=1e-3, warmup_steps=20, total_steps=1000)
        dcfg = DataConfig(vocab_size=cfg.vocab_size, seq_len=S,
                          global_batch=B)
        paths = {}
        for name, m in (("one-process", None), ("mesh", mesh)):
            model = build_model(cfg, m)
            state = step_mod.init_train_state(
                model, torch.Generator(device="cuda").manual_seed(0))
            paths[name] = [step_mod.make_train_step(model, ocfg), state]
        step = 0

        def one(name):
            nonlocal step
            b = batch_at(dcfg, step, "cuda")
            step += 1
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            fn, state = paths[name]
            paths[name][1], _ = fn(state, b)
            torch.cuda.synchronize()
            return time.perf_counter() - t0

        for name in paths:
            for _ in range(2):
                one(name)
        walls = {name: [] for name in paths}
        for name in ("one-process", "mesh", "mesh", "one-process"):
            turn = [one(name) for _ in range(args.steps)]
            walls[name] += turn
            print(f"[turn] {name}: {[round(w * 1e3, 3) for w in turn]} ms")
        for name, ws in walls.items():
            print(f"[median] {name}: {statistics.median(ws) * 1e3:.3f} ms "
                  f"a step (min {min(ws) * 1e3:.3f}, max "
                  f"{max(ws) * 1e3:.3f}, {len(ws)} steps)")
        for name in paths:
            n, ms = busy(lambda name=name: one(name))
            print(f"[busy] {name}: {n} kernels, {ms:.3f} ms device busy in "
                  f"one step")
    finally:
        dist.destroy()
    return 0


if __name__ == "__main__":
    sys.exit(main())
