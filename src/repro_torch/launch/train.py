"""Training launcher: the train loop with checkpoint/restart and the
straggler policy; port of ``repro/launch/train.py``.

    PYTHONPATH=src python -m repro_torch.launch.train --arch qwen3-1.7b \\
        --steps 200 --batch 8 --seq 128 [--device cpu]
    python3 -m repro_torch.launch.train --arch qwen3-1.7b --full-size \\
        --batch 4 --seq 512 --steps 8
    python3 -m repro_torch.launch.train --arch falcon-mamba-7b \\
        --full-size --layers 24 --batch 4 --seq 512 --steps 8
    PYTHONPATH=src torchrun --nproc_per_node 4 -m repro_torch.launch.train \\
        --device cpu --mesh 2,2 --steps 8 --batch 8 --seq 64
    torchrun --nproc_per_node 4 -m repro_torch.launch.train --mesh 2,2 \\
        --arch qwen3-1.7b --full-size --batch 8 --seq 512 --steps 8

Each step is the synthetic batch (``data.batch_at``), ``Model.loss``, its
backward (on the card through the hand-written backward kernels), the
global-norm clip and AdamW, under the checkpoint/restart driver.  The
reduced configuration runs unless ``--full-size`` is given, as in the
reference.  ``--layers N`` cuts the depth, never the width, where the full
train state does not fit on one card (falcon-mamba-7b at 24 layers,
recurrentgemma-9b at 9: three of its ("rec", "rec", "attn") super
blocks).
It runs on CUDA unless ``--device cpu`` is passed, and raises where there
is no card.  Checkpoints go to ``--ckpt-dir`` (``build/train_ckpt`` in the
checkout by default); at full width, where a checkpoint of qwen3-1.7b's
train state is 27.5 GB, only when ``--ckpt-dir`` is given.  Every family
but encdec trains here; encdec trains through
``launch.step.make_train_step`` with batches that carry ``enc_embeds``, as
in the reference, whose launcher takes tokens only.

``--mesh DATA,MODEL`` trains the dense, moe and vlm families on a
``("data", "model")`` mesh of DATA x MODEL processes started by
``torchrun`` (NCCL, one card a process; gloo with ``--device cpu``):
FSDP over "data", tensor and expert parallelism over "model"
(``models.parallel``); every rank logs the same global loss and rank 0
prints.  Without it the launcher is one process and starts no process
group.
"""
from __future__ import annotations

import argparse
import dataclasses
import time
from pathlib import Path
from typing import Dict, List, Optional

import torch

from repro_torch.configs import ModelConfig, get_config, reduced
from repro_torch.data import DataConfig, batch_at
from repro_torch.device import resolve_device
from repro_torch.launch import dist
from repro_torch.launch.mesh import make_mesh
from repro_torch.launch.step import (TrainState, init_train_state,
                                     make_train_step)
from repro_torch.models import build_model
from repro_torch.optim import OptConfig
from repro_torch.runtime import DriverConfig, run_with_restarts

DEFAULT_CKPT_DIR = Path(__file__).resolve().parents[3] / "build" / \
    "train_ckpt"


@dataclasses.dataclass
class TrainRun:
    state: TrainState
    # one entry a step run (a replayed step after a restart again):
    # step, loss, grad_norm, lr and the step's wall time, device
    # synchronised
    records: List[Dict[str, float]]


def train(cfg: ModelConfig, *, steps: int, batch: int, seq: int,
          lr: float = 1e-3, ckpt_dir: Optional[str] = None,
          ckpt_every: int = 50, keep: int = 3, seed: int = 0,
          device=None, fail_at_step: Optional[int] = None,
          log_every: int = 0, mesh=None) -> TrainRun:
    """Train ``cfg`` from random weights (a generator seeded with
    ``seed``) on the synthetic pipeline for ``steps`` steps of ``batch`` x
    ``seq`` tokens, under ``run_with_restarts``; ``ckpt_dir=None`` keeps
    no checkpoints.  ``fail_at_step`` injects one failure (the driver
    restarts from the latest checkpoint).  On ``mesh`` the state is the
    rank's shards (every rank draws the whole initial state from the same
    seed and keeps its shards) and each step takes its part of the
    global batch."""
    device = resolve_device(device)
    model = build_model(cfg, mesh)
    opt_cfg = OptConfig(lr=lr, warmup_steps=20, total_steps=steps)
    dcfg = DataConfig(vocab_size=cfg.vocab_size, seq_len=seq,
                      global_batch=batch)
    step_fn = make_train_step(model, opt_cfg)
    raw: List[Dict] = []

    def train_step(state, b):
        t0 = time.perf_counter()
        state, metrics = step_fn(state, b)
        if device.type == "cuda":
            torch.cuda.synchronize(device)
        raw.append({"step": int(state.opt.step),
                    "wall_s": time.perf_counter() - t0,
                    **{k: metrics[k].detach()
                       for k in ("loss", "grad_norm", "lr")}})
        return state, metrics

    def init_state():
        gen = torch.Generator(device=device).manual_seed(seed)
        return init_train_state(model, gen, device)

    t0 = time.perf_counter()

    def on_metrics(step, metrics):
        if log_every and step % log_every == 0:
            print(f"step {step:5d} loss {float(metrics['loss']):.4f} "
                  f"gnorm {float(metrics['grad_norm']):.3f} "
                  f"lr {float(metrics['lr']):.2e} "
                  f"({(time.perf_counter() - t0):.1f}s)", flush=True)

    drv = DriverConfig(ckpt_dir=None if ckpt_dir is None else str(ckpt_dir),
                       ckpt_every=ckpt_every, keep=keep, max_steps=steps,
                       fail_at_step=fail_at_step)
    state = run_with_restarts(
        drv, init_state=init_state, train_step=train_step,
        batch_fn=lambda step: batch_at(dcfg, step, device),
        on_metrics=on_metrics, mesh=mesh)
    records = [{k: v if isinstance(v, (int, float)) else float(v)
                for k, v in r.items()} for r in raw]
    return TrainRun(state, records)


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", default="qwen3-1.7b")
    ap.add_argument("--full-size", action="store_true",
                    help="use the full config (one card fits the dense, "
                         "moe and vlm models up to qwen2-vl-2b; the ssm and "
                         "hybrid ones with --layers)")
    ap.add_argument("--layers", type=int, default=0,
                    help="cut the depth to this many layers (0: the "
                         "config's own); the width stays")
    ap.add_argument("--steps", type=int, default=100)
    ap.add_argument("--batch", type=int, default=8)
    ap.add_argument("--seq", type=int, default=128)
    ap.add_argument("--lr", type=float, default=1e-3)
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--ckpt-dir", default=None,
                    help=f"default {DEFAULT_CKPT_DIR} (reduced only; at "
                         f"full size no checkpoints unless given)")
    ap.add_argument("--ckpt-every", type=int, default=50)
    ap.add_argument("--log-every", type=int, default=10)
    ap.add_argument("--device", default=None,
                    help="cpu, or a CUDA device (default: the card)")
    ap.add_argument("--mesh", default=None, metavar="DATA,MODEL",
                    help="train on a (data, model) mesh of processes "
                         "started by torchrun")
    args = ap.parse_args(argv)

    cfg = get_config(args.arch)
    if cfg.family == "encdec":
        raise SystemExit("the encdec family trains through "
                         "launch.step.make_train_step with enc_embeds in "
                         "the batch; this launcher feeds tokens only")
    if not args.full_size:
        cfg = reduced(cfg)
    if args.layers:
        cfg = dataclasses.replace(cfg, num_layers=args.layers)
        print(f"depth cut to {args.layers} layers ({cfg.param_count():,} "
              f"parameters); width unchanged", flush=True)
    ckpt_dir = args.ckpt_dir
    if ckpt_dir is None and not args.full_size:
        ckpt_dir = DEFAULT_CKPT_DIR
    mesh, device, log = None, args.device, True
    if args.mesh:
        shape = tuple(int(n) for n in args.mesh.split(","))
        device_type = "cpu" if args.device == "cpu" else "cuda"
        dist.init("gloo" if device_type == "cpu" else "nccl")
        device = dist.local_device(device_type)
        mesh = make_mesh(shape, ("data", "model"), device_type)
        log = dist.rank() == 0
    try:
        run = train(cfg, steps=args.steps, batch=args.batch, seq=args.seq,
                    lr=args.lr, ckpt_dir=ckpt_dir,
                    ckpt_every=args.ckpt_every, seed=args.seed,
                    device=device, log_every=args.log_every if log else 0,
                    mesh=mesh)
    finally:
        dist.destroy()
    if not log:
        return
    if run.records:
        walls = sorted(r["wall_s"] for r in run.records[1:]) or \
            [run.records[0]["wall_s"]]
        print(f"losses {[round(r['loss'], 4) for r in run.records]}; "
              f"median step {walls[len(walls) // 2]:.3f} s, "
              f"{args.batch * args.seq / walls[len(walls) // 2]:.0f} "
              f"tokens/s", flush=True)
    print("done; final step", int(run.state.opt.step), flush=True)


if __name__ == "__main__":
    main()
