"""Train a small LM for a few hundred steps with the port's production
stack: synthetic data pipeline, AdamW + cosine schedule, sharding-aware
step builder, checkpoint/restart driver with an injected failure (the run
dies at step 120 and resumes from the step-100 checkpoint — the final
state is torch.equal to an uninterrupted run's, which runs after it).  The
twin of ``examples/train_lm.py``.

    PYTHONPATH=src python examples/torch_train_lm.py [--steps 200] \\
        [--device cpu]

Runs on the card unless ``--device`` names another device, and raises
where there is none.
"""
import argparse
import shutil
import tempfile
import time

import torch

from repro_torch.checkpoint import flatten
from repro_torch.configs import get_config, reduced
from repro_torch.data import DataConfig, batch_at
from repro_torch.device import resolve_device
from repro_torch.launch.step import init_train_state, make_train_step
from repro_torch.models import build_model
from repro_torch.models.common import count_params
from repro_torch.optim import OptConfig
from repro_torch.runtime import DriverConfig, run_with_restarts


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--steps", type=int, default=200)
    ap.add_argument("--batch", type=int, default=8)
    ap.add_argument("--seq", type=int, default=64)
    ap.add_argument("--device", default=None,
                    help="torch device (default: cuda, required)")
    args = ap.parse_args(argv)
    device = resolve_device(args.device)

    cfg = reduced(get_config("qwen3-1.7b"))
    model = build_model(cfg)
    n = count_params(model.init(torch.Generator(device=device).manual_seed(0),
                                device))
    print(f"training {cfg.name}: {n:,} params, {args.steps} steps")

    opt = OptConfig(lr=3e-3, warmup_steps=20, total_steps=args.steps)
    dcfg = DataConfig(vocab_size=cfg.vocab_size, seq_len=args.seq,
                      global_batch=args.batch)
    train_step = make_train_step(model, opt)

    def init_state():
        return init_train_state(
            model, torch.Generator(device=device).manual_seed(0), device)

    def batch_fn(s):
        return batch_at(dcfg, s, device)

    ckpt = tempfile.mkdtemp(prefix="repro_torch_train_")
    losses = []
    t0 = time.time()

    def on_metrics(step, m):
        losses.append(float(m["loss"]))
        if step % 25 == 0:
            print(f"  step {step:4d} loss {losses[-1]:.4f} "
                  f"({time.time()-t0:.0f}s)")

    drv = DriverConfig(ckpt_dir=ckpt, ckpt_every=100, max_steps=args.steps,
                       fail_at_step=min(120, args.steps - 1))
    print("(failure injected at step 120 — the driver restarts from the "
          "step-100 checkpoint)")
    final = run_with_restarts(drv, init_state=init_state,
                              train_step=train_step, batch_fn=batch_fn,
                              on_metrics=on_metrics)

    first, last = losses[0], sum(losses[-10:]) / 10
    print(f"loss: {first:.3f} → {last:.3f} "
          f"({'improved' if last < first else 'NOT improved'})")
    shutil.rmtree(ckpt, ignore_errors=True)
    assert last < first, "training did not reduce loss"

    # the same steps without a failure or a checkpoint
    straight = run_with_restarts(
        DriverConfig(ckpt_dir=None, max_steps=args.steps),
        init_state=init_state, train_step=train_step, batch_fn=batch_fn)
    a, b = flatten(final), flatten(straight)
    assert a.keys() == b.keys() and all(torch.equal(a[k], b[k]) for k in a), \
        "the resumed run's final state differs from an uninterrupted run's"
    print(f"final state after the restart torch.equal to an uninterrupted "
          f"run's ({len(a)} leaves)")
    return final


if __name__ == "__main__":
    main()
