"""Quickstart of the PyTorch port: build an assigned architecture (reduced),
train a few steps, then prefill + decode — the whole public API of
``repro_torch`` in one file (the twin of ``examples/quickstart.py``).

    PYTHONPATH=src python examples/torch_quickstart.py [--arch qwen3-1.7b] \\
        [--device cpu]

Runs on the card unless ``--device`` names another device, and raises
where there is none.
"""
import argparse
import time

import torch

from repro_torch.configs import ARCHS, get_config, reduced
from repro_torch.data import DataConfig, batch_at
from repro_torch.device import resolve_device
from repro_torch.launch.step import init_train_state, make_train_step
from repro_torch.models import build_model
from repro_torch.models.common import count_params
from repro_torch.optim import OptConfig


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", default="qwen3-1.7b", choices=sorted(ARCHS))
    ap.add_argument("--steps", type=int, default=20)
    ap.add_argument("--device", default=None,
                    help="torch device (default: cuda, required)")
    args = ap.parse_args(argv)
    device = resolve_device(args.device)

    cfg = reduced(get_config(args.arch))
    print(f"arch={args.arch} family={cfg.family} (reduced for CPU)")
    model = build_model(cfg)
    params = model.init(torch.Generator(device=device).manual_seed(0),
                        device)
    print(f"params: {count_params(params):,}")

    # --- train a few steps on the synthetic pipeline -----------------------
    if cfg.family in ("vlm", "encdec"):
        print("quickstart trains token-LM families; see tests for "
              f"{cfg.family} coverage")
        return None
    step = make_train_step(model, OptConfig(lr=3e-3, warmup_steps=5,
                                            total_steps=200))
    state = init_train_state(
        model, torch.Generator(device=device).manual_seed(0), device)
    dcfg = DataConfig(vocab_size=cfg.vocab_size, seq_len=32, global_batch=8)
    t0 = time.time()
    for s in range(args.steps):
        state, metrics = step(state, batch_at(dcfg, s, device))
        if s % 5 == 0 or s == args.steps - 1:
            print(f"  step {s:3d} loss {float(metrics['loss']):.4f}")
    print(f"trained {args.steps} steps in {time.time()-t0:.1f}s")
    params = state.params

    # --- decode a continuation (replay prompt, then sample greedily) -------
    prompt = batch_at(dcfg, 999, device)["tokens"][:2, :16]
    caches = model.init_cache(2, 32, device)
    logits = None
    with torch.inference_mode():
        for t in range(16):
            logits, caches = model.decode_step(
                params, caches, {"token": prompt[:, t:t + 1], "pos": t})
        out = [int(x) for x in logits.argmax(-1)]
        for t in range(16, 24):
            nxt = logits.argmax(-1)[:, None]
            logits, caches = model.decode_step(
                params, caches, {"token": nxt, "pos": t})
    print("decoded 8 tokens greedily — public API round trip OK")
    return out


if __name__ == "__main__":
    main()
