"""Where a training step's time goes on the card:
``python3 tools/profile_train.py [--arch ARCH] [--layers N]
[--cast-weights-bf16]``.

At the full width of ``--arch`` (qwen3-1.7b, the default; granite-moe-1b-
a400m; qwen2-vl-2b, trained from token ids; falcon-mamba-7b and
recurrentgemma-9b, at the depth cut ``--layers``, by default 24 and 9 as
``chip_smoke.py`` phase 14c trains them; whisper-medium, on batches of
4 x 448 tokens over 1500 random frames; random weights from seed 0),
``make_train_step`` on the synthetic batches of 4 x 512 tokens (remat
"nothing", AdamW as ``launch.train`` sets it): two warm steps, then
torch.profiler (CPU and CUDA activities) over one step.  It prints the
wall time of the step (ended by a synchronise), the CUDA kernels launched,
the device-busy time (the sum of kernel durations on the one stream), the
idle share, and the shares of busy time (with their launches) of the
flash-attention forward and backward kernels, the rmsnorm forward and
backward kernels, the scans' forward and backward kernels, the casts to
bf16 (``bfloat16_copy_kernel_cuda``) and the multi-tensor kernels
(``multi_tensor_apply_kernel``: AdamW's ``_foreach`` stages); then the
kernels that take the most device time.  Two parts of the step are then
timed alone with CUDA events and given as shares of the step's busy time:
AdamW (``apply_updates`` with the global norm and the clip, on the step's
gradients) and the head + CE (the final norm, the head and the loss,
forward and backward: on the step's final hidden states for the dense,
moe and vlm families, on random hidden states of the same shape for the
others, whose cost does not depend on the values), whose kernels have no
names of their own.  Needs a CUDA card.
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

from repro_torch.configs import get_config  # noqa: E402
from repro_torch.data import DataConfig, batch_at  # noqa: E402
from repro_torch.launch import step as step_mod  # noqa: E402
from repro_torch.models import build_model  # noqa: E402
from repro_torch.models import encdec  # noqa: E402
from repro_torch.models import transformer as tf  # noqa: E402
from repro_torch.optim import OptConfig  # noqa: E402

ARCHS = ("qwen3-1.7b", "granite-moe-1b-a400m", "qwen2-vl-2b",
         "falcon-mamba-7b", "recurrentgemma-9b", "whisper-medium")
# the depth cuts of phase 14c (full width; the full train state does not
# fit on one card)
LAYERS = {"falcon-mamba-7b": 24, "recurrentgemma-9b": 9}
B, S, WHISPER_S = 4, 512, 448
GROUPS = {"flash fwd": ("flash_kernel",), "flash bwd": ("flash_bwd_",),
          "rmsnorm fwd": ("rmsnorm_kernel",),
          "rmsnorm bwd": ("rmsnorm_bwd_",),
          "scan fwd": ("mamba_scan_kernel", "rglru_tma_kernel",
                       "rglru_rowwise_kernel"),
          "scan bwd": ("mamba_bwd_chunk_kernel", "mamba_chk_kernel",
                       "mamba_dc_sum_kernel", "rglru_scan_bwd_kernel"),
          "casts to bf16": ("bfloat16_copy_kernel",),
          "multi-tensor (AdamW)": ("multi_tensor_apply_kernel",)}


def event_ms(once, reps=3) -> float:
    """Device time of ``once()`` after one warm call: CUDA events around
    ``reps`` back-to-back calls."""
    once()
    a = torch.cuda.Event(enable_timing=True)
    b = torch.cuda.Event(enable_timing=True)
    torch.cuda.synchronize()
    a.record()
    for _ in range(reps):
        once()
    b.record()
    b.synchronize()
    return a.elapsed_time(b) / reps


def head_once(cfg, params, h, labels):
    """The final norm, head and loss, forward and backward, on ``h``."""
    leaves = list(params.parameters())

    def once():
        if cfg.family == "encdec":
            loss = tf.lm_loss(encdec._head(params, cfg, h), labels,
                              vocab=cfg.vocab_size)
        else:
            loss = tf.head_loss(params, cfg, h, labels)
        torch.autograd.grad(loss, [h] + leaves, allow_unused=True)
    return once


def batches_of(cfg, n: int) -> list:
    """``n`` batches of the synthetic pipeline (4 x 512 tokens); for
    whisper 4 x 448 tokens with random frames [4, 1500, 1024] in bf16."""
    if cfg.family != "encdec":
        dcfg = DataConfig(vocab_size=cfg.vocab_size, seq_len=S,
                          global_batch=B)
        return [batch_at(dcfg, s) for s in range(n)]
    g = torch.Generator(device="cuda").manual_seed(2)
    F = cfg.encdec.source_positions
    out = []
    for _ in range(n):
        toks = torch.randint(0, cfg.vocab_size, (B, WHISPER_S + 1),
                             device="cuda", generator=g)
        out.append({"enc_embeds": torch.randn(
            (B, F, cfg.d_model), device="cuda", generator=g).to(
            torch.bfloat16), "tokens": toks[:, :-1], "labels": toks[:, 1:]})
    return out


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--arch", choices=ARCHS, default=ARCHS[0])
    ap.add_argument("--layers", type=int, default=None,
                    help="cut the depth (default: 24 for falcon-mamba-7b, "
                         "9 for recurrentgemma-9b, else the config's)")
    ap.add_argument("--cast-weights-bf16", action="store_true",
                    help="the cast_weights_bf16 lever: casts inside the "
                         "loss, once a step")
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        print("profile_train: no CUDA device", file=sys.stderr)
        return 2
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, check=True, timeout=60).stdout.strip()
    cfg = dataclasses.replace(get_config(args.arch),
                              cast_weights_bf16=args.cast_weights_bf16)
    layers = LAYERS.get(args.arch, 0) if args.layers is None \
        else args.layers
    if layers:
        cfg = dataclasses.replace(cfg, num_layers=layers)
    tokens = B * (WHISPER_S if cfg.family == "encdec" else S)
    print(f"[device] {smi}; torch {torch.__version__}; {args.arch} "
          f"({cfg.num_layers} layers); cast_weights_bf16 "
          f"{args.cast_weights_bf16}; {tokens} tokens a step")
    torch.backends.cuda.matmul.allow_tf32 = False
    model = build_model(cfg)
    ocfg = OptConfig(lr=1e-3, warmup_steps=20, total_steps=8)
    state = step_mod.init_train_state(
        model, torch.Generator(device="cuda").manual_seed(0))
    fn = step_mod.make_train_step(model, ocfg)
    batches = batches_of(cfg, 3)
    for b in batches[:2]:
        state, _ = fn(state, b)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as p:
        t0 = time.perf_counter()
        state, m = fn(state, batches[2])
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
    peak = torch.cuda.max_memory_allocated()
    kern = [e for e in p.events() if e.device_type.name == "CUDA"]
    if not kern:
        print(f"[train step] wall {wall * 1e3:.3f} ms; device time not "
              f"measured (the profiler saw no CUDA events)")
        return 0
    busy = sum(e.device_time for e in kern) / 1e3

    def share(keys) -> tuple:
        sel = [e for e in kern if any(k in e.name for k in keys)]
        return sum(e.device_time for e in sel) / 1e3 / busy, len(sel)

    parts = ", ".join(f"{name} {s:.4f} ({n})" for name, (s, n) in
                      ((k, share(v)) for k, v in GROUPS.items()))
    print(f"[train step] wall {wall * 1e3:.3f} ms, {tokens / wall:.1f} "
          f"tokens/s, kernels {len(kern)}, device busy {busy:.3f} ms, idle "
          f"share {1 - busy / (wall * 1e3):.4f}, peak memory "
          f"{peak / 2 ** 30:.3f} GiB; loss {float(m['loss']):.5f}")
    print(f"[train step] shares of busy (launches): {parts}")
    totals = {}
    for e in kern:
        t = totals.setdefault(e.name, [0, 0.0])
        t[0] += 1
        t[1] += e.device_time
    for name, (count, us) in sorted(totals.items(),
                                    key=lambda kv: -kv[1][1])[:12]:
        print(f"[train step]   {us / 1e3:9.4f} ms {count:5d} launches  "
              f"{name[:100]}")
    # AdamW alone on the step's gradients (the state moves on; this is a
    # profile), then head + CE alone on the step's last hidden states
    names, leaves = zip(*state.params.named_parameters())
    loss, _ = model.loss(state.params, batches[2])
    grads = dict(zip(names, torch.autograd.grad(loss, leaves)))
    del loss
    t_adam = event_ms(lambda: step_mod.apply_updates(
        state.params, grads, state.opt, ocfg))
    del grads
    if cfg.family in tf.DECODER_FAMILIES:
        with torch.no_grad():
            h, positions = tf.embed_in(state.params, cfg, batches[2])
            h, _, _ = tf.run_layers(state.params.layers, cfg, h, positions,
                                    mode="train")
    else:
        labels = batches[2]["labels"]
        h = torch.randn((*labels.shape, cfg.d_model), device="cuda").to(
            torch.bfloat16)
    h = h.detach().requires_grad_()
    t_head = event_ms(head_once(cfg, state.params, h, batches[2]["labels"]))
    print(f"[train step] alone: AdamW (global norm, clip, update) "
          f"{t_adam:.3f} ms, {t_adam / busy:.4f} of the step's busy time; "
          f"head + CE forward and backward {t_head:.3f} ms, "
          f"{t_head / busy:.4f}")
    return 0


if __name__ == "__main__":
    sys.exit(main())
