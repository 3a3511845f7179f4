"""Where the serving path's time goes on the card:
``python3 tools/profile_serve.py [--arch ARCH]``.

At the full width of ``--arch`` (qwen3-1.7b, the default; falcon-mamba-7b;
recurrentgemma-9b; random weights from seed 0), after warm-up,
torch.profiler (CPU and CUDA activities) over one prefill of 4 x 512 tokens
and over one decode step at position 575 of the decode cache
(``init_cache(4, 1024)``: a 1024-slot KV cache for qwen3, the recurrent
states and 2048-slot ring buffers for the others).  For each it prints:
the wall time of the step (ended by a synchronise), the CUDA kernels
launched, the device-busy time (the sum of kernel durations on the one
stream), the idle share, the shares of busy time of the attention kernels,
of the scan kernels (rglru_scan, mamba_scan), of the rmsnorm kernel, of
the casts to bf16 (the per-call f32 -> bf16 weight casts, with the norms'
and RoPE's casts of their f32 results back to bf16: one kernel,
``bfloat16_copy_kernel_cuda``) and of the other dtype conversions
(``direct_copy_kernel_cuda``: the bf16 -> f32 upcasts), and the kernels
that take the most device time.  Then the per-call weight casts alone:
every weight a forward casts, ``.to(bfloat16)``, timed with CUDA events
around back-to-back casts.  Needs a CUDA card.
"""
from __future__ import annotations

import argparse
import subprocess
import sys
import time
from pathlib import Path

import torch
from torch.profiler import ProfilerActivity, profile

sys.path.insert(0, str(Path(__file__).resolve().parents[1] / "src"))

from repro_torch.configs import get_config  # noqa: E402
from repro_torch.models import build_model  # noqa: E402

ARCHS = ("qwen3-1.7b", "falcon-mamba-7b", "recurrentgemma-9b")

B, PROMPT, CACHE, POS = 4, 512, 1024, 575


def report(label, step) -> None:
    step()                                   # warm-up
    torch.cuda.synchronize()
    with torch.inference_mode(), profile(
            activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as p:
        t0 = time.perf_counter()
        step()
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
    kern = [e for e in p.events() if e.device_type.name == "CUDA"]
    if not kern:
        print(f"[{label}] wall {wall * 1e3:.3f} ms; device time not "
              f"measured (the profiler saw no CUDA events)")
        return
    busy = sum(e.device_time for e in kern) / 1e3            # ms

    def share(*keys) -> float:
        return sum(e.device_time for e in kern
                   if any(k in e.name for k in keys)) / 1e3 / busy

    print(f"[{label}] wall {wall * 1e3:.3f} ms, kernels {len(kern)}, device "
          f"busy {busy:.3f} ms, idle share {1 - busy / (wall * 1e3):.4f}; "
          f"shares of busy: attention kernels "
          f"{share('flash_kernel', 'decode_kernel'):.4f}, scan kernels "
          f"{share('rglru_', 'mamba_scan_kernel'):.4f}, rmsnorm "
          f"{share('rmsnorm_kernel'):.4f}, casts to bf16 "
          f"{share('bfloat16_copy_kernel'):.4f}, other dtype conversions "
          f"{share('direct_copy_kernel'):.4f}")
    totals = {}
    for e in kern:
        t = totals.setdefault(e.name, [0, 0.0])
        t[0] += 1
        t[1] += e.device_time
    for name, (count, us) in sorted(totals.items(),
                                    key=lambda kv: -kv[1][1])[:10]:
        print(f"[{label}]   {us / 1e3:9.4f} ms {count:5d} launches  "
              f"{name[:100]}")


def cast_ms(params, reps=5) -> float:
    """Device time of casting every weight a forward casts (all of them:
    each layer's, the final norm's and the tied embedding) to bf16."""
    ws = list(params.parameters())

    def casts():
        for w in ws:
            w.to(torch.bfloat16)

    casts()
    a = torch.cuda.Event(enable_timing=True)
    b = torch.cuda.Event(enable_timing=True)
    torch.cuda.synchronize()
    a.record()
    for _ in range(reps):
        casts()
    b.record()
    b.synchronize()
    return a.elapsed_time(b) / reps


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--arch", choices=ARCHS, default=ARCHS[0])
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        print("profile_serve: no CUDA device", file=sys.stderr)
        return 2
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, check=True, timeout=60).stdout.strip()
    print(f"[device] {smi}; torch {torch.__version__}; {args.arch}")
    torch.backends.cuda.matmul.allow_tf32 = False
    cfg = get_config(args.arch)
    model = build_model(cfg)
    gen = torch.Generator(device="cuda").manual_seed(0)
    params = model.init(gen)
    prompt = torch.randint(0, cfg.vocab_size, (B, PROMPT), device="cuda",
                           generator=gen)
    with torch.inference_mode():
        report(f"prefill {B}x{PROMPT}",
               lambda: model.prefill(params, {"tokens": prompt}))
        caches = model.init_cache(B, CACHE)
        token = prompt[:, :1]
        report(f"decode step B={B} pos={POS} cache={CACHE}",
               lambda: model.decode_step(params, caches,
                                         {"token": token, "pos": POS}))
        nbytes = sum(p.numel() * p.element_size()
                     for p in params.parameters())
        t = cast_ms(params)
    print(f"[casts] f32 -> bf16 of all {nbytes / 1e9:.3f} GB of weights: "
          f"{t:.3f} ms per forward, {nbytes * 1.5 / (t * 1e-3) / 1e12:.3f} "
          f"TB/s moved (f32 read, bf16 written); bound "
          f"{nbytes * 1.5 / 3.35e12 * 1e3:.3f} ms at 3.35 TB/s")
    return 0


if __name__ == "__main__":
    sys.exit(main())
