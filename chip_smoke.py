"""Proof on the card that the PyTorch/CUDA port runs: ``python3 chip_smoke.py``.

Phases, one line or block of output each; any failure exits non-zero before
the last line, which is printed only when every phase passed:

1. device: the card's name and power limit (nvidia-smi), versions, and the
   build of every CUDA kernel library from ``src/repro_torch/kernels/csrc``
   into ``build/``, one nvcc per source, all started together;
2. the φ kernels against their plain PyTorch versions on the card
   (``torch.equal`` at every listed shape, sparse against dense where the
   lists cover the degree), then each kernel's device time over 50 launches
   after warm-up (torch.profiler: the median kernel duration), its plain
   version's device time, the wall time of one call with its host side
   (CUDA events), and the memory bound;
3. the simulator at the paper's scale: ``run_many`` on the default
   ``SwarmConfig`` (30 UAVs, 50 Monte-Carlo runs, dense): Greedy and
   Distributed at 100 s, the three other baselines at 20 s; then
   Distributed again with the plain φ version, which must give bit-identical
   metrics, and a small run on the CPU and the card that must agree;
4. the sparse path at scale: N = 4096, K = 16, R = 4, 2 s, Distributed;
5. the attention kernels against their plain versions on the card (flash
   at the shapes of tests/test_kernels.py, at the serving shape and at
   lengths that are not multiples of 128; decode likewise, at four cache
   positions), at 3e-5 in f32 and 2e-2 in bf16; then each kernel's median
   time over 50 launches after warm-up (CUDA events, one pair a launch) at
   the serving shapes, beside its bound, its plain version's time and
   ``scaled_dot_product_attention``'s (a yardstick the port never calls);
6. split-serve at the full width of qwen3-1.7b: ``launch.serve.serve`` with
   16 requests of 4 x 512 tokens, 4 executors and a burst of 8 (which fires
   the early exit), once with the kernels and once under
   ``ops.reference()``: counters, exit labels and records identical, logits
   within 5e-2 of the largest logit;
7. prefill of 4 x 512 tokens, its k/v copied into a 1024-slot cache, 64
   greedy decode steps; every step's logits held against ``forward`` over
   prompt and generated tokens, and against a teacher-forced rerun under
   ``ops.reference()``;
8. one JSON line describing every kernel, the nvidia-smi line, and the
   result line ``{"ok": true, "device": {...}}``.

Needs one CUDA card and nvcc; imports nothing of JAX or of ``repro``.
"""
from __future__ import annotations

import dataclasses
import json
import math
import statistics
import subprocess
import sys
import time
from pathlib import Path

import numpy as np
import torch
from torch.profiler import ProfilerActivity, profile

ROOT = Path(__file__).resolve().parent
sys.path.insert(0, str(ROOT / "src"))

HBM_BYTES_PER_S = 3.35e12           # H100 SXM HBM3
FP32_OPS_PER_S = 67e12              # H100 SXM, float32 outside tensor cores
BF16_OPS_PER_S = 989e12             # H100 SXM, bf16 tensor cores, dense
DENSE_SHAPES = [(50, 30), (4, 37), (2, 200), (4, 1024), (1, 4096)]
SPARSE_SHAPES = [(50, 30, 16), (4, 4096, 16), (2, 1000, 200), (1, 65536, 16)]
INDICES = ("throughput_tps", "avg_latency_s", "jain_fairness",
           "energy_per_task_j", "avg_accuracy", "completed", "generated",
           "transfers", "dropped")


def log(msg: str) -> None:
    print(msg, flush=True)


def check(cond: bool, what: str) -> None:
    if not cond:
        raise SystemExit(f"FAILED: {what}")


def nvidia_smi() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True, timeout=60)
    return out.stdout.strip().splitlines()[0]


# ---------------------------------------------------------------------------
# phase 2: kernels against their plain versions
# ---------------------------------------------------------------------------


def dense_inputs(R, N, gen, p=0.3):
    dev = "cuda"
    F = torch.rand(R, N, device=dev, generator=gen) * 400 + 100
    inv_phi = 1.0 / (torch.rand(R, N, device=dev, generator=gen) * 750 + 50)
    adj = torch.rand(R, N, N, device=dev, generator=gen) < p
    adj &= ~torch.eye(N, dtype=torch.bool, device=dev)
    adj[:, 0] = False                                   # an isolated node
    dtx = torch.where(adj, torch.rand(R, N, N, device=dev, generator=gen)
                      * 1e-2 + 1e-4, -1e30)
    return inv_phi, F, dtx


def sparse_inputs(R, N, K, gen):
    dev = "cuda"
    F = torch.rand(R, N, device=dev, generator=gen) * 400 + 100
    nbr = torch.randint(0, N, (R, N, K), device=dev, generator=gen,
                        dtype=torch.int32)
    ok = torch.rand(R, N, K, device=dev, generator=gen) < 0.6
    dtx = torch.where(ok, torch.rand(R, N, K, device=dev, generator=gen)
                      * 1e-2 + 1e-4, -1e30)
    return 1.0 / F, F, dtx, torch.where(ok, nbr, 0)


def device_ms(fn, args, reps=50, warmup=5) -> float:
    """Device time of one call from torch.profiler over ``reps`` calls after
    warm-up: (median kernel duration, when each call is one kernel; else
    the mean of the summed kernel durations per call, in ms).  The host
    side of a call (checks, allocation, launch) is not in it."""
    for _ in range(warmup):
        fn(*args)
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        for _ in range(reps):
            fn(*args)
        torch.cuda.synchronize()
    kern = [e.device_time for e in prof.events()
            if e.device_type.name == "CUDA"]
    check(len(kern) >= reps, f"the profiler saw {len(kern)} kernels for "
          f"{reps} calls")
    if len(kern) == reps:
        return statistics.median(kern) / 1e3
    return sum(kern) / reps / 1e3


def call_ms(fn, args, reps=50) -> float:
    """Wall time of one call, host included: CUDA events around ``reps``
    back-to-back calls."""
    a = torch.cuda.Event(enable_timing=True)
    b = torch.cuda.Event(enable_timing=True)
    a.record()
    for _ in range(reps):
        fn(*args)
    b.record()
    b.synchronize()
    return a.elapsed_time(b) / reps


def dense_bound_ms(R, N, ops=4) -> tuple:
    """Each input read once, the output written once; ops per (i, k):
    add, max, compare, count."""
    nbytes = 4 * (R * N * N + 3 * R * N)
    t_bytes = nbytes / HBM_BYTES_PER_S * 1e3
    t_ops = ops * R * N * N / FP32_OPS_PER_S * 1e3
    return max(t_bytes, t_ops), "bytes" if t_bytes >= t_ops else "operations"


def sparse_bound_ms(R, N, K, ops=4) -> tuple:
    nbytes = 4 * (2 * R * N * K + 3 * R * N)
    t_bytes = nbytes / HBM_BYTES_PER_S * 1e3
    t_ops = ops * R * N * K / FP32_OPS_PER_S * 1e3
    return max(t_bytes, t_ops), "bytes" if t_bytes >= t_ops else "operations"


def phase_kernels(K, ref, gen) -> dict:
    err = {"diffusive_phi": 0.0, "diffusive_phi_sparse": 0.0}
    for R, N in DENSE_SHAPES:
        args = dense_inputs(R, N, gen)
        got, want = K.diffusive_phi(*args), ref.diffusive_phi(*args)
        torch.cuda.synchronize()
        check(torch.equal(got, want), f"dense kernel != plain at {(R, N)}")
        err["diffusive_phi"] = max(err["diffusive_phi"],
                                   float((got - want).abs().max()))
    for R, N, Kk in SPARSE_SHAPES:
        args = sparse_inputs(R, N, Kk, gen)
        got, want = K.diffusive_phi_sparse(*args), \
            ref.diffusive_phi_sparse(*args)
        torch.cuda.synchronize()
        check(torch.equal(got, want),
              f"sparse kernel != plain at {(R, N, Kk)}")
        err["diffusive_phi_sparse"] = max(err["diffusive_phi_sparse"],
                                          float((got - want).abs().max()))
    # sparse == dense where the lists cover every link (K = N)
    inv_phi, F, dtx = dense_inputs(3, 50, gen)
    on = dtx > -5e29
    nbr = torch.arange(50, dtype=torch.int32, device="cuda").expand(
        3, 50, 50)
    sp = K.diffusive_phi_sparse(inv_phi, F, dtx,
                                torch.where(on, nbr, 0).contiguous())
    check(torch.equal(sp, K.diffusive_phi(inv_phi, F, dtx)),
          "sparse kernel != dense kernel on covering lists")
    log(f"[kernels] torch.equal to the plain versions at dense {DENSE_SHAPES}"
        f" and sparse {SPARSE_SHAPES}; sparse == dense on covering lists;"
        f" max_abs_err {err}")
    return err


def time_kernel(kern, plain, args, bound) -> dict:
    return {"ms": device_ms(kern, args), "plain_ms": device_ms(plain, args),
            "bound_ms": bound[0], "bound_by": bound[1], "library_ms": None,
            "call_ms": call_ms(kern, args)}


def phase_timing(K, ref, gen) -> dict:
    """Median kernel times at the main path's shapes (recorded in the JSON)
    and at larger ones (printed)."""
    out = {}
    for R, N in [(50, 30), (4, 1024), (1, 4096), (8, 4096)]:
        t = time_kernel(K.diffusive_phi, ref.diffusive_phi,
                        dense_inputs(R, N, gen), dense_bound_ms(R, N))
        log(f"[timing] diffusive_phi R={R} N={N}: kernel {t['ms']:.5f} ms, "
            f"plain {t['plain_ms']:.5f} ms, bound {t['bound_ms']:.6f} ms "
            f"({t['bound_by']}), {t['bound_ms'] / t['ms']:.3f} of bound; "
            f"one call with its host side {t['call_ms']:.5f} ms")
        out.setdefault("diffusive_phi", t)
    for R, N, Kk in [(4, 4096, 16), (1, 65536, 16), (2, 1000, 200)]:
        t = time_kernel(K.diffusive_phi_sparse, ref.diffusive_phi_sparse,
                        sparse_inputs(R, N, Kk, gen),
                        sparse_bound_ms(R, N, Kk))
        log(f"[timing] diffusive_phi_sparse R={R} N={N} K={Kk}: kernel "
            f"{t['ms']:.5f} ms, plain {t['plain_ms']:.5f} ms, bound "
            f"{t['bound_ms']:.6f} ms ({t['bound_by']}), "
            f"{t['bound_ms'] / t['ms']:.3f} of bound; one call with its host "
            f"side {t['call_ms']:.5f} ms")
        out.setdefault("diffusive_phi_sparse", t)
    return out


# ---------------------------------------------------------------------------
# phases 3 and 4: the simulator
# ---------------------------------------------------------------------------


def summary(m: dict) -> str:
    return " ".join(f"{k}={float(m[k].float().mean()):.6g}" for k in INDICES)


def check_metrics(m: dict, runs: int, what: str) -> None:
    for k, v in m.items():
        check(v.shape == (runs,) and v.dtype == torch.float32,
              f"{what}: {k} has shape {tuple(v.shape)} / {v.dtype}")
        check(bool(torch.isfinite(v).all()), f"{what}: {k} not finite")
    check(bool((m["completed"] <= m["generated"]).all()),
          f"{what}: completed > generated")
    check(bool((m["transfers_delivered"] <= m["transfers"]).all()),
          f"{what}: delivered > initiated")


# the three baselines that neither use φ nor decide per neighbour run at
# 20 s, to leave the serving phases room in the time limit
SHORT_STRATEGIES = {"LocalOnly": 20.0, "Random": 20.0, "RandomAcyclic": 20.0}


def phase_main_path(S, rng, ops, K, SwarmConfig) -> dict:
    cfg = SwarmConfig()
    n, runs = cfg.num_workers, cfg.num_runs
    key = rng.PRNGKey(0)
    results = {}
    n_epochs = 0
    K.reset_launches()
    for s, name in enumerate(S.STRATEGY_NAMES):
        c = dataclasses.replace(
            cfg, sim_time_s=SHORT_STRATEGIES.get(name, cfg.sim_time_s))
        n_epochs += round(c.sim_time_s / c.decision_period_s)
        t0 = time.perf_counter()
        m = S.run_many(key, c, s, n, runs)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        check_metrics(m, runs, name)
        results[name] = m
        log(f"[main] {name}: {runs} runs x {c.sim_time_s:g} s, N={n}: "
            f"wall {wall:.2f} s; {summary(m)}")
    launches = dict(K.LAUNCHES)
    check(bool((results["LocalOnly"]["transfers"] == 0).all()),
          "LocalOnly made transfers")
    check(launches["diffusive_phi"] == n_epochs,
          f"dense kernel launched {launches['diffusive_phi']} times, "
          f"expected {n_epochs}")
    t0 = time.perf_counter()
    with ops.reference():
        plain = S.run_many(key, cfg, S.DISTRIBUTED, n, runs)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    for k, v in results["Distributed"].items():
        check(torch.equal(v, plain[k]),
              f"Distributed {k}: kernel path != plain path")
    log(f"[main] Distributed with the plain φ version: bit-identical on all "
        f"{len(plain)} metrics (wall {wall:.2f} s); kernel launches on the "
        f"main path {launches}")
    # the same small input on the CPU and on the card: the two devices'
    # sin/cos/log/pow differ in the last ulp, which can move an event
    # across a threshold, so the means over runs agree within 2 %
    small = dataclasses.replace(cfg, num_workers=12, queue_slots=16,
                                sim_time_s=3.0)
    cpu = S.run_many(key, small, S.DISTRIBUTED, 12, 3, device="cpu")
    gpu = S.run_many(key, small, S.DISTRIBUTED, 12, 3)
    exact = all(torch.equal(cpu[k], gpu[k].cpu()) for k in cpu)
    for k in cpu:
        c, g = float(cpu[k].double().mean()), float(gpu[k].double().mean())
        check(math.isclose(c, g, rel_tol=2e-2, abs_tol=1e-6),
              f"cpu vs card {k}: {c} vs {g}")
    log("[main] small input (N=12, 3 runs, 3 s, Distributed): CPU and card "
        "agree " + ("bit for bit" if exact else "within 2 % (not bit for "
                    "bit)") + f"; {summary(gpu)}")
    return launches


def phase_sparse(S, rng, K, SwarmConfig) -> dict:
    n, runs = 4096, 4
    cfg = dataclasses.replace(SwarmConfig(), num_workers=n, neighbor_k=16,
                              neighbor_mode="sparse", sim_time_s=2.0)
    torch.cuda.reset_peak_memory_stats()
    K.reset_launches()
    t0 = time.perf_counter()
    m = S.run_many(rng.PRNGKey(0), cfg, S.DISTRIBUTED, n, runs)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    launches = dict(K.LAUNCHES)
    check_metrics(m, runs, "sparse")
    n_epochs = round(cfg.sim_time_s / cfg.decision_period_s)
    check(launches["diffusive_phi_sparse"] == n_epochs,
          f"sparse kernel launched {launches['diffusive_phi_sparse']} times")
    peak = torch.cuda.max_memory_allocated() / 2 ** 30
    log(f"[sparse] N={n} K=16 R={runs} {cfg.sim_time_s:g} s Distributed: "
        f"wall {wall:.2f} s, peak {peak:.2f} GiB; {summary(m)}; kernel "
        f"launches {launches}")
    return launches


# ---------------------------------------------------------------------------
# phase 5: attention kernels against their plain versions
# ---------------------------------------------------------------------------

SERVE_FLASH = (4, 512, 16, 8, 128)            # B, S, Hq, Hkv, hd (bf16)
SERVE_DECODE = (4, 1024, 16, 8, 128)          # B, S, Hq, Hkv, hd (bf16)
FLASH_SHAPES = [  # B, S, Hq, Hkv, hd, causal, window, dtype
    (2, 128, 4, 2, 64, True, 0, torch.float32),   # tests/test_kernels.py
    (1, 256, 8, 1, 128, True, 0, torch.bfloat16),
    (2, 128, 4, 4, 64, False, 0, torch.float32),
    (1, 256, 4, 2, 64, True, 64, torch.float32),
    (1, 128, 2, 2, 256, True, 0, torch.bfloat16),
    (*SERVE_FLASH, True, 0, torch.bfloat16),      # the serving path
    (4, 200, 16, 8, 128, True, 0, torch.bfloat16),  # not multiples of 128
    (4, 1000, 16, 8, 128, True, 0, torch.bfloat16),
]
DECODE_SHAPES = [  # B, S, Hq, Hkv, hd, pos, window, dtype
    (2, 256, 8, 2, 64, 100, 0, torch.float32),    # tests/test_kernels.py
    (1, 512, 4, 1, 128, 511, 0, torch.bfloat16),
    (2, 256, 4, 4, 64, 200, 64, torch.float32),
] + [(*SERVE_DECODE, pos, 0, torch.bfloat16) for pos in (0, 511, 575, 1023)]


def attn_tol(dtype) -> float:
    """tests/test_kernels.py: rtol = atol = 2e-2 in bf16, 3e-5 in f32."""
    return 2e-2 if dtype == torch.bfloat16 else 3e-5


def attn_inputs(q_shape, kv_shape, dtype, gen):
    return [torch.randn(s, device="cuda", generator=gen).to(dtype)
            for s in (q_shape, kv_shape, kv_shape)]


def assert_close(got, want, tol, what, atol=None) -> float:
    """allclose at rtol = tol and atol (default tol); returns the max abs
    error."""
    atol = tol if atol is None else atol
    got, want = got.float(), want.float()
    err = (got - want).abs()
    bad = int((err > atol + tol * want.abs()).sum())
    check(bad == 0 and bool(torch.isfinite(got).all()),
          f"{what}: {bad} elements beyond rtol={tol} atol={atol:.3g} (max "
          f"abs err {float(err.max()):.3g})")
    return float(err.max())


def phase_attention(FA, DA, ref, gen) -> dict:
    err = {"flash_attention": 0.0, "decode_attention": 0.0}
    for B, S, Hq, Hkv, hd, causal, win, dt in FLASH_SHAPES:
        q, k, v = attn_inputs((B, S, Hq, hd), (B, S, Hkv, hd), dt, gen)
        got = FA.flash_attention(q, k, v, causal=causal, window=win)
        want = ref.flash_attention(q, k, v, causal=causal, window=win)
        torch.cuda.synchronize()
        e = assert_close(got, want, attn_tol(dt), f"flash at "
                         f"{(B, S, Hq, Hkv, hd, causal, win, dt)}")
        err["flash_attention"] = max(err["flash_attention"], e)
    for B, S, Hq, Hkv, hd, pos, win, dt in DECODE_SHAPES:
        q, k, v = attn_inputs((B, Hq, hd), (B, S, Hkv, hd), dt, gen)
        got = DA.decode_attention(q, k, v, pos, window=win)
        want = ref.decode_attention(q, k, v, pos, window=win)
        torch.cuda.synchronize()
        e = assert_close(got, want, attn_tol(dt), f"decode at "
                         f"{(B, S, Hq, Hkv, hd, pos, win, dt)}")
        err["decode_attention"] = max(err["decode_attention"], e)
    log(f"[attention] kernels match their plain versions (rtol=atol 3e-5 "
        f"f32, 2e-2 bf16) at flash {[x[:7] for x in FLASH_SHAPES]} and "
        f"decode {[x[:7] for x in DECODE_SHAPES]}; max_abs_err {err}")
    return err


def event_ms(fn, reps=50, warmup=5) -> float:
    """Median device time of one call: each of ``reps`` calls after warm-up
    between its own pair of CUDA events.  A sleep kernel first lets the
    host queue every call before the device reaches them, so the host's
    launch time stays out of the pairs."""
    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    pairs = [(torch.cuda.Event(enable_timing=True),
              torch.cuda.Event(enable_timing=True)) for _ in range(reps)]
    torch.cuda._sleep(100_000_000)
    for a, b in pairs:
        a.record()
        fn()
        b.record()
    torch.cuda.synchronize()
    return statistics.median(a.elapsed_time(b) for a, b in pairs)


def roofline_ms(nbytes: float, ops: float, rate: float) -> tuple:
    t_bytes = nbytes / HBM_BYTES_PER_S * 1e3
    t_ops = ops / rate * 1e3
    return max(t_bytes, t_ops), "bytes" if t_bytes >= t_ops else "operations"


def flash_bound_ms(B, S, Hq, Hkv, hd, elt=2, rate=BF16_OPS_PER_S) -> tuple:
    """q, k, v read once, the output written once; 4·hd flops for each
    (query, key) pair that the causal mask keeps."""
    nbytes = elt * (2 * B * S * Hq * hd + 2 * B * S * Hkv * hd)
    pairs = B * Hq * S * (S + 1) // 2
    return roofline_ms(nbytes, 4 * hd * pairs, rate)


def decode_bound_ms(B, S, Hq, Hkv, hd, pos, elt=2,
                    rate=BF16_OPS_PER_S) -> tuple:
    """q read and the output written once, the kept K and V rows (slots
    0..pos) read once; 4·hd flops a (query head, kept slot)."""
    kept = min(pos, S - 1) + 1
    nbytes = elt * (2 * B * Hq * hd + 2 * B * kept * Hkv * hd)
    return roofline_ms(nbytes, 4 * hd * B * Hq * kept, rate)


def phase_attention_timing(FA, DA, ref, gen) -> dict:
    """Kernel, plain version and SDPA at the serving shapes (bf16)."""
    sdpa = torch.nn.functional.scaled_dot_product_attention
    B, S, Hq, Hkv, hd = SERVE_FLASH
    q, k, v = attn_inputs((B, S, Hq, hd), (B, S, Hkv, hd), torch.bfloat16,
                          gen)
    qt, kt, vt = (x.transpose(1, 2).contiguous() for x in (q, k, v))
    lib_out = sdpa(qt, kt, vt, is_causal=True, enable_gqa=True)
    assert_close(lib_out.transpose(1, 2), FA.flash_attention(q, k, v), 2e-2,
                 "SDPA yardstick against the flash kernel")
    bound = flash_bound_ms(B, S, Hq, Hkv, hd)
    out = {"flash_attention": {
        "ms": event_ms(lambda: FA.flash_attention(q, k, v)),
        "plain_ms": event_ms(lambda: ref.flash_attention(q, k, v)),
        "bound_ms": bound[0], "bound_by": bound[1],
        "library_ms": event_ms(lambda: sdpa(qt, kt, vt, is_causal=True,
                                            enable_gqa=True))}}
    B, S, Hq, Hkv, hd = SERVE_DECODE
    q, k, v = attn_inputs((B, Hq, hd), (B, S, Hkv, hd), torch.bfloat16, gen)
    for pos in (1023, 575):
        q4 = q[:, :, None, :]
        kt, vt = (x[:, :pos + 1].transpose(1, 2).contiguous()
                  for x in (k, v))
        lib_out = sdpa(q4, kt, vt, enable_gqa=True)
        assert_close(lib_out[:, :, 0], DA.decode_attention(q, k, v, pos),
                     2e-2, "SDPA yardstick against the decode kernel")
        bound = decode_bound_ms(B, S, Hq, Hkv, hd, pos)
        t = {"ms": event_ms(lambda p=pos: DA.decode_attention(q, k, v, p)),
             "plain_ms": event_ms(lambda p=pos: ref.decode_attention(
                 q, k, v, p)),
             "bound_ms": bound[0], "bound_by": bound[1],
             "library_ms": event_ms(lambda a=kt, b=vt: sdpa(
                 q4, a, b, enable_gqa=True))}
        log(f"[timing] decode_attention B={B} S={S} Hq={Hq} Hkv={Hkv} "
            f"hd={hd} pos={pos} bf16: kernel {t['ms']:.5f} ms, plain "
            f"{t['plain_ms']:.5f} ms, SDPA {t['library_ms']:.5f} ms, bound "
            f"{t['bound_ms']:.6f} ms ({t['bound_by']}), "
            f"{t['bound_ms'] / t['ms']:.3f} of bound")
        out.setdefault("decode_attention", t)
    t = out["flash_attention"]
    log(f"[timing] flash_attention B={SERVE_FLASH[0]} S={SERVE_FLASH[1]} "
        f"Hq={SERVE_FLASH[2]} Hkv={SERVE_FLASH[3]} hd={SERVE_FLASH[4]} "
        f"causal bf16: kernel {t['ms']:.5f} ms, plain {t['plain_ms']:.5f} ms,"
        f" SDPA {t['library_ms']:.5f} ms, bound {t['bound_ms']:.6f} ms "
        f"({t['bound_by']}), {t['bound_ms'] / t['ms']:.3f} of bound")
    return out


# ---------------------------------------------------------------------------
# phases 6 and 7: serving qwen3-1.7b at full width
# ---------------------------------------------------------------------------

SERVE_ARGS = dict(requests=16, batch=4, seq=512, executors=4, burst=8)


def rel_err(a: torch.Tensor, b: torch.Tensor) -> float:
    """max |a - b| over max |b|."""
    a, b = a.float(), b.float()
    return float((a - b).abs().max() / b.abs().max())


def phase_serve(cfg, params, serve, schema, ops, KB) -> dict:
    torch.cuda.reset_peak_memory_stats()
    KB.reset_launches()
    run = serve(cfg, **SERVE_ARGS, params=params)
    launches = dict(KB.LAUNCHES)
    st = run.engine.stats
    peak = torch.cuda.max_memory_allocated() / 2 ** 30
    rows = (SERVE_ARGS["requests"] + SERVE_ARGS["burst"]) * \
        SERVE_ARGS["batch"]
    log(f"[serve] capabilities {np.round(run.F, 1).tolist()}; φ "
        f"{np.round(run.plan.phi, 1).tolist()}; stage boundaries "
        f"{run.plan.boundaries}, executors {run.plan.executors}")
    log(f"[serve] {cfg.name} full width, {SERVE_ARGS}: completed "
        f"{st.completed} sequences, exit labels {st.exit_counts}, avg "
        f"latency {st.avg_latency * 1e3:.1f} epoch-ms, wall "
        f"{run.wall_s:.3f} s ({st.completed / run.wall_s:.2f} seq/s), peak "
        f"memory {peak:.2f} GiB; kernel launches {launches}")
    check(st.completed == rows, f"completed {st.completed} != {rows}")
    check(st.exit_counts[1] + st.exit_counts[2] > 0,
          "the burst did not fire the early exit")
    layers_run = st.records[:, schema.LAYERS].sum() / SERVE_ARGS["batch"]
    check(launches["flash_attention"] == layers_run,
          f"flash launched {launches['flash_attention']} times, stages ran "
          f"{layers_run} layers")
    check(launches["decode_attention"] == 0, "serving launched decode")
    for rid, lg in run.engine.results.items():
        check(lg.shape == (SERVE_ARGS["batch"], SERVE_ARGS["seq"],
                           cfg.vocab_size) and bool(torch.isfinite(lg).all()),
              f"request {rid}: logits {tuple(lg.shape)} not finite")
    results, kernel_stats = run.engine.results, st
    del run
    with ops.reference():
        plain = serve(cfg, **SERVE_ARGS, params=params)
    ps = plain.engine.stats
    check(ps.completed == kernel_stats.completed and
          ps.exit_counts == kernel_stats.exit_counts,
          "plain path: counters differ")
    check(np.array_equal(ps.records, kernel_stats.records) and
          np.array_equal(ps.state_records, kernel_stats.state_records),
          "plain path: records differ")
    err = max(rel_err(results[rid], lg)
              for rid, lg in plain.engine.results.items())
    log(f"[serve] under ops.reference(): counters, exit labels and records "
        f"identical; stashed logits differ by {err:.4g} of the largest "
        f"(limit 5e-2); plain wall {plain.wall_s:.3f} s")
    check(err <= 5e-2, f"serve logits: kernel vs plain {err:.4g} > 5e-2")
    del plain, results
    torch.cuda.empty_cache()
    return launches


DECODE_B, PROMPT, STEPS, CACHE = 4, 512, 64, 1024


def logits_close(got, want, what) -> float:
    """The bf16 tolerance of tests/test_models_smoke.py (2e-2), with atol
    scaled by max(1, max |want|); returns max |got - want|."""
    scale = max(1.0, float(want.float().abs().max()))
    return assert_close(got, want, 2e-2, what, atol=2e-2 * scale)


def decode_run(model, params, prompt, steps, forced=None):
    """Prefill, copy the k/v into a CACHE-slot cache, decode ``steps``
    tokens: greedily, or the ``forced`` ones.  Returns (logits per step,
    starting with the prefill's last, tokens fed, prefill s, decode s)."""
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    last, pc = model.prefill(params, {"tokens": prompt})
    torch.cuda.synchronize()
    t1 = time.perf_counter()
    caches = model.init_cache(prompt.shape[0], CACHE)
    for name in ("k", "v"):
        caches[name][:, :, :prompt.shape[1]] = pc[name]
    del pc
    out, fed, logits = [last], [], last
    for t in range(steps):
        nxt = logits.argmax(-1)[:, None] if forced is None \
            else forced[:, t:t + 1]
        fed.append(nxt)
        logits, caches = model.decode_step(
            params, caches, {"token": nxt, "pos": prompt.shape[1] + t})
        out.append(logits)
    torch.cuda.synchronize()
    kv_bytes = sum(c.numel() * c.element_size() for c in caches.values())
    return (torch.stack(out, 1), torch.cat(fed, 1), t1 - t0,
            time.perf_counter() - t1, kv_bytes)


def phase_decode(cfg, params, build_model, ops, KB, gen) -> dict:
    model = build_model(cfg)
    prompt = torch.randint(0, cfg.vocab_size, (DECODE_B, PROMPT),
                           device=params.embed.device, generator=gen)
    with torch.inference_mode():
        decode_run(model, params, prompt[:, :128], 2)       # warm-up
        KB.reset_launches()
        logits, fed, t_pre, t_dec, kv_bytes = decode_run(model, params,
                                                         prompt, STEPS)
        launches = dict(KB.LAUNCHES)
        L = cfg.num_layers
        log(f"[decode] {cfg.name} full width: prefill {DECODE_B} x {PROMPT} "
            f"in {t_pre:.4f} s ({DECODE_B * PROMPT / t_pre:.1f} tokens/s), "
            f"{STEPS} greedy steps in {t_dec:.4f} s "
            f"({DECODE_B * STEPS / t_dec:.1f} tokens/s), KV cache "
            f"{kv_bytes / 1e6:.1f} MB; kernel launches {launches}")
        check(launches["flash_attention"] == L,
              f"prefill launched flash {launches['flash_attention']} times")
        check(launches["decode_attention"] == L * STEPS,
              f"decode launched {launches['decode_attention']} times")
        full = model.forward(params, {"tokens": torch.cat([prompt, fed],
                                                          1)})[0]
        want = full[:, PROMPT - 1:]
        del full
        errs = [logits_close(logits[:, t], want[:, t],
                             f"decode step {t} vs forward")
                for t in range(STEPS + 1)]
        log(f"[decode] every step's logits match forward over prompt + "
            f"generated tokens: max abs err {max(errs):.4g} (step 0 "
            f"{errs[0]:.4g}, {STEPS // 2} {errs[STEPS // 2]:.4g}, {STEPS} "
            f"{errs[STEPS]:.4g}); max |logit| "
            f"{float(want.float().abs().max()):.4g}")
        with ops.reference():
            plain = decode_run(model, params, prompt, STEPS, forced=fed)[0]
        perr = [logits_close(logits[:, t], plain[:, t],
                             f"decode step {t} vs the plain path")
                for t in range(STEPS + 1)]
        log(f"[decode] teacher-forced under ops.reference(): per-step max "
            f"abs logits difference {[round(e, 5) for e in perr[::8]]} "
            f"(every 8th step), max {max(perr):.4g}")
    return launches


def main() -> int:
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device; nothing was run", file=sys.stderr)
        return 2
    from repro_torch import rng
    from repro_torch.configs import SwarmConfig, get_config
    from repro_torch.kernels import build as KB
    from repro_torch.kernels import decode_attention as DA
    from repro_torch.kernels import diffusive_phi as K
    from repro_torch.kernels import flash_attention as FA
    from repro_torch.kernels import ops, ref
    from repro_torch.launch.serve import serve
    from repro_torch.models import build_model
    from repro_torch.swarm import simulator as S
    from repro_torch.trace import schema

    smi = nvidia_smi()
    log(f"[device] {smi}; {torch.cuda.get_device_name(0)}; torch "
        f"{torch.__version__} CUDA {torch.version.cuda}; python "
        f"{sys.version.split()[0]}")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    t0 = time.perf_counter()
    libs = KB.build_all([K.LIB, FA.LIB, DA.LIB])
    log(f"[build] {[str(p.relative_to(ROOT)) for p in libs]} in "
        f"{time.perf_counter() - t0:.2f} s, one nvcc per source")
    for lib in (K.LIB, FA.LIB, DA.LIB):
        report = lib.report().splitlines()
        regs = sorted({int(ln.split("Used ")[1].split()[0]) for ln in report
                       if "registers" in ln})
        spills = [ln.strip() for ln in report if "spill" in ln
                  and not ln.strip().startswith("0 bytes stack frame, 0 bytes "
                                                "spill stores, 0 bytes spill")]
        log(f"[build] {lib.source.name}: ptxas registers per thread {regs}; "
            f"spills: {spills or 'none'}")

    gen = torch.Generator(device="cuda").manual_seed(0)
    err = phase_kernels(K, ref, gen)
    timing = phase_timing(K, ref, gen)
    main_launches = phase_main_path(S, rng, ops, K, SwarmConfig)
    sparse_launches = phase_sparse(S, rng, K, SwarmConfig)
    err.update(phase_attention(FA, DA, ref, gen))
    timing.update(phase_attention_timing(FA, DA, ref, gen))

    cfg = get_config("qwen3-1.7b")
    t0 = time.perf_counter()
    params = build_model(cfg).init(torch.Generator(device="cuda")
                                   .manual_seed(0))
    torch.cuda.synchronize()
    log(f"[serve] {cfg.name}: {sum(p.numel() for p in params.parameters())} "
        f"parameters ({cfg.param_dtype}, compute {cfg.compute_dtype}) "
        f"initialised on the card in {time.perf_counter() - t0:.2f} s")
    serve_launches = phase_serve(cfg, params, serve, schema, ops, KB)
    decode_launches = phase_decode(cfg, params, build_model, ops, KB, gen)

    kernels = []
    for name, source, line, launches in (
            ("diffusive_phi", "diffusive_phi", "diffusive_phi.py:62",
             main_launches["diffusive_phi"]),
            ("diffusive_phi_sparse", "diffusive_phi", "diffusive_phi.py:121",
             sparse_launches["diffusive_phi_sparse"]),
            ("flash_attention", "flash_attention", "flash_attention.py:77",
             serve_launches["flash_attention"]
             + decode_launches["flash_attention"]),
            ("decode_attention", "decode_attention",
             "decode_attention.py:65", decode_launches["decode_attention"])):
        kernels.append({
            "name": name, "route": "cuda",
            "source": f"src/repro_torch/kernels/csrc/{source}.cu",
            "replaces": f"src/repro/kernels/{line}",
            "launches": launches, "max_abs_err": err[name],
            **{k: v for k, v in timing[name].items() if k != "call_ms"}})
    check(all(math.isfinite(k["ms"]) for k in kernels), "kernel timing")
    print(json.dumps({"kernels": kernels}))
    print(smi)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
