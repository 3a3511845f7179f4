"""Proof on the card that the PyTorch/CUDA port runs: ``python3 chip_smoke.py``.

Phases, one line or block of output each; any failure exits non-zero before
the last line, which is printed only when every phase passed:

1. device: the card's name and power limit (nvidia-smi), versions, and the
   build of the CUDA kernels from ``src/repro_torch/kernels/csrc`` into
   ``build/``;
2. kernels against their plain PyTorch versions on the card (``torch.equal``
   at every listed shape, sparse against dense where the lists cover the
   degree), then each kernel's device time over 50 launches after warm-up
   (torch.profiler: the median kernel duration), its plain version's device
   time, the wall time of one call with its host side (CUDA events), and
   the memory bound;
3. the main path at the paper's scale: ``run_many`` on the default
   ``SwarmConfig`` (30 UAVs, 50 Monte-Carlo runs, 100 s, dense) for all
   five strategies, then Distributed again with the plain φ version, which
   must give bit-identical metrics, and a small run on the CPU and the card
   that must agree;
4. the sparse path at scale: N = 4096, K = 16, R = 4, 2 s, Distributed;
5. one JSON line describing every kernel, the nvidia-smi line, and the
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

import torch
from torch.profiler import ProfilerActivity, profile

ROOT = Path(__file__).resolve().parent
sys.path.insert(0, str(ROOT / "src"))

HBM_BYTES_PER_S = 3.35e12           # H100 SXM HBM3
FP32_OPS_PER_S = 67e12              # H100 SXM, float32 outside tensor cores
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


def phase_main_path(S, rng, ops, K, SwarmConfig) -> dict:
    cfg = SwarmConfig()
    n, runs = cfg.num_workers, cfg.num_runs
    key = rng.PRNGKey(0)
    results = {}
    K.reset_launches()
    for s, name in enumerate(S.STRATEGY_NAMES):
        t0 = time.perf_counter()
        m = S.run_many(key, cfg, s, n, runs)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        check_metrics(m, runs, name)
        results[name] = m
        log(f"[main] {name}: {runs} runs x {cfg.sim_time_s:g} s, N={n}: "
            f"wall {wall:.2f} s; {summary(m)}")
    launches = dict(K.LAUNCHES)
    check(bool((results["LocalOnly"]["transfers"] == 0).all()),
          "LocalOnly made transfers")
    n_epochs = round(cfg.sim_time_s / cfg.decision_period_s)
    check(launches["diffusive_phi"] == 5 * n_epochs,
          f"dense kernel launched {launches['diffusive_phi']} times, "
          f"expected {5 * n_epochs}")
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


def main() -> int:
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device; nothing was run", file=sys.stderr)
        return 2
    from repro_torch import rng
    from repro_torch.configs import SwarmConfig
    from repro_torch.kernels import diffusive_phi as K
    from repro_torch.kernels import ops, ref
    from repro_torch.swarm import simulator as S

    smi = nvidia_smi()
    log(f"[device] {smi}; {torch.cuda.get_device_name(0)}; torch "
        f"{torch.__version__} CUDA {torch.version.cuda}; python "
        f"{sys.version.split()[0]}")
    t0 = time.perf_counter()
    lib = K.build()
    log(f"[build] {lib.relative_to(ROOT)} in {time.perf_counter() - t0:.2f} s")

    gen = torch.Generator(device="cuda").manual_seed(0)
    err = phase_kernels(K, ref, gen)
    timing = phase_timing(K, ref, gen)
    main_launches = phase_main_path(S, rng, ops, K, SwarmConfig)
    sparse_launches = phase_sparse(S, rng, K, SwarmConfig)

    kernels = []
    for name, line, launches in (
            ("diffusive_phi", 62, main_launches["diffusive_phi"]),
            ("diffusive_phi_sparse", 121,
             sparse_launches["diffusive_phi_sparse"])):
        kernels.append({
            "name": name, "route": "cuda",
            "source": "src/repro_torch/kernels/csrc/diffusive_phi.cu",
            "replaces": f"src/repro/kernels/diffusive_phi.py:{line}",
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
