"""Proof on the card that the PyTorch/CUDA port runs: ``python3 chip_smoke.py``.

Phases, one line or block of output each; any failure exits non-zero before
the last line, which is printed only when every phase passed:

1. device: the card's name and power limit (nvidia-smi), versions, and the
   build of every CUDA kernel library from ``src/repro_torch/kernels/csrc``
   into ``build/``, one nvcc per source, all started together;
2. the φ kernels against their plain PyTorch versions on the card
   (``torch.equal`` at every listed shape, sparse against dense where the
   lists cover the degree; the fused updates ``phi_update`` and
   ``phi_update_sparse`` against their plain twins and against the op
   chains they replaced, with the kernels and under ``ops.reference()``,
   and the simulator's ``phi_update_op`` and ``phi_update_op_sparse`` one
   device launch each); all four launchers on inputs with NaN, +inf and
   -inf delays, NaN delays off-link only, and φ = 0, -0 and inf, equal to
   their plain versions NaN for NaN; then each kernel's device time over 50
   launches after warm-up (torch.profiler: the median kernel duration), its
   plain version's device time, the wall time of one call with its host
   side (CUDA events), and the memory bound; each fused update beside its
   chain's device time, launches and call time;
3. the simulator at the paper's scale: ``run_many`` on the default
   ``SwarmConfig`` (30 UAVs, 50 Monte-Carlo runs, dense): Distributed at
   100 s, the four baselines at 20 s, one ``phi_update`` launch an epoch;
   then Distributed at 20 s, with the kernel and with the plain φ
   version, which must give bit-identical metrics, and a small run on the
   CPU and the card that must agree;
4. the sparse path at scale: N = 4096, K = 16, R = 4, 2 s, Distributed,
   one ``phi_update_sparse`` launch an epoch; its indices bit-identical to
   the plain path's and to those of the op chain it replaced (the
   Pallas-contract ``diffusive_phi_sparse`` kernel between torch ops);
4b. the fleet sweep path (``repro_torch.fleet``): fig 3's grid
   (benchmarks/fig3_gamma.py: six γ, 30 UAVs, Distributed, 4 runs, seed 0)
   through ``execute(backend="vmap")`` into a result store, at 10 s; its
   γ = 0.02 point again through ``streaming`` (chunk 3) and ``sharded``,
   killed after one chunk and resumed, and as a store hit, all
   ``torch.equal`` to vmap; the grid over two spawned workers on the card,
   whose report is byte-identical to the single process's; one
   ``phi_update`` launch an epoch of every computed point; then the γ =
   0.02 point at its full 100 s, its indices against the 95 % CIs of the
   reference artifact (``benchmarks/artifacts/BENCH_fleet.json``,
   ``sweep:fig3_gamma``) and against the same point run on the CPU;
4c. the telemetry streams and the last two channels: the default
   ``SwarmConfig`` (30 UAVs, 50 runs) with all three streams on
   (Distributed at 20 s, Greedy at 10 s): every trace leaf ``torch.equal``
   between the kernel path and ``ops.reference()``, every untraced metric
   ``torch.equal`` to an untraced run, one ``phi_update`` an epoch, the
   records accounting for every finished task and delivery, the report's
   traced sections; capacities that overflow, counted exactly; the CPU
   against the card (phase 3's rule); the backends (streaming killed after
   one chunk and resumed, sharded, a store hit) equal to vmap with
   byte-identical reports; ``log_normal_corr`` and ``nakagami`` at the
   default point and ``nakagami_edges`` on the sparse path (N = 4096, task
   and hop streams on), kernel path ``torch.equal`` to the plain path; the
   artifact's ``sweep:fig_state`` point printed beside the artifact's (a
   record); the wall and kernels an epoch, traced against untraced;
5. the attention kernels against their plain versions on the card (flash
   at the shapes of tests/test_kernels.py, at the serving shapes of qwen3,
   recurrentgemma, granite-moe (head_dim 64) and qwen2-vl (12 query heads
   on 2 kv heads), with a window that bites, at every head_dim in bf16
   and at lengths that are not multiples of 128, and at whisper's
   non-causal encoder (1500 frames) and cross attention (Sq != Sk); decode
   likewise, at cache positions on the boundaries of its split plan and
   at whisper's cross decode), at 3e-5 in f32 and 2e-2
   in bf16; two launches of each kernel, and 50 of decode, give equal
   outputs; then what the events read around an empty launch, and each
   kernel's median time over 50 launches after warm-up (CUDA events, one
   pair a launch) at the serving shapes (decode also at granite-moe's and
   qwen2-vl's caches; flash at whisper's encoder and cross attention, and
   its cross decode), L2-warm and L2-cold (``cold_ms``:
   256 MB written before each launch, outside its events), beside its
   bound, its plain version's time and
   ``scaled_dot_product_attention``'s, warm and cold (a yardstick the port
   never calls); the decode kernel's partial entry point (the distributed
   flash-decode's) against its plain twin at decode_32k's per-device slice
   (8, 2048, 16, 8, 128) bf16, over a kept range inside the slice, all of
   it and none (o = 0, m = -inf, l = 0), 50 launches equal; an emulated
   16-rank flash-decode (16 slices through the partial kernel, combined
   in rank order) against the whole-cache kernel and the plain path at
   (4, 1024, 16, 8, 128) pos 1023 and (8, 32768, 16, 8, 128) pos 32767;
   the partial timed beside its twin, its bound and the efficient SDPA
   kernel with its log-sum-exp;
6. split-serve at the full width of qwen3-1.7b: ``launch.serve.serve`` with
   16 requests of 4 x 512 tokens, 4 executors and a burst of 8 (which fires
   the early exit), once with the kernels and once under
   ``ops.reference()``: counters, exit labels and records identical, logits
   within 5e-2 of the largest logit;
7. prefill of 4 x 512 tokens, its k/v copied into a 1024-slot cache, 64
   greedy decode steps; every step's logits held against ``forward`` over
   prompt and generated tokens, and against a teacher-forced rerun under
   ``ops.reference()``; every norm launched the rmsnorm kernel; then the
   ``cast_weights_bf16`` lever: the weights cast once (``Model.cast_weights``,
   replacing the f32 tree), the same prefill and 64 greedy steps, logits
   ``torch.equal`` to the lever-off run; decode tokens/s, kernels a decode
   step and peak memory, lever off and on;
8. the rmsnorm, rglru_scan and mamba_scan kernels against their plain
   versions on the card (at the shapes of tests/test_kernels.py and its
   tolerances, at the main path's shapes, and at ragged ones; mamba's last
   state too, and its checkpointing entry point's y and h_last
   ``torch.equal`` to the contract entry point's and its state
   checkpoints to the plain twin's), then each kernel's median time over
   50 launches (CUDA
   events, warm and cold, as in phase 5) beside its bound, its plain
   version's time and, for rmsnorm, ``torch.nn.functional.rms_norm``'s,
   warm and cold, and the time of one call with its host side, at the
   recurrent prefills' (2048, 4096), qwen3's qk-norm (4, 512, 16, 128) and
   a decode step's (4, 1, 4096); beside rglru_scan, ``torch.add`` over the
   same operands (the same bytes moved) as a yardstick;
9. falcon-mamba-7b at full width (random weights from seed 0): prefill of
   4 x 512 tokens and 64 greedy decode steps through ``build_model`` and
   ``launch.step`` in bf16, one mamba_scan launch per layer and one
   rmsnorm per norm.  Against ``ops.reference()`` on the same weights:
   every layer of the bf16 prefill, given the plain path's input, and, in
   float32 compute, prefill's last logits and 8 teacher-forced decode
   steps.  (The whole bf16 path is recorded against its plain rerun too,
   not held to the tolerance: any rounding difference, from either
   kernel, grows through the 64 layers to about 5 % of the largest logit,
   while each layer agrees to a bf16 ulp and float32 to 2e-5; PERF.md
   §6), and beside it how far the plain bf16 prefill's last logits move
   when every element of its embedded input moves one bf16 ulp; then the
   lever as in phase 7, where falcon-mamba's logits are not equal to the
   lever-off run's (it reads x_proj, dt_proj and A_log in float32) and the
   lever-on path is held to its plain path by the same per-layer and
   float32 checks;
10. recurrentgemma-9b at full width likewise (rglru_scan per recurrent
    layer, flash attention per attention layer, rmsnorm per norm; lever-on
    logits ``torch.equal`` to the lever-off run's);
11. granite-moe-1b-a400m at full width (random weights from seed 0):
    split-serve as phase 6 (counters, exit labels and records identical
    under ``ops.reference()``; the logits' difference recorded: a token
    whose top-k router logits nearly tie may take other experts on the
    other path), prefill of 4 x 512 tokens and 64 greedy decode steps,
    twice, the two runs' logits ``torch.equal``; one flash launch a layer
    per prefill, one decode launch a layer per step, one rmsnorm per norm;
    each bf16 layer on the plain path's input (rows whose experts and
    slots agree at the logits' tolerance, rows whose experts differ only at
    near ties of the plain path's router logits, the dropped counts apart
    by no more than the differing rows' assignments, the aux loss within
    rtol 1e-2), float32
    compute's prefill and 8 teacher-forced steps against the plain path
    (rows whose token took other experts left out, each at a near tie);
    then the lever as in phase 7, logits ``torch.equal`` to the lever-off
    run;
12. qwen2-vl-2b at full width likewise, prefilled from random embeds
    (seed 0) at the default M-RoPE positions, decoded from tokens, with no
    serve run;
13. the serving stack's host paths: ``plan_and_refine`` for granite-moe,
    qwen3-1.7b and recurrentgemma-9b (superblock split points) on F ~
    N(400, 100) from ``default_rng(0)``; the ``slo_serve`` knee point of
    the artifact (poisson at 1.1 x capacity, 1,000,000 rows, 4 stages,
    ``max_queue`` 512, dt 0.01, max_batch 64, ``benchmarks/loadtest.py``'s
    seed rule) through ``SyntheticServeEngine`` and ``run_open_loop``: its
    counts, exit labels and p50 / p99 / p999 equal to the artifact's; its
    registry rendered to Prometheus text and parsed back; ``hist.fill`` of
    1,000,000 values on the card equal to ``fill_np``;
14. training: no spill in the ptxas reports of the backward kernels'
    bf16 instantiations on the training path (flash at head_dim 64, 128
    and 256, the rmsnorm plans of the trained models' norms); the
    flash-attention and rmsnorm backward kernels against their plain
    twins (phase 5's and 8's shapes: the serving prefills of
    qwen3, recurrentgemma, granite-moe and qwen2-vl, a window that bites,
    Sq != Sk, ragged lengths, qwen3's qk-norm and norms) at 3e-5 in f32
    and 2e-2 in bf16, two launches equal, then each timed warm and cold
    beside its bound, its plain twin and the library's backward (autograd
    of SDPA, of ``F.rms_norm``: yardsticks the port never calls); then
    ``launch.train.train`` at qwen3-1.7b's full width, 8 steps of 4 x 512
    from seed 0 (the main path: one flash backward and two forwards a
    layer a step, the norms likewise), the first batch's loss falling,
    tokens/s, peak memory, a second run ``torch.equal``; step 1 against
    ``ops.reference()`` in bf16 (loss and grad norm within 2e-2); float32
    compute, every gradient leaf within 1e-4 of its largest entry, kernel
    against plain; the ``cast_weights_bf16`` lever's gradients reaching
    the float32 leaves; granite-moe-1b-a400m (aux loss weighed 0.01) and
    qwen2-vl-2b (from random embeds) 4 steps each, twice, ``torch.equal``;
    kill and resume at step 3 on qwen3's widths cut to 2 layers,
    bit-identical to the uninterrupted run; the flash backward at
    whisper's encoder and cross attention timed beside autograd of the
    non-causal SDPA;
14b. the rglru_scan and mamba_scan backward kernels and the mamba_scan
    forward: no spill in any instantiation, ``torch.equal`` to their plain
    twins (da, db and dC) at small, ragged and the training shapes (with
    and without a cotangent of the last state; S below, at, one past and
    not a multiple of the checkpoint interval), the Mamba backward both
    from the forward kernel's checkpoints and standalone, two launches
    equal, each timed warm and cold beside its twin and its bound (the
    Mamba backward both ways, its forward's two entry points side by
    side); then the flash forward and backward kernels and the qk-norm's
    rmsnorm forward and backward at the mesh path's tensor-parallel local
    shapes (``TP_LOCAL``: qwen3-1.7b's heads over "model" = 2 and 4,
    qwen3-moe-30b-a3b's over 4), against their plain versions at 2e-2,
    two launches equal, each timed beside its plain version, its bound
    and the library call; and the scans at the tensor-parallel widths
    (rglru_scan and its backward at W = 4096 / m, mamba_scan's two entry
    points and its backward at D = 8192 / m, m = 2 and 4), as their
    contracts require (``torch.equal``; mamba's y at rtol 2e-4), timed at
    m = 4;
14c. falcon-mamba-7b (24 of 64 layers) and recurrentgemma-9b (9 of 38)
    at full width through ``launch.train.train``, 4 steps of 4 x 512 from
    seed 0, twice, ``torch.equal``, the hand-written launches counted
    (the scans' forward twice and backward once a layer a step, the hd-256
    flash backward on the hybrid's attention layers), step time, tokens/s
    and peak memory; one float32 step, kernel against ``ops.reference()``,
    every gradient leaf within 1e-4 of its largest entry;
14d. the mesh path on a world of one: an NCCL group of one process from
    a ``HashStore``, a (1, 1) ("data", "model") mesh
    (``launch.mesh.make_mesh``); qwen3-1.7b at full width, 2 steps of 4 x
    512 from seed 0 through ``build_model(cfg, mesh)`` and
    ``launch.step``, and granite-moe-1b-a400m 2 steps through the
    expert-parallel path, each ``torch.equal`` to the one-process steps
    (loss, grad norm, every parameter, m and v), the kernel launches
    those of the one-process path; qwen3's widths at 2 layers saved under
    the mesh and restored with ``restore_into(..., mesh=)``, equal leaf
    for leaf; step walls, peak memory and the card's name and power
    limit; then serving through ``build_model(cfg, mesh)``: qwen3-1.7b and
    granite-moe-1b-a400m at full width, a prefill of 4 x 512 and 64 greedy
    decode steps in the serving layout, and falcon-mamba-7b,
    recurrentgemma-9b and whisper-medium at full width and a depth cut,
    one train step then a prefill and 8 decode steps, every logit, cache
    and state ``torch.equal`` to one process; the group destroyed;
14e. the distributed flash-decode: qwen3-1.7b at full width and 4
    layers on a (1, 2) mesh of two spawned processes that share the card
    over gloo (heads, MLP columns, vocabulary and the K/V cache's S split
    in two), a prefill and 16 decode steps, each rank launching the
    partial kernel on its half of the cache; logits against one process's
    at phase 7's tolerance, the ranks' equal;
15. whisper-medium at full width (24 + 24 layers, random weights and
    frames from seed 0): prefill of 4 x 64 tokens over 1500 frames, its
    self K/V copied into a 128-slot cache, 64 greedy decode steps, twice,
    ``torch.equal``; every step against forward and against a
    teacher-forced rerun under ``ops.reference()`` at phase 7's tolerance
    (flash non-causal at Sk = 1500, self and cross decode); the lever on,
    ``torch.equal``; then 3 training steps of 4 x 448 tokens through
    ``launch.step.make_train_step``, twice, ``torch.equal``, and the
    float32 gradient check (the key biases, whose exact gradient is zero,
    held against their key weights' scale);
16. the ops tier of the port's swarmlint on the card: ``python -m
    repro_torch.analysis --tier ops --device cuda`` and the same on the CPU
    (started in the background when phase 3 starts, on the cores the
    host-bound simulator phases leave idle; the phase waits for them):
    no finding on the card beyond ``analysis_baseline_torch.toml``, its
    J001 and J005 findings those of the CPU by (rule, file, symbol), the
    fused φ kernels launched in the recorded ``sim_dense`` and
    ``sim_sparse`` programs (25 each: five strategies of five epochs), one
    program per structural group of the stand-in gamma sweeps; then one
    JSON line of its counts and seconds;
17. one JSON line describing every kernel, each launched on the main
    paths (the Pallas-contract φ launchers apart), the nvidia-smi line,
    and the result line ``{"ok": true, "device": {...}}``.  Each phase's
    time is logged as it ends.

Needs one CUDA card and nvcc; imports nothing of JAX or of ``repro``.
"""
from __future__ import annotations

import atexit
import dataclasses
import json
import math
import os
import shutil
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
UPDATE_SHAPES = DENSE_SHAPES + [(8, 4096), (3, 201)]
SPARSE_SHAPES = [(50, 30, 16), (4, 4096, 16), (2, 1000, 200), (1, 65536, 16)]
SPARSE_UPDATE_SHAPES = SPARSE_SHAPES + [(2, 1000, 40), (1, 40, 130),
                                        (1, 100, 1), (2, 300, 7)]
# (R, N) of the dense inputs with NaN and inf, and (R, N, K) of the sparse
# ones (K None: lists covering every link)
SPECIAL_DENSE = [(3, 30), (3, 200), (3, 1024)]
SPECIAL_SPARSE = [(3, 30, None), (3, 64, 16), (3, 1000, 16), (3, 50, 40),
                  (3, 40, 130), (3, 40, 1)]
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


def ptxas_table(report: str) -> dict:
    """Each kernel of a ``ptxas -v`` report: mangled name -> (registers a
    thread, bytes of spill stores, bytes of spill loads)."""
    table, entry, spill = {}, None, (0, 0)
    for ln in report.splitlines():
        if "Compiling entry function" in ln:
            entry, spill = ln.split("'")[1], (0, 0)
        elif entry and "spill stores" in ln:
            w = ln.replace(",", " ").split()
            spill = (int(w[w.index("stores") - 3]),
                     int(w[w.index("loads") - 3]))
        elif entry and "Used" in ln and "registers" in ln:
            table[entry] = (int(ln.split("Used ")[1].split()[0]), *spill)
            entry = None
    return table


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


def update_inputs(R, N, gen, p=0.3):
    """(phi, F, adj, d_tx) as the simulator hands them to the update: node
    0 has no neighbour; delays on every pair (off-link ones unread)."""
    dev = "cuda"
    F = torch.rand(R, N, device=dev, generator=gen) * 400 + 100
    phi = torch.rand(R, N, device=dev, generator=gen) * 750 + 50
    adj = torch.rand(R, N, N, device=dev, generator=gen) < p
    adj &= ~torch.eye(N, dtype=torch.bool, device=dev)
    adj[:, 0] = False
    dtx = torch.rand(R, N, N, device=dev, generator=gen) * 1e-2 + 1e-4
    return phi, F, adj, dtx


def seven_op_chain(ops):
    """``core.diffusive.phi_update_op`` as it stood before the fused
    kernel: seven torch ops (1/φ, the masked delays, ``diffusive_phi``, the
    degree, its compare, 1/x and the fallback), which launch more kernels
    than that on the card (phase 2 counts them); the plain twin under
    ``ops.reference()``."""
    def chain(phi, F, adj, d_tx):
        inv_new = ops.diffusive_phi(1.0 / phi, F,
                                    torch.where(adj, d_tx, -1e30))
        deg = adj.sum(dim=-1)
        return torch.where(deg > 0, 1.0 / inv_new, F)
    return chain


def device_launches(fn, args, attempts=3) -> int:
    """CUDA kernels one call launches, by torch.profiler (the most seen in
    ``attempts`` windows: the profiler now and then drops a record)."""
    fn(*args)
    torch.cuda.synchronize()
    seen = 0
    for _ in range(attempts):
        with profile(activities=[ProfilerActivity.CUDA]) as prof:
            fn(*args)
            torch.cuda.synchronize()
        seen = max(seen, sum(1 for e in prof.events()
                             if e.device_type.name == "CUDA"))
    return seen


def sparse_inputs(R, N, K, gen):
    dev = "cuda"
    F = torch.rand(R, N, device=dev, generator=gen) * 400 + 100
    nbr = torch.randint(0, N, (R, N, K), device=dev, generator=gen,
                        dtype=torch.int32)
    ok = torch.rand(R, N, K, device=dev, generator=gen) < 0.6
    dtx = torch.where(ok, torch.rand(R, N, K, device=dev, generator=gen)
                      * 1e-2 + 1e-4, -1e30)
    return 1.0 / F, F, dtx, torch.where(ok, nbr, 0)


def sparse_update_inputs(R, N, K, gen):
    """(phi, F, adj_e, nbr, d_tx_e) as the simulator hands them to the
    sparse update: 60 % of the slots on-link, node 0 without neighbours,
    index 0 on the other slots."""
    dev = "cuda"
    phi = torch.rand(R, N, device=dev, generator=gen) * 750 + 50
    F = torch.rand(R, N, device=dev, generator=gen) * 400 + 100
    nbr = torch.randint(0, N, (R, N, K), device=dev, generator=gen,
                        dtype=torch.int32)
    on = torch.rand(R, N, K, device=dev, generator=gen) < 0.6
    on[:, 0] = False
    dtx = torch.rand(R, N, K, device=dev, generator=gen) * 1e-2 + 1e-4
    return phi, F, on, torch.where(on, nbr, 0), dtx


def sparse_chain(ops):
    """``core.diffusive.phi_update_op_sparse`` as it stood before the fused
    kernel: 1/φ, the masked delays, ``diffusive_phi_sparse``, the degree,
    its compare, 1/x and the fallback; the plain twin under
    ``ops.reference()``."""
    def chain(phi, F, adj_e, nbr, d_tx_e):
        inv_new = ops.diffusive_phi_sparse(
            1.0 / phi, F.contiguous(), torch.where(adj_e, d_tx_e, -1e30),
            nbr.to(torch.int32).contiguous())
        deg = adj_e.sum(dim=-1)
        return torch.where(deg > 0, 1.0 / inv_new, F)
    return chain


def special_inputs(R, N, gen):
    """``update_inputs`` with NaN and inf (R >= 3): run 0 has φ = 0, -0
    and inf at nodes 2-4; run 1 NaN, +inf and -inf delays on every 7th
    link and, in rows 5-8, NaN delays off-link only; run 2 φ = inf and 0
    at nodes 5-6, F = inf and 0 at nodes 7-8 and NaN on every link of row
    9 (tests/test_torch_phi_nan.py)."""
    phi, F, adj, dtx = update_inputs(R, N, gen)
    nan, inf = float("nan"), float("inf")
    phi[0, 2], phi[0, 3], phi[0, 4] = 0.0, -0.0, inf
    links = adj[1].nonzero()[::7]
    vals = torch.tensor([nan, inf, -inf], device="cuda").repeat(
        len(links) // 3 + 1)[:len(links)]
    dtx[1, links[:, 0], links[:, 1]] = vals
    fresh = torch.rand(4, N, device="cuda", generator=gen) * 1e-2 + 1e-4
    dtx[1, 5:9] = torch.where(adj[1, 5:9], fresh, nan)
    phi[2, 5], phi[2, 6] = inf, 0.0
    F[2, 7], F[2, 8] = inf, 0.0
    dtx[2, 9] = torch.where(adj[2, 9], nan, dtx[2, 9])
    return phi, F, adj, dtx


def special_lists(adj, dtx, K, gen):
    """Lists [R, N, K] over a dense graph with NaN and inf: K None covers
    every link (slot k is node k); else K random slots a row, 60 %
    on-link, the delays gathered from the row's own, and row 5 of run 1
    on-link in every slot with a NaN delay in slot 0."""
    R, N, _ = adj.shape
    if K is None:
        nbr = torch.arange(N, dtype=torch.int32, device="cuda").expand(
            R, N, N)
        return adj, torch.where(adj, nbr, 0).contiguous(), dtx
    nbr = torch.randint(0, N, (R, N, K), device="cuda", generator=gen,
                        dtype=torch.int32)
    on = torch.rand(R, N, K, device="cuda", generator=gen) < 0.6
    on[:, 0] = False
    d_e = torch.gather(dtx, -1, nbr.long())
    on[1, 5], d_e[1, 5, 0] = True, float("nan")
    return on, torch.where(on, nbr, 0), d_e


def nan_equal(got, want) -> bool:
    """torch.equal with NaN equal to NaN at the same places."""
    return (got.shape == want.shape
            and torch.equal(got.isnan(), want.isnan())
            and torch.equal(torch.where(got.isnan(), 0.0, got),
                            torch.where(want.isnan(), 0.0, want)))


def device_ms(fn, args, reps=50, warmup=5, attempts=3) -> float:
    """Device time of one call from torch.profiler over ``reps`` calls after
    warm-up: (median kernel duration, when each call is one kernel; else
    the mean of the summed kernel durations per call, in ms).  The host
    side of a call (checks, allocation, launch) is not in it.  The
    profiler now and then delivers fewer kernel records than were
    launched; such a window is measured again, up to ``attempts`` times,
    and then the call is timed with CUDA events instead (``event_ms``:
    the median of ``reps`` calls, each between its own pair of events,
    so the launch's host side is in it)."""
    for _ in range(warmup):
        fn(*args)
    torch.cuda.synchronize()
    for _ in range(attempts):
        with profile(activities=[ProfilerActivity.CPU,
                                 ProfilerActivity.CUDA]) as prof:
            for _ in range(reps):
                fn(*args)
            torch.cuda.synchronize()
        kern = [e.device_time for e in prof.events()
                if e.device_type.name == "CUDA"]
        if len(kern) >= reps:
            break
        log(f"[timing] the profiler saw {len(kern)} kernels for {reps} "
            f"calls; measuring again")
    if len(kern) < reps:
        t = event_ms(lambda: fn(*args), reps=reps, warmup=0)
        log(f"[timing] the profiler dropped kernel records in "
            f"{attempts} windows; by CUDA events instead: {t:.6f} ms")
        return t
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


def update_bound_ms(R, N, ops=4) -> tuple:
    """The fused update: each adjacency byte and delay read once (5 bytes a
    pair), φ and F read and φ' written once (12 bytes a node); ops per (i,
    k): add, select, max, count."""
    nbytes = 5 * R * N * N + 12 * R * N
    t_bytes = nbytes / HBM_BYTES_PER_S * 1e3
    t_ops = ops * R * N * N / FP32_OPS_PER_S * 1e3
    return max(t_bytes, t_ops), "bytes" if t_bytes >= t_ops else "operations"


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


def sparse_update_bound_ms(adj_e) -> tuple:
    """The fused sparse update: each adjacency byte, index and delay read
    once (9 bytes a slot), φ and F read and φ' written once (12 bytes a
    node; the gathered φ reads go through L2 and count once with φ); ops:
    add, select, max and count a slot, and the reciprocal of each on-link
    slot's gathered φ, as this input has them."""
    R, N, K = adj_e.shape
    return roofline_ms(9 * R * N * K + 12 * R * N,
                       4 * R * N * K + int(adj_e.sum()), FP32_OPS_PER_S)


def phase_special(K, ref) -> int:
    """All four φ launchers on inputs with NaN, ±inf and zero φ, against
    their plain versions, NaN for NaN; returns the NaN rows seen."""
    gen = torch.Generator(device="cuda").manual_seed(16)
    nan_rows = 0
    for R, N in SPECIAL_DENSE:
        phi, F, adj, dtx = special_inputs(R, N, gen)
        contract = (1.0 / phi, F, torch.where(adj, dtx, -1e30))
        check(nan_equal(K.diffusive_phi(*contract),
                        ref.diffusive_phi(*contract)),
              f"diffusive_phi != plain on NaN/inf inputs at {(R, N)}")
        got = K.phi_update(phi, F, adj, dtx)
        check(nan_equal(got, ref.phi_update(phi, F, adj, dtx)),
              f"phi_update != plain on NaN/inf inputs at {(R, N)}")
        check(bool(got.isnan().any()) and
              bool(torch.isfinite(got[1, 5:9]).all()),
              f"phi_update at {(R, N)}: no NaN row, or a NaN off-link "
              f"delay reached its row")
        nan_rows += int(got.isnan().sum())
    for R, N, Kk in SPECIAL_SPARSE:
        phi, F, adj, dtx = special_inputs(R, N, gen)
        on, nbr, d_e = special_lists(adj, dtx, Kk, gen)
        contract = (1.0 / phi, F, torch.where(on, d_e, -1e30), nbr)
        check(nan_equal(K.diffusive_phi_sparse(*contract),
                        ref.diffusive_phi_sparse(*contract)),
              f"diffusive_phi_sparse != plain on NaN/inf inputs at "
              f"{(R, N, Kk)}")
        args = (phi, F, on, nbr, d_e)
        got = K.phi_update_sparse(*args)
        check(nan_equal(got, ref.phi_update_sparse(*args)),
              f"phi_update_sparse != plain on NaN/inf inputs at "
              f"{(R, N, Kk)}")
        check(bool(got.isnan().any()), f"phi_update_sparse at {(R, N, Kk)}:"
              f" no NaN row")
        if Kk is None:
            check(nan_equal(got, K.phi_update(phi, F, adj, dtx)),
                  f"phi_update_sparse != phi_update on covering lists with "
                  f"NaN/inf at {(R, N)}")
        nan_rows += int(got.isnan().sum())
    return nan_rows


def phase_kernels(K, ref, ops, diffusive, gen) -> dict:
    err = {"diffusive_phi": 0.0, "diffusive_phi_sparse": 0.0,
           "phi_update": 0.0, "phi_update_sparse": 0.0}
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
    chain = seven_op_chain(ops)
    for R, N in UPDATE_SHAPES:
        args = update_inputs(R, N, gen)
        got, want = K.phi_update(*args), ref.phi_update(*args)
        torch.cuda.synchronize()
        check(torch.equal(got, want), f"phi_update != plain at {(R, N)}")
        check(torch.equal(got, chain(*args)),
              f"phi_update != the seven-op chain at {(R, N)}")
        with ops.reference():
            check(torch.equal(got, chain(*args)),
                  f"phi_update != the chain's plain twin at {(R, N)}")
        check(torch.equal(got[:, 0], args[1][:, 0]),
              f"phi_update at {(R, N)}: an isolated node is not F")
        err["phi_update"] = max(err["phi_update"],
                                float((got - want).abs().max()))
    # the sparse update's inputs come from a generator of their own, so
    # that ``gen`` draws the later phases' inputs (the prompts of phases 7,
    # 9 and 10) whatever this phase checks
    sgen = torch.Generator(device="cuda").manual_seed(17)
    schain = sparse_chain(ops)
    for R, N, Kk in SPARSE_UPDATE_SHAPES:
        args = sparse_update_inputs(R, N, Kk, sgen)
        got, want = K.phi_update_sparse(*args), ref.phi_update_sparse(*args)
        torch.cuda.synchronize()
        check(torch.equal(got, want),
              f"phi_update_sparse != plain at {(R, N, Kk)}")
        check(torch.equal(got, schain(*args)),
              f"phi_update_sparse != the sparse chain at {(R, N, Kk)}")
        with ops.reference():
            check(torch.equal(got, schain(*args)),
                  f"phi_update_sparse != the chain's plain twin at "
                  f"{(R, N, Kk)}")
        check(torch.equal(got[:, 0], args[1][:, 0]),
              f"phi_update_sparse at {(R, N, Kk)}: an isolated node is not F")
        err["phi_update_sparse"] = max(err["phi_update_sparse"],
                                       float((got - want).abs().max()))
    # the sparse update equals the dense one on lists covering every link
    phi, F, adj, dtx = update_inputs(3, 50, sgen)
    nbr = torch.arange(50, dtype=torch.int32, device="cuda").expand(
        3, 50, 50)
    check(torch.equal(K.phi_update_sparse(phi, F, adj,
                                          torch.where(adj, nbr, 0), dtx),
                      K.phi_update(phi, F, adj, dtx)),
          "phi_update_sparse != phi_update on covering lists")
    nan_rows = phase_special(K, ref)
    args = update_inputs(50, 30, gen)
    n_op = device_launches(diffusive.phi_update_op, args)
    n_chain = device_launches(chain, args)
    check(n_op == 1, f"phi_update_op launched {n_op} device kernels")
    args = sparse_update_inputs(4, 4096, 16, sgen)
    n_sop = device_launches(diffusive.phi_update_op_sparse, args)
    n_schain = device_launches(schain, args)
    check(n_sop == 1,
          f"phi_update_op_sparse launched {n_sop} device kernels")
    log(f"[kernels] torch.equal to the plain versions at dense {DENSE_SHAPES}"
        f" and sparse {SPARSE_SHAPES}; sparse == dense on covering lists; "
        f"phi_update == its plain twin == the seven-op chain (kernel and "
        f"plain) at {UPDATE_SHAPES}; phi_update_sparse == its plain twin == "
        f"the sparse chain (kernel and plain) at {SPARSE_UPDATE_SHAPES}, and "
        f"== phi_update on covering lists; phi_update_op {n_op} device "
        f"launch, the chain {n_chain}; phi_update_op_sparse {n_sop}, its "
        f"chain {n_schain}; max_abs_err {err}")
    log(f"[kernels] NaN and inf: diffusive_phi, phi_update, "
        f"diffusive_phi_sparse and phi_update_sparse equal their plain "
        f"versions NaN for NaN at dense {SPECIAL_DENSE} and sparse "
        f"{SPECIAL_SPARSE} (φ = 0, -0, inf; F = 0, inf; NaN, +inf, -inf "
        f"delays on links; NaN delays off-link only hidden by the mask); "
        f"{nan_rows} NaN rows among the updates' outputs")
    return err


def time_kernel(kern, plain, args, bound) -> dict:
    return {"ms": device_ms(kern, args), "plain_ms": device_ms(plain, args),
            "bound_ms": bound[0], "bound_by": bound[1], "library_ms": None,
            "cold_ms": event_ms(lambda: kern(*args), cold=True),
            "library_cold_ms": None, "call_ms": call_ms(kern, args)}


def phase_timing(K, ref, ops, gen) -> dict:
    """Median kernel times at the main path's shapes (recorded in the JSON)
    and at larger ones (printed); the fused update beside the seven-op
    chain it replaced (device time summed over the chain's kernels)."""
    out = {}
    chain = seven_op_chain(ops)
    for R, N in [(50, 30), (8, 4096)]:
        args = update_inputs(R, N, gen)
        t = time_kernel(K.phi_update, ref.phi_update, args,
                        update_bound_ms(R, N))
        c_ms, c_call = device_ms(chain, args), call_ms(chain, args)
        with ops.reference():
            c_plain = device_ms(chain, args)
        log(f"[timing] phi_update R={R} N={N}: kernel {t['ms']:.6f} ms "
            f"(L2-cold {t['cold_ms']:.6f} by events), plain "
            f"{t['plain_ms']:.6f} ms, bound {t['bound_ms']:.6f} ms "
            f"({t['bound_by']}), {t['bound_ms'] / t['ms']:.3f} of bound; one "
            f"call with its host side {t['call_ms']:.5f} ms.  The seven-op"
            f" chain: {c_ms:.6f} ms of device time a call over "
            f"{device_launches(chain, args)} kernels (its plain twin "
            f"{c_plain:.6f}), one call with its host side {c_call:.5f} ms")
        out.setdefault("phi_update", t)
        del args
    schain = sparse_chain(ops)
    sgen = torch.Generator(device="cuda").manual_seed(18)
    for R, N, Kk in [(4, 4096, 16), (1, 65536, 16)]:
        args = sparse_update_inputs(R, N, Kk, sgen)
        t = time_kernel(K.phi_update_sparse, ref.phi_update_sparse, args,
                        sparse_update_bound_ms(args[2]))
        t["launches_per_call"] = device_launches(K.phi_update_sparse, args)
        check(t["launches_per_call"] == 1,
              f"phi_update_sparse: {t['launches_per_call']} device launches "
              f"a call")
        c_ms, c_call = device_ms(schain, args), call_ms(schain, args)
        c_cold = event_ms(lambda: schain(*args), cold=True)
        with ops.reference():
            c_plain = device_ms(schain, args)
        log(f"[timing] phi_update_sparse R={R} N={N} K={Kk}: kernel "
            f"{t['ms']:.6f} ms (L2-cold {t['cold_ms']:.6f} by events), "
            f"{t['launches_per_call']} device launch a call, plain "
            f"{t['plain_ms']:.6f} ms, bound {t['bound_ms']:.6f} ms "
            f"({t['bound_by']}), {t['bound_ms'] / t['ms']:.3f} of bound warm,"
            f" {t['bound_ms'] / t['cold_ms']:.3f} cold; one call with its "
            f"host side {t['call_ms']:.5f} ms.  The chain it replaced: "
            f"{c_ms:.6f} ms of device time a call over "
            f"{device_launches(schain, args)} kernels (L2-cold "
            f"{c_cold:.6f} by events; its plain twin {c_plain:.6f}), one call"
            f" with its host side {c_call:.5f} ms")
        out.setdefault("phi_update_sparse", t)
        del args
    for R, N in [(50, 30), (4, 1024), (1, 4096), (8, 4096)]:
        t = time_kernel(K.diffusive_phi, ref.diffusive_phi,
                        dense_inputs(R, N, gen), dense_bound_ms(R, N))
        log(f"[timing] diffusive_phi R={R} N={N}: kernel {t['ms']:.5f} ms "
            f"(L2-cold {t['cold_ms']:.5f} by events), "
            f"plain {t['plain_ms']:.5f} ms, bound {t['bound_ms']:.6f} ms "
            f"({t['bound_by']}), {t['bound_ms'] / t['ms']:.3f} of bound; "
            f"one call with its host side {t['call_ms']:.5f} ms")
        out.setdefault("diffusive_phi", t)
    for R, N, Kk in [(4, 4096, 16), (1, 65536, 16), (2, 1000, 200)]:
        t = time_kernel(K.diffusive_phi_sparse, ref.diffusive_phi_sparse,
                        sparse_inputs(R, N, Kk, gen),
                        sparse_bound_ms(R, N, Kk))
        log(f"[timing] diffusive_phi_sparse R={R} N={N} K={Kk}: kernel "
            f"{t['ms']:.5f} ms (L2-cold {t['cold_ms']:.5f} by events), plain {t['plain_ms']:.5f} ms, bound "
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


# the four baselines run at 20 s, to leave the later phases room in the
# time limit (LocalOnly, Random and RandomAcyclic neither use φ nor decide
# per neighbour; Greedy decides per neighbour without φ); Distributed, the
# paper's strategy, runs the paper's 100 s
SHORT_STRATEGIES = {"LocalOnly": 20.0, "Random": 20.0, "RandomAcyclic": 20.0,
                    "Greedy": 20.0}
# Distributed against its plain φ version: a run of its own at 20 s beside
# the 100-s one that logs the indices (the comparison's bits do not depend
# on the length; the plain run at 100 s took 60 to 75 s of the time limit)
PLAIN_SIM_S = 20.0


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
    check(launches["phi_update"] == n_epochs,
          f"phi_update launched {launches['phi_update']} times, expected "
          f"{n_epochs} (one an epoch)")
    check(launches["diffusive_phi"] == 0,
          f"the main path launched diffusive_phi "
          f"{launches['diffusive_phi']} times")
    short = dataclasses.replace(cfg, sim_time_s=PLAIN_SIM_S)
    t0 = time.perf_counter()
    kern = S.run_many(key, short, S.DISTRIBUTED, n, runs)
    torch.cuda.synchronize()
    wall_k = time.perf_counter() - t0
    check_metrics(kern, runs, f"Distributed at {PLAIN_SIM_S:g} s")
    t0 = time.perf_counter()
    with ops.reference():
        plain = S.run_many(key, short, S.DISTRIBUTED, n, runs)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    for k, v in kern.items():
        check(torch.equal(v, plain[k]),
              f"Distributed {k}: kernel path != plain path")
    log(f"[main] Distributed at {PLAIN_SIM_S:g} s with the kernel (wall "
        f"{wall_k:.2f} s) and with the plain φ version (wall {wall:.2f} s): "
        f"bit-identical on all {len(plain)} metrics; kernel launches on the "
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


def phase_sparse(S, rng, ops, K, SwarmConfig) -> dict:
    n, runs = 4096, 4
    cfg = dataclasses.replace(SwarmConfig(), num_workers=n, neighbor_k=16,
                              neighbor_mode="sparse", sim_time_s=2.0)
    key = rng.PRNGKey(0)
    torch.cuda.reset_peak_memory_stats()
    K.reset_launches()
    t0 = time.perf_counter()
    m = S.run_many(key, cfg, S.DISTRIBUTED, n, runs)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    launches = dict(K.LAUNCHES)
    check_metrics(m, runs, "sparse")
    n_epochs = round(cfg.sim_time_s / cfg.decision_period_s)
    check(launches["phi_update_sparse"] == n_epochs,
          f"phi_update_sparse launched {launches['phi_update_sparse']} "
          f"times, expected {n_epochs} (one an epoch)")
    check(launches["diffusive_phi_sparse"] == 0,
          f"the sparse path launched diffusive_phi_sparse "
          f"{launches['diffusive_phi_sparse']} times")
    peak = torch.cuda.max_memory_allocated() / 2 ** 30
    log(f"[sparse] N={n} K=16 R={runs} {cfg.sim_time_s:g} s Distributed: "
        f"wall {wall:.2f} s, peak {peak:.2f} GiB; {summary(m)}; kernel "
        f"launches {launches}")
    with ops.reference():
        plain = S.run_many(key, cfg, S.DISTRIBUTED, n, runs)
    # the op chain the fused kernel replaced, with its Pallas-contract
    # kernel, swapped into the simulator for one run
    fused, S.phi_update_op_sparse = S.phi_update_op_sparse, sparse_chain(ops)
    K.reset_launches()
    try:
        chained = S.run_many(key, cfg, S.DISTRIBUTED, n, runs)
    finally:
        S.phi_update_op_sparse = fused
    check(K.LAUNCHES["diffusive_phi_sparse"] == n_epochs,
          f"the sparse chain launched diffusive_phi_sparse "
          f"{K.LAUNCHES['diffusive_phi_sparse']} times")
    for k, v in m.items():
        check(torch.equal(v, plain[k]), f"sparse {k}: kernel path != plain")
        check(torch.equal(v, chained[k]),
              f"sparse {k}: fused update != the op chain it replaced")
    log(f"[sparse] bit-identical on all {len(m)} metrics to the plain path "
        f"and to the op chain the fused update replaced "
        f"(diffusive_phi_sparse between torch ops)")
    return launches


# ---------------------------------------------------------------------------
# phase 4b: the fleet sweep path
# ---------------------------------------------------------------------------

# benchmarks/fig3_gamma.py's grid: γ sweep, 30 UAVs, Distributed, seed 0,
# at the 4 runs of the reference artifact's sweep:fig3_gamma section.  The
# artifact's point (γ = 0.02) runs at its full 100 s; the grid, the other
# backends and the dispatch check run at GRID_SIM_S, a cut of depth only:
# an epoch is host-bound, about 0.1 s, so the grid at 100 s alone would
# take 6 to 7 minutes of the script's 20.
FIG3_GAMMAS = (0.002, 0.01, 0.02, 0.05, 0.1, 0.3)
FIG3_RUNS = 4
FIG3_POINT = "gamma=0.02/strategy=Distributed"
GRID_SIM_S = 10.0
CI_INDICES = ("avg_latency_s", "completed", "dropped", "transfers",
              "remaining_gflops", "jain_fairness", "energy_per_task_j",
              "throughput_tps")
# The artifact was computed under an older jax, whose random streams the
# installed reference no longer reproduces (ROADMAP.md, reference-side
# caveats): the live reference's own energy_per_task_j at this point,
# 0.248668 ± 0.000664, misses the artifact's 0.247437 ± 0.000550 (and
# tests/test_torch_fleet.py holds the live reference to the artifact on
# the other seven).  That index is held against the port's CPU run instead,
# which reproduces the live reference (tests/test_torch_fleet.py).
NOT_REPRODUCED = ("energy_per_task_j",)
ARTIFACT = ROOT / "benchmarks" / "artifacts" / "BENCH_fleet.json"


def metrics_equal(a: dict, b: dict) -> bool:
    """torch.equal on every per-run metric (spans skipped)."""
    keys = [k for k in a if not k.startswith("_")]
    return sorted(keys) == sorted(k for k in b if not k.startswith("_")) \
        and all(torch.equal(torch.as_tensor(a[k]), torch.as_tensor(b[k]))
                for k in keys)


def report_bytes(fleet, res, path: Path) -> bytes:
    fleet.write_bench_json(str(path), "sweep:fig3_gamma",
                           fleet.build_report(res))
    return path.read_bytes()


def fig3_spec(fleet, SwarmConfig, S, sim_time_s, gammas=FIG3_GAMMAS):
    return fleet.SweepSpec.build(
        "fig3_gamma", SwarmConfig(num_workers=30, sim_time_s=sim_time_s),
        axes={"gamma": gammas}, strategies=(S.DISTRIBUTED,),
        num_runs=FIG3_RUNS, seed=0)


def phase_fleet(fleet, SwarmConfig, S, K) -> dict:
    """The fig 3 grid through ``execute(backend="vmap")`` into a store; the
    γ = 0.02 point through ``streaming`` (chunk 3) and ``sharded``, killed
    after one chunk and resumed, and from the store; the grid over two
    spawned workers on the card; the artifact's point at 100 s against the
    reference artifact's 95 % CIs and against the same point on the CPU
    (run beside it in a spawned process)."""
    import concurrent.futures
    import multiprocessing
    import shutil
    work = ROOT / "build" / "fleet_smoke"
    shutil.rmtree(work, ignore_errors=True)
    work.mkdir(parents=True)

    def epochs(pt) -> int:
        return round(pt.cfg.sim_time_s / pt.cfg.decision_period_s)

    spec = fig3_spec(fleet, SwarmConfig, S, GRID_SIM_S)
    points = {p.label: p for p in spec.expand()}
    pt = points[FIG3_POINT]
    store = fleet.ResultStore(str(work / "store"))
    K.reset_launches()
    t0 = time.perf_counter()
    res = fleet.execute(spec, backend="vmap", store=store)
    wall = time.perf_counter() - t0
    launches = dict(K.LAUNCHES)       # summed below over every computed run
    check(launches["phi_update"] == epochs(pt) * len(points),
          f"fleet vmap: phi_update launched {launches['phi_update']} times, "
          f"expected {epochs(pt) * len(points)} (one an epoch of every "
          f"point)")
    for label, m in res.items():
        check_metrics({k: torch.as_tensor(v) for k, v in m.items()
                       if not k.startswith("_")}, FIG3_RUNS, label)
        check(m["_compile_s"] == 0.0 and m["_execute_s"] > 0, label)
    log(f"[fleet] fig 3 grid, {len(points)} points x {FIG3_RUNS} runs x "
        f"{GRID_SIM_S:g} s, N=30, execute(backend='vmap') into a store: "
        f"{wall:.2f} s; wall per point "
        f"{[round(m['_wall_s'], 2) for m in res.values()]} s; phi_update "
        f"{launches['phi_update']} launches (one an epoch)")
    want = res[FIG3_POINT]

    walls = {"vmap": want["_wall_s"]}
    for backend, kw in (("streaming", dict(chunk_size=3)), ("sharded", {})):
        K.reset_launches()
        t0 = time.perf_counter()
        got = fleet.run_point(pt, backend=backend, **kw)
        walls[backend] = time.perf_counter() - t0
        chunks = -(-FIG3_RUNS // 3) if backend == "streaming" else 1
        check(K.LAUNCHES["phi_update"] == epochs(pt) * chunks,
              f"fleet {backend}: phi_update launched "
              f"{K.LAUNCHES['phi_update']} times, expected "
              f"{epochs(pt) * chunks}")
        launches["phi_update"] += K.LAUNCHES["phi_update"]
        check(metrics_equal(got, want), f"fleet {backend} != vmap")

    part = fleet.ResultStore(str(work / "resume"))
    K.reset_launches()
    t0 = time.perf_counter()
    try:
        fleet.run_point(pt, backend="streaming", store=part, chunk_size=3,
                        max_chunks=1)
        check(False, "max_chunks=1 did not interrupt the sweep")
    except fleet.SweepInterrupted:
        pass
    done, _ = part.load_partial(fleet.point_digest(pt), chunk_size=3)
    check(done == 1, f"the partial holds {done} chunks, expected 1")
    resumed = fleet.run_point(pt, backend="streaming", store=part,
                              chunk_size=3)
    walls["streaming, killed + resumed"] = time.perf_counter() - t0
    check(K.LAUNCHES["phi_update"] == epochs(pt) * -(-FIG3_RUNS // 3),
          f"fleet resume: phi_update launched {K.LAUNCHES['phi_update']} "
          f"times over the two calls")
    launches["phi_update"] += K.LAUNCHES["phi_update"]
    check(metrics_equal(resumed, want), "fleet resumed != vmap")
    K.reset_launches()
    hit = fleet.run_point(pt, backend="vmap", store=part)
    check(K.LAUNCHES["phi_update"] == 0 and metrics_equal(hit, want),
          "fleet store hit")
    log(f"[fleet] {FIG3_POINT} at {GRID_SIM_S:g} s: streaming (chunk 3), "
        f"sharded ({torch.cuda.device_count()} device), killed after one "
        f"chunk and resumed, and a store hit all torch.equal to vmap on all "
        f"{len([k for k in want if not k.startswith('_')])} metrics; wall "
        f"per backend {({k: round(v, 2) for k, v in walls.items()})} s")

    t0 = time.perf_counter()
    spread = fleet.dispatch(spec, fleet.ResultStore(str(work / "disp")),
                            workers=2,
                            progress_path=str(work / "progress.jsonl"))
    t_disp = time.perf_counter() - t0
    rows = fleet.read_progress(str(work / "progress.jsonl"))
    workers = sorted({r["worker"].rsplit(":", 1)[1] for r in rows
                      if r.get("event") == "point"})
    check(report_bytes(fleet, spread, work / "spread.json") ==
          report_bytes(fleet, res, work / "single.json"),
          "two-worker dispatch report != single-process report")
    log(f"[fleet] the grid over two spawned workers on the card "
        f"({workers}): report byte-identical to the single process's "
        f"({t_disp:.2f} s dispatched, worker start-up included, against "
        f"{wall:.2f} s); "
        f"{fleet.render_progress(fleet.progress_summary(rows))}")

    # the artifact's point at its full length, and the same point on the
    # CPU in a spawned process meanwhile (it reproduces the live reference)
    art_spec = fig3_spec(fleet, SwarmConfig, S, 100.0, gammas=(0.02,))
    (full,) = art_spec.expand()
    with concurrent.futures.ProcessPoolExecutor(
            1, mp_context=multiprocessing.get_context("spawn")) as pool:
        t0 = time.perf_counter()
        on_cpu = pool.submit(fleet.run_point, full, device="cpu")
        K.reset_launches()
        t1 = time.perf_counter()
        art_res = fleet.execute(art_spec, backend="vmap", store=store)
        t_card = time.perf_counter() - t1
        check(K.LAUNCHES["phi_update"] == epochs(full),
              f"fleet 100 s point: phi_update launched "
              f"{K.LAUNCHES['phi_update']} times, expected {epochs(full)}")
        launches["phi_update"] += K.LAUNCHES["phi_update"]
        cpu = on_cpu.result()
        t_cpu = time.perf_counter() - t0
    card = art_res[FIG3_POINT]
    exact = metrics_equal(cpu, card)
    for k in cpu:
        c, g = float(np.mean(cpu[k], dtype=np.float64)), \
            float(np.mean(card[k], dtype=np.float64))
        check(math.isclose(c, g, rel_tol=2e-2, abs_tol=1e-6),
              f"fig 3 cpu vs card {k}: {c} vs {g}")
    log(f"[fleet] {FIG3_POINT} at {full.cfg.sim_time_s:g} s, "
        f"{FIG3_RUNS} runs: {t_card:.2f} s on the card; on the CPU in a "
        f"spawned process meanwhile ({t_cpu:.2f} s): CPU and card agree "
        + ("bit for bit" if exact else "within 2 % on every metric's mean "
           "(not bit for bit)"))

    report = fleet.build_report(art_res)["points"][FIG3_POINT]
    art = json.loads(ARTIFACT.read_text())["sweep:fig3_gamma"]["points"][
        FIG3_POINT]
    lines = []
    for k in CI_INDICES:
        m, h = report[k]["mean"], report[k]["ci95"]
        am, ah = art[k]["mean"], art[k]["ci95"]
        overlap = abs(m - am) <= h + ah
        if k not in NOT_REPRODUCED:
            check(overlap, f"fig 3 {k}: {m} ± {h} does not overlap the "
                           f"artifact's {am} ± {ah}")
        lines.append(f"{k} {m:.6g} ± {h:.3g} (artifact {am:.6g} ± "
                     f"{ah:.3g}{'' if overlap else ', no overlap'})")
    log(f"[fleet] fig 3 at γ = 0.02 against the reference artifact's 95 % "
        f"CIs (benchmarks/artifacts/BENCH_fleet.json, sweep:fig3_gamma; "
        f"every index but {', '.join(NOT_REPRODUCED)} must overlap): "
        + "; ".join(lines))
    shutil.rmtree(work, ignore_errors=True)
    return launches


# ---------------------------------------------------------------------------
# phase 4c: the telemetry streams and the last two channels
# ---------------------------------------------------------------------------

# At the default point (30 UAVs) a 20-s run finishes up to about 7,000
# tasks and delivers up to about 1,100 hops (the port on the CPU, 4 runs),
# so TRACE holds every record of the runs below and SMALL_TRACE overflows.
# Depth is cut where the time limit asks, never width (N, K, R): an epoch
# is host-bound, so Greedy, the backends and the channels run shorter than
# Distributed.
TRACE = dict(trace_capacity=16384, trace_hop_capacity=4096,
             trace_state_every=5, trace_state_nodes=16)
SMALL_TRACE = dict(TRACE, trace_capacity=64, trace_hop_capacity=16)
TRACE_SIM_S = {"Distributed": 20.0, "Greedy": 10.0}
SMALL_SIM_S = 5.0
BACKEND_SIM_S = 2.0
# runs a chunk of the traced streaming backend: 50 runs in 5 chunks, the
# last one partial
TRACE_CHUNK = 12
CHANNEL_SIM_S = 10.0
# the reference artifact's sweep:fig_state point holds 25 samples of 8
# nodes from 4 runs: benchmarks/run.py's fast path (fig_state.run(n=10,
# sim_time=5.0) under REPRO_FLEET_TRACE_STATE=1, _NODES=8)
FIG_STATE = dict(num_workers=10, sim_time_s=5.0, trace_state_every=1,
                 trace_state_nodes=8)
FIG_STATE_POINT = "strategy=Distributed"
# nakagami per edge on phase 4's sparse path, task and hop streams on (a
# 2-s run of 4,096 UAVs finishes about 33,000 tasks and delivers about
# 4,200 hops)
SPARSE_NAKAGAMI = dict(num_workers=4096, num_runs=4, neighbor_k=16,
                       neighbor_mode="sparse", sim_time_s=2.0,
                       channel_model="nakagami", trace_capacity=131072,
                       trace_hop_capacity=16384)


def untraced(m: dict) -> dict:
    return {k: v for k, v in m.items() if not k.startswith("trace_")}


def all_equal(a: dict, b: dict) -> list:
    """The keys whose tensors (or arrays) differ, or that one side lacks."""
    keys = sorted(set(a) | set(b))
    return [k for k in keys if k not in a or k not in b or not torch.equal(
        torch.as_tensor(a[k]).cpu(), torch.as_tensor(b[k]).cpu())]


def check_accounting(trace, m: dict, what: str) -> tuple:
    """Records + overflow = finished tasks; hop records + overflow =
    delivered transfers.  Returns (records, overflow, hops, hop overflow)."""
    dec = trace.decode(m["trace_records"], m["trace_overflow"])
    hdec = trace.decode_hops(m["trace_hops"], m["trace_hop_overflow"])
    finished = int((m["completed"] + m["dropped"]).sum())
    delivered = int(m["transfers_delivered"].sum())
    check(dec["seq"].size + int(dec["overflow"]) == finished,
          f"{what}: {dec['seq'].size} records + {int(dec['overflow'])} "
          f"overflow != {finished} finished tasks")
    check(hdec["seq"].size + int(hdec["overflow"]) == delivered,
          f"{what}: {hdec['seq'].size} hop records + "
          f"{int(hdec['overflow'])} overflow != {delivered} deliveries")
    return (dec["seq"].size, int(dec["overflow"]), hdec["seq"].size,
            int(hdec["overflow"]))


def epoch_launches(S, rng, cfg, strategy, warm=4, measured=5) -> float:
    """CUDA kernels an epoch of 50 runs launches (torch.profiler over
    ``measured`` epochs after ``warm``; five epochs cover one state-stream
    snapshot at ``trace_state_every`` = 5)."""
    from repro_torch.swarm.tasks import make_profile
    n, runs = cfg.num_workers, cfg.num_runs
    keys = rng.split(rng.PRNGKey(0).cuda(), runs)
    k = rng.split(keys)
    st = S.init_state(k[:, 0], cfg, n)
    prof = make_profile(cfg, device="cuda")
    ek = rng.fold_in(k[:, 1], torch.arange(warm + measured, device="cuda"))
    with torch.no_grad():
        for i in range(warm):
            S._epoch(st, ek[:, i], i, strategy, cfg, prof)
        torch.cuda.synchronize()
        with profile(activities=[ProfilerActivity.CUDA]) as p:
            for i in range(warm, warm + measured):
                S._epoch(st, ek[:, i], i, strategy, cfg, prof)
            torch.cuda.synchronize()
    return sum(1 for e in p.events()
               if e.device_type.name == "CUDA") / measured


def phase_telemetry(S, rng, ops, K, fleet, trace, SwarmConfig) -> dict:
    """The three telemetry streams on the card (traced against untraced,
    kernel path against ``ops.reference()``, overflow, the report's traced
    sections, card against CPU), through the three backends, under the two
    channels of this slice, dense and sparse, and the artifact's fig_state
    point (a record)."""
    import shutil
    base = SwarmConfig()
    n, runs = base.num_workers, base.num_runs
    key = rng.PRNGKey(0)
    launches = {"phi_update": 0, "phi_update_sparse": 0}
    t_phase = time.perf_counter()

    def epochs(cfg) -> int:
        return round(cfg.sim_time_s / cfg.decision_period_s)

    def run(cfg, strategy, plain=False, n=n, runs=runs, what=""):
        name = "phi_update_sparse" if cfg.neighbor_mode == "sparse" \
            else "phi_update"
        K.reset_launches()
        t0 = time.perf_counter()
        if plain:
            with ops.reference():
                m = S.run_many(key, cfg, strategy, n, runs)
        else:
            m = S.run_many(key, cfg, strategy, n, runs)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        if not plain:
            check(K.LAUNCHES[name] == epochs(cfg),
                  f"{what}: {name} launched {K.LAUNCHES[name]} times, "
                  f"expected {epochs(cfg)} (one an epoch)")
            launches[name] += K.LAUNCHES[name]
        check_metrics(untraced(m), runs, what)
        return m, wall

    walls = {}
    for name in ("Distributed", "Greedy"):
        s = S.STRATEGY_NAMES.index(name)
        c0 = dataclasses.replace(base, sim_time_s=TRACE_SIM_S[name])
        ct = dataclasses.replace(c0, **TRACE)
        m0, w0 = run(c0, s, what=f"untraced {name}")
        m, w = run(ct, s, what=f"traced {name}")
        walls[name] = (w0 / epochs(c0), w / epochs(c0))
        bad = all_equal(untraced(m), m0)
        check(not bad, f"traced {name}: untraced metrics moved: {bad}")
        plain, _ = run(ct, s, plain=True, what=f"traced {name}, plain")
        bad = all_equal(m, plain)
        check(not bad, f"traced {name}: kernel path != plain path: {bad}")
        counts = check_accounting(trace, m, f"traced {name}")
        check(counts[1] == 0 and counts[3] == 0,
              f"traced {name}: TRACE's capacities overflowed: {counts}")
        doc = fleet.build_report({"p": {k: v.cpu().numpy()
                                        for k, v in m.items()}},
                                 tick_s=ct.tick_s,
                                 tx_power_dbm=ct.tx_power_dbm,
                                 cfg=ct)["points"]["p"]
        for k in ("task_latency_cdf_s", "hop_transfer_time_s_quantiles",
                  "latency_segments", "phi_residual_curve",
                  "queue_depth_heatmap", "tx_energy_total_j"):
            check(doc.get(k) is not None, f"traced {name}: report lacks {k}")
        log(f"[trace] {name}, {runs} runs x {c0.sim_time_s:g} s, N={n}, "
            f"all three streams ({TRACE}): {len(m) - len(m0)} trace leaves "
            f"torch.equal to the plain path's, every untraced metric "
            f"torch.equal to an untraced run's; {counts[0]} task records "
            f"(= completed + dropped), {counts[2]} hop records "
            f"(= delivered); report: task p50 "
            f"{doc['task_latency_cdf_s']['p50']:.6g} s, hop p50 "
            f"{doc['hop_transfer_time_s_quantiles']['p50']:.6g} s, "
            f"φ epochs to ε {doc['phi_epochs_to_eps']}, segments "
            f"{ {k: round(doc['latency_segments'][k + '_share'], 4) for k in trace.SEGMENTS} }")

    dist = S.DISTRIBUTED
    c_small = dataclasses.replace(base, sim_time_s=SMALL_SIM_S, **SMALL_TRACE)
    small, _ = run(c_small, dist, what="small capacities")
    c_big = dataclasses.replace(c_small, **TRACE)
    big, _ = run(c_big, dist, what="small capacities' twin")
    counts = check_accounting(trace, small, "small capacities")
    check(counts[1] > 0 and counts[3] > 0,
          f"small capacities did not overflow: {counts}")
    for k, cap in (("trace_records", SMALL_TRACE["trace_capacity"]),
                   ("trace_hops", SMALL_TRACE["trace_hop_capacity"])):
        check(torch.equal(small[k], big[k][:, :cap]),
              f"small capacities: {k} != the first {cap} slots of the "
              f"large buffer")
    bad = all_equal(untraced(small), untraced(big))
    check(not bad, f"small capacities moved metrics: {bad}")
    log(f"[trace] capacities {SMALL_TRACE['trace_capacity']} / "
        f"{SMALL_TRACE['trace_hop_capacity']} at {SMALL_SIM_S:g} s: "
        f"{counts[0]} task records + {counts[1]} overflow, {counts[2]} hop "
        f"records + {counts[3]} overflow, each equal to the finished tasks "
        f"and deliveries; the kept slots equal the large buffers' first")

    # the same small input on the CPU and on the card (phase 3's rule: the
    # means over runs within 2 %, bit for bit where the devices' ulps allow)
    c_dev = dataclasses.replace(base, sim_time_s=10.0, **TRACE)
    cpu = S.run_many(key, c_dev, dist, n, 4, device="cpu")
    gpu = S.run_many(key, c_dev, dist, n, 4)
    exact = not all_equal(cpu, gpu)
    docs = [fleet.build_report({"p": {k: v.cpu().numpy() for k, v in
                                      m.items()}})["points"]["p"]
            for m in (cpu, gpu)]
    pairs = [(k, float(cpu[k].double().mean()),
              float(gpu[k].double().mean())) for k in untraced(cpu)]
    pairs += [(k, float(docs[0][k]), float(docs[1][k])) for k in
              ("task_count", "dropped_count", "hop_count",
               "completion_rate_final", "queue_jain_final")]
    pairs += [("task p50", docs[0]["task_latency_cdf_s"]["p50"],
               docs[1]["task_latency_cdf_s"]["p50"])]
    for k, c, g in pairs:
        check(math.isclose(c, g, rel_tol=2e-2, abs_tol=1e-6),
              f"traced cpu vs card {k}: {c} vs {g}")
    log(f"[trace] small input (N={n}, 4 runs, 10 s, Distributed, traced): "
        f"CPU and card agree " + ("bit for bit on every leaf" if exact else
                                  "within 2 % on the metrics' means and the "
                                  "report's task, hop and state indices "
                                  "(not bit for bit)"))

    # the backends: vmap, streaming (chunks of TRACE_CHUNK runs, killed
    # after one chunk and
    # resumed) and sharded give torch.equal leaves and byte-identical
    # reports
    work = ROOT / "build" / "trace_smoke"
    shutil.rmtree(work, ignore_errors=True)
    work.mkdir(parents=True)
    spec = fleet.SweepSpec.build(
        "trace_backends", dataclasses.replace(
            base, sim_time_s=BACKEND_SIM_S, **TRACE),
        strategies=(dist,), num_runs=runs, seed=0)
    (pt,) = spec.expand()
    t0 = time.perf_counter()
    K.reset_launches()
    res = {"vmap": fleet.run_point(pt, backend="vmap")}
    part = fleet.ResultStore(str(work / "resume"))
    try:
        fleet.run_point(pt, backend="streaming", store=part,
                        chunk_size=TRACE_CHUNK, max_chunks=1)
        check(False, "max_chunks=1 did not interrupt the traced sweep")
    except fleet.SweepInterrupted:
        pass
    res["streaming, killed + resumed"] = fleet.run_point(
        pt, backend="streaming", store=part, chunk_size=TRACE_CHUNK)
    res["sharded"] = fleet.run_point(pt, backend="sharded")
    res["store hit"] = fleet.run_point(pt, backend="vmap", store=part)
    chunks = -(-runs // TRACE_CHUNK)
    check(K.LAUNCHES["phi_update"] == epochs(pt.cfg) * (2 + chunks),
          f"traced backends: phi_update launched {K.LAUNCHES['phi_update']} "
          f"times, expected {epochs(pt.cfg) * (2 + chunks)}")
    launches["phi_update"] += K.LAUNCHES["phi_update"]
    want = res["vmap"]
    reports = {b: json.dumps(fleet.build_report(
        {pt.label: m}, tick_s=pt.cfg.tick_s, cfg=pt.cfg), sort_keys=True)
        for b, m in res.items()}
    for b, m in res.items():
        m = dict(m)
        if b == "store hit":
            # result.json keeps a record buffer up to its last written slot
            for k in ("trace_records", "trace_hops"):
                kept = m[k].shape[1]
                check(not (want[k][:, kept:, 0] >= 0).any(),
                      f"traced store hit: {k} lost written slots")
                m[k] = np.concatenate([m[k], want[k][:, kept:]], axis=1)
        bad = [k for k in want if k not in m
               or not np.array_equal(m[k], want[k])]
        check(not bad, f"traced {b} != vmap: {bad}")
        check(reports[b] == reports["vmap"],
              f"traced {b}: report differs from vmap's")
    log(f"[trace] backends at {BACKEND_SIM_S:g} s, {runs} runs, all three "
        f"streams: streaming (chunks of {TRACE_CHUNK}) killed after one "
        f"chunk and resumed, "
        f"sharded and a store hit equal vmap on every leaf, reports "
        f"byte-identical ({time.perf_counter() - t0:.2f} s)")
    shutil.rmtree(work, ignore_errors=True)

    # the two channels of this slice, dense at the default point
    for ch in ("log_normal_corr", "nakagami"):
        c = dataclasses.replace(base, sim_time_s=CHANNEL_SIM_S,
                                channel_model=ch)
        m, w = run(c, dist, what=ch)
        plain, _ = run(c, dist, plain=True, what=f"{ch}, plain")
        bad = all_equal(m, plain)
        check(not bad, f"{ch}: kernel path != plain path: {bad}")
        check(bool((m["transfers"] > 0).any()), f"{ch}: no transfers")
        log(f"[channel] {ch}: {runs} runs x {c.sim_time_s:g} s, N={n}, "
            f"Distributed: wall {w:.2f} s; kernel path torch.equal to the "
            f"plain path on all {len(m)} metrics; {summary(m)}")
    # nakagami per edge on the sparse path, task and hop streams on
    c = dataclasses.replace(base, **SPARSE_NAKAGAMI)
    m, w = run(c, dist, n=c.num_workers, runs=c.num_runs,
               what="sparse nakagami")
    plain, _ = run(c, dist, plain=True, n=c.num_workers, runs=c.num_runs,
                   what="sparse nakagami, plain")
    bad = all_equal(m, plain)
    check(not bad, f"sparse nakagami: kernel path != plain path: {bad}")
    counts = check_accounting(trace, m, "sparse nakagami")
    log(f"[channel] nakagami_edges, sparse N={c.num_workers} "
        f"K={c.neighbor_k} R={c.num_runs} {c.sim_time_s:g} s, task and hop "
        f"streams on: wall {w:.2f} s; kernel path torch.equal to the plain "
        f"path on all {len(m)} leaves; {counts[0]} task records, "
        f"{counts[2]} hop records (overflow {counts[1]}, {counts[3]})")

    # the reference artifact's fig_state point: a record, not a check (the
    # artifact's jax drew other random streams: ROADMAP.md caveats)
    fs = fleet.SweepSpec.build(
        "fig_state", dataclasses.replace(base, **FIG_STATE),
        strategies=(dist,), num_runs=4)
    got = fleet.build_report(fleet.execute(fs))["points"][FIG_STATE_POINT]
    art = json.loads(ARTIFACT.read_text())["sweep:fig_state"]["points"][
        FIG_STATE_POINT]
    for k in ("phi_residual_curve", "phi_epochs_to_eps",
              "completion_rate_final"):
        log(f"[trace] fig_state {FIG_STATE_POINT} ({FIG_STATE}, 4 runs) "
            f"{k}: port {got[k]}; artifact {art[k]}")

    # the trace overhead at the dense point: wall and kernels an epoch
    cfg_t = dataclasses.replace(base, **TRACE)
    per = {"untraced": epoch_launches(S, rng, base, dist),
           "traced": epoch_launches(S, rng, cfg_t, dist)}
    w0, w1 = walls["Distributed"]
    log(f"[trace] overhead, dense N={n} R={runs} Distributed: wall an "
        f"epoch {w0 * 1e3:.1f} ms untraced, {w1 * 1e3:.1f} ms traced "
        f"(x{w1 / w0:.3f}); kernels an epoch {per['untraced']:.0f} "
        f"untraced, {per['traced']:.0f} traced (+{per['traced'] - per['untraced']:.0f})")
    log(f"[trace] phase 4c took {time.perf_counter() - t_phase:.1f} s")
    return launches


# ---------------------------------------------------------------------------
# phase 5: attention kernels against their plain versions
# ---------------------------------------------------------------------------

SERVE_FLASH = (4, 512, 16, 8, 128)            # B, S, Hq, Hkv, hd (bf16)
HYBRID_FLASH = (4, 512, 16, 1, 256)           # recurrentgemma's prefill
SERVE_DECODE = (4, 1024, 16, 8, 128)          # B, S, Hq, Hkv, hd (bf16)
MOE_FLASH = (4, 512, 16, 8, 64)               # granite-moe's prefill
VLM_FLASH = (4, 512, 12, 2, 128)              # qwen2-vl's prefill, G = 6
MOE_DECODE = (4, 1024, 16, 8, 64)             # their decode caches
VLM_DECODE = (4, 1024, 12, 2, 128)
# whisper-medium (16 heads of 64, MHA, 1500 frames): the encoder's
# bidirectional attention, the decoder's cross attention at training's 448
# tokens (B, Sq, Sk, Hq, Hkv, hd), and the cross decode's cache with the
# reference's query position F - 1 + 10**9 (B, S, Hq, Hkv, hd, pos)
WHISPER_ENC = (4, 1500, 1500, 16, 16, 64)
WHISPER_CROSS = (4, 448, 1500, 16, 16, 64)
WHISPER_XDECODE = (4, 1500, 16, 16, 64, 1499 + 10 ** 9)
FLASH_SHAPES = [  # B, S, Hq, Hkv, hd, causal, window, dtype
    (2, 128, 4, 2, 64, True, 0, torch.float32),   # tests/test_kernels.py
    (1, 256, 8, 1, 128, True, 0, torch.bfloat16),
    (2, 128, 4, 4, 64, False, 0, torch.float32),
    (1, 256, 4, 2, 64, True, 64, torch.float32),
    (1, 128, 2, 2, 256, True, 0, torch.bfloat16),
    (*SERVE_FLASH, True, 0, torch.bfloat16),      # the serving path
    (4, 200, 16, 8, 128, True, 0, torch.bfloat16),  # not multiples of 128
    (4, 1000, 16, 8, 128, True, 0, torch.bfloat16),
    (*HYBRID_FLASH, True, 0, torch.bfloat16),     # recurrentgemma, MQA
    (1, 1000, 4, 1, 256, True, 256, torch.bfloat16),  # a window that bites
    (2, 77, 4, 2, 16, True, 0, torch.bfloat16),   # every head_dim, ragged
    (2, 100, 4, 2, 32, True, 0, torch.bfloat16),
    (2, 130, 4, 2, 64, True, 0, torch.bfloat16),
    (*MOE_FLASH, True, 0, torch.bfloat16),        # granite-moe, hd 64
    (*VLM_FLASH, True, 0, torch.bfloat16),        # qwen2-vl, 12 / 2 heads
]
# Sq != Sk and the non-causal rows of whisper (B, Sq, Sk, Hq, Hkv, hd,
# causal, window, dtype): 1500 keys are not a multiple of the 64-key tile
FLASH_SQ_SK_SHAPES = [
    (*WHISPER_ENC, False, 0, torch.bfloat16),     # the encoder
    (*WHISPER_CROSS, False, 0, torch.bfloat16),   # cross attention, training
    (4, 64, 1500, 16, 16, 64, False, 0, torch.bfloat16),  # its prefill
    (4, 64, 64, 16, 16, 64, True, 0, torch.bfloat16),     # decoder self
    (2, 100, 1500, 4, 4, 64, False, 0, torch.float32),
    (2, 150, 90, 4, 4, 32, False, 0, torch.bfloat16),
    (1, 77, 300, 4, 2, 128, False, 0, torch.bfloat16),
]
DECODE_SHAPES = [  # B, S, Hq, Hkv, hd, pos, window, dtype
    (2, 256, 8, 2, 64, 100, 0, torch.float32),    # tests/test_kernels.py
    (1, 512, 4, 1, 128, 511, 0, torch.bfloat16),
    (2, 256, 4, 4, 64, 200, 64, torch.float32),
] + [(*SERVE_DECODE, pos, 0, torch.bfloat16) for pos in (0, 511, 575, 1023)
    # on the boundaries of the split plan at the serving shape: one split
    # (31, 63), the last split one slot long (64, 128), the range an exact
    # number of chunks (127; 575 and 1023 above)
    ] + [(*SERVE_DECODE, pos, 0, torch.bfloat16)
         for pos in (31, 63, 64, 127, 128)
         ] + [(*shape, pos, 0, torch.bfloat16)         # granite-moe, qwen2-vl
              for shape in (MOE_DECODE, VLM_DECODE)
              for pos in (0, 63, 575, 1023)
              ] + [(*WHISPER_XDECODE, 0, torch.bfloat16),  # whisper's decode:
                   (*WHISPER_XDECODE[:5], 1499, 0, torch.bfloat16),  # cross,
                   (4, 128, 16, 16, 64, 64, 0, torch.bfloat16),  # self at the
                   (4, 128, 16, 16, 64, 127, 0, torch.bfloat16)]  # ends


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
        check(torch.equal(got, FA.flash_attention(q, k, v, causal=causal,
                                                  window=win)),
              f"flash at {(B, S, Hq, Hkv, hd, causal, win, dt)}: two "
              f"launches differ")
    for B, Sq, Sk, Hq, Hkv, hd, causal, win, dt in FLASH_SQ_SK_SHAPES:
        q, k, v = attn_inputs((B, Sq, Hq, hd), (B, Sk, Hkv, hd), dt, gen)
        got = FA.flash_attention(q, k, v, causal=causal, window=win)
        want = ref.flash_attention(q, k, v, causal=causal, window=win)
        torch.cuda.synchronize()
        what = f"flash at {(B, Sq, Sk, Hq, Hkv, hd, causal, win, dt)}"
        err["flash_attention"] = max(err["flash_attention"], assert_close(
            got, want, attn_tol(dt), what))
        check(torch.equal(got, FA.flash_attention(q, k, v, causal=causal,
                                                  window=win)),
              f"{what}: two launches differ")
        del q, k, v, got, want
    for B, S, Hq, Hkv, hd, pos, win, dt in DECODE_SHAPES:
        q, k, v = attn_inputs((B, Hq, hd), (B, S, Hkv, hd), dt, gen)
        got = DA.decode_attention(q, k, v, pos, window=win)
        want = ref.decode_attention(q, k, v, pos, window=win)
        torch.cuda.synchronize()
        e = assert_close(got, want, attn_tol(dt), f"decode at "
                         f"{(B, S, Hq, Hkv, hd, pos, win, dt)}")
        err["decode_attention"] = max(err["decode_attention"], e)
        again = [DA.decode_attention(q, k, v, pos, window=win)
                 for _ in range(50)]
        check(all(torch.equal(got, x) for x in again),
              f"decode at {(B, S, Hq, Hkv, hd, pos, win, dt)}: 50 launches "
              f"differ")
    log(f"[attention] kernels match their plain versions (rtol=atol 3e-5 "
        f"f32, 2e-2 bf16) at flash {[x[:7] for x in FLASH_SHAPES]}, Sq "
        f"!= Sk {[x[:8] for x in FLASH_SQ_SK_SHAPES]} and "
        f"decode {[x[:7] for x in DECODE_SHAPES]}; two launches of flash "
        f"and 51 of decode give equal outputs at every shape; max_abs_err "
        f"{err}")
    return err


_FLUSH = []


def flush_l2() -> None:
    """Write 256 MB, five times the card's 50 MB of L2, so that the next
    call finds its inputs in device memory, as a layer of a real forward
    finds its own weights and caches."""
    if not _FLUSH:
        _FLUSH.append(torch.empty(256 * 2 ** 20, dtype=torch.uint8,
                                  device="cuda"))
    _FLUSH[0].zero_()


def event_ms(fn, reps=50, warmup=5, cold=False) -> float:
    """Median device time of one call: each of ``reps`` calls after warm-up
    between its own pair of CUDA events.  A sleep kernel first lets the
    host queue every call before the device reaches them, so the host's
    launch time stays out of the pairs.  ``cold``: L2 is flushed before
    each call, outside its pair of events."""
    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    pairs = [(torch.cuda.Event(enable_timing=True),
              torch.cuda.Event(enable_timing=True)) for _ in range(reps)]
    torch.cuda._sleep(100_000_000)
    for a, b in pairs:
        if cold:
            flush_l2()
        a.record()
        fn()
        b.record()
    torch.cuda.synchronize()
    return statistics.median(a.elapsed_time(b) for a, b in pairs)


def timed(kern, plain, library, bound, plain_reps=50) -> dict:
    """The JSON fields of one kernel: warm and cold times of the kernel and
    of the library call (None where there is none), the plain version's
    warm time (the median of ``plain_reps`` calls), the bound."""
    return {"ms": event_ms(kern), "cold_ms": event_ms(kern, cold=True),
            "plain_ms": event_ms(plain, reps=plain_reps,
                                 warmup=min(5, plain_reps)),
            "bound_ms": bound[0],
            "bound_by": bound[1],
            "library_ms": None if library is None else event_ms(library),
            "library_cold_ms": None if library is None
            else event_ms(library, cold=True)}


def timing_line(name, shape, t) -> str:
    lib = "none" if t["library_ms"] is None else \
        f"{t['library_ms']:.5f} ms (cold {t['library_cold_ms']:.5f})"
    return (f"[timing] {name} {shape}: kernel {t['ms']:.5f} ms (cold "
            f"{t['cold_ms']:.5f}), plain {t['plain_ms']:.5f} ms, library "
            f"{lib}, bound {t['bound_ms']:.6f} ms ({t['bound_by']}), "
            f"{t['bound_ms'] / t['ms']:.3f} of bound warm, "
            f"{t['bound_ms'] / t['cold_ms']:.3f} cold")


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


def attn_bound_ms(B, Sq, Sk, Hq, Hkv, hd, causal, bwd=False, elt=2,
                  rate=BF16_OPS_PER_S) -> tuple:
    """Flash attention at any (Sq, Sk): forward, q, k and v read and the
    output written once, 4·hd flops a kept (query, key) pair; backward
    (``bwd``), q, k, v, o and dO read and dQ, dK and dV written once, 10·hd
    flops a kept pair.  The causal mask keeps Sq·(Sq+1)/2 pairs a head
    where Sq == Sk, every pair otherwise."""
    pairs = B * Hq * (Sq * (Sq + 1) // 2 if causal and Sq == Sk
                      else Sq * Sk)
    q_side, kv_side = B * Sq * Hq * hd, B * Sk * Hkv * hd
    k = 4 if bwd else 2
    return roofline_ms(elt * k * (q_side + kv_side),
                       (10 if bwd else 4) * hd * pairs, rate)


def decode_bound_ms(B, S, Hq, Hkv, hd, pos, elt=2,
                    rate=BF16_OPS_PER_S) -> tuple:
    """q read and the output written once, the kept K and V rows (slots
    0..pos) read once; 4·hd flops a (query head, kept slot)."""
    kept = min(pos, S - 1) + 1
    nbytes = elt * (2 * B * Hq * hd + 2 * B * kept * Hkv * hd)
    return roofline_ms(nbytes, 4 * hd * B * Hq * kept, rate)


def phase_attention_timing(FA, DA, ref, gen) -> dict:
    """Kernel, plain version and SDPA at the serving shapes (bf16): flash
    at the prefills of qwen3, recurrentgemma, granite-moe and qwen2-vl (the
    JSON row is qwen3's), decode at positions 1023 (the JSON row) and 575
    of qwen3's cache and at 1023 of granite-moe's and qwen2-vl's."""
    sdpa = torch.nn.functional.scaled_dot_product_attention
    one = torch.empty(1, device="cuda")
    log(f"[timing] CUDA events around one launch of an empty kernel (a "
        f"one-element zero_()): {event_ms(one.zero_):.5f} ms, in every time "
        f"below")
    out = {}
    for shape in (SERVE_FLASH, HYBRID_FLASH, MOE_FLASH, VLM_FLASH):
        B, S, Hq, Hkv, hd = shape
        q, k, v = attn_inputs((B, S, Hq, hd), (B, S, Hkv, hd),
                              torch.bfloat16, gen)
        qt, kt, vt = (x.transpose(1, 2).contiguous() for x in (q, k, v))
        lib_out = sdpa(qt, kt, vt, is_causal=True, enable_gqa=True)
        assert_close(lib_out.transpose(1, 2), FA.flash_attention(q, k, v),
                     2e-2, "SDPA yardstick against the flash kernel")
        t = timed(lambda: FA.flash_attention(q, k, v),
                  lambda: ref.flash_attention(q, k, v),
                  lambda: sdpa(qt, kt, vt, is_causal=True, enable_gqa=True),
                  flash_bound_ms(B, S, Hq, Hkv, hd))
        log(timing_line("flash_attention", f"{shape} causal bf16", t))
        out.setdefault("flash_attention", t)
        del q, k, v, qt, kt, vt
    for shape, positions in ((SERVE_DECODE, (1023, 575)),
                             (MOE_DECODE, (1023,)), (VLM_DECODE, (1023,))):
        B, S, Hq, Hkv, hd = shape
        q, k, v = attn_inputs((B, Hq, hd), (B, S, Hkv, hd), torch.bfloat16,
                              gen)
        for pos in positions:
            q4 = q[:, :, None, :]
            kt, vt = (x[:, :pos + 1].transpose(1, 2).contiguous()
                      for x in (k, v))
            lib_out = sdpa(q4, kt, vt, enable_gqa=True)
            assert_close(lib_out[:, :, 0], DA.decode_attention(q, k, v, pos),
                         2e-2, "SDPA yardstick against the decode kernel")
            t = timed(lambda p=pos: DA.decode_attention(q, k, v, p),
                      lambda p=pos: ref.decode_attention(q, k, v, p),
                      lambda a=kt, b=vt: sdpa(q4, a, b, enable_gqa=True),
                      decode_bound_ms(B, S, Hq, Hkv, hd, pos))
            log(timing_line("decode_attention", f"{shape} pos {pos} bf16", t))
            out.setdefault("decode_attention", t)
    # whisper's rows: the encoder and the cross attention, non-causal
    for shape in (WHISPER_ENC, WHISPER_CROSS):
        B, Sq, Sk, Hq, Hkv, hd = shape
        q, k, v = attn_inputs((B, Sq, Hq, hd), (B, Sk, Hkv, hd),
                              torch.bfloat16, gen)
        qt, kt, vt = (x.transpose(1, 2).contiguous() for x in (q, k, v))
        assert_close(sdpa(qt, kt, vt).transpose(1, 2),
                     FA.flash_attention(q, k, v, causal=False), 2e-2,
                     "SDPA yardstick against the flash kernel, non-causal")
        t = timed(lambda: FA.flash_attention(q, k, v, causal=False),
                  lambda: ref.flash_attention(q, k, v, causal=False),
                  lambda: sdpa(qt, kt, vt),
                  attn_bound_ms(B, Sq, Sk, Hq, Hkv, hd, False))
        log(timing_line("flash_attention", f"{shape} non-causal bf16", t))
        del q, k, v, qt, kt, vt
    B, S, Hq, Hkv, hd, pos = WHISPER_XDECODE
    q, k, v = attn_inputs((B, Hq, hd), (B, S, Hkv, hd), torch.bfloat16, gen)
    q4 = q[:, :, None, :]
    kt, vt = (x.transpose(1, 2).contiguous() for x in (k, v))
    assert_close(sdpa(q4, kt, vt)[:, :, 0], DA.decode_attention(q, k, v, pos),
                 2e-2, "SDPA yardstick against the cross decode")
    t = timed(lambda: DA.decode_attention(q, k, v, pos),
              lambda: ref.decode_attention(q, k, v, pos),
              lambda: sdpa(q4, kt, vt),
              decode_bound_ms(B, S, Hq, Hkv, hd, pos))
    log(timing_line("decode_attention", f"{WHISPER_XDECODE[:5]} pos "
                    f"F - 1 + 10**9 bf16 (whisper's cross decode)", t))
    return out


# ---------------------------------------------------------------------------
# phases 6 and 7: serving qwen3-1.7b at full width
# ---------------------------------------------------------------------------

SERVE_ARGS = dict(requests=16, batch=4, seq=512, executors=4, burst=8)


def rel_err(a: torch.Tensor, b: torch.Tensor) -> float:
    """max |a - b| over max |b|."""
    a, b = a.float(), b.float()
    return float((a - b).abs().max() / b.abs().max())


def phase_serve(cfg, params, serve, schema, ops, KB, hold_logits=True
                ) -> dict:
    """Split-serve with the kernels and under ``ops.reference()``:
    counters, exit labels and records identical, logits within 5e-2 of the
    largest.  ``hold_logits=False`` (the moe family) records the logits'
    difference instead of holding it: a token whose top-k router logits
    nearly tie may take another expert on the other path (phase 11 holds
    the moe layers by its route-aware rule)."""
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
    limit = "(limit 5e-2)" if hold_logits else "(a record, not a check)"
    log(f"[serve] under ops.reference(): counters, exit labels and records "
        f"identical; stashed logits differ by {err:.4g} of the largest "
        f"{limit}; plain wall {plain.wall_s:.3f} s")
    if hold_logits:
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
    """Prefill (from tokens, or from embeds when ``prompt`` is floating),
    copy the k/v into a CACHE-slot cache, decode ``steps`` tokens:
    greedily, or the ``forced`` ones.  Returns (logits per step, starting
    with the prefill's last, tokens fed, prefill s, decode s)."""
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    last, pc = model.prefill(params, {"embeds": prompt}
                             if prompt.is_floating_point()
                             else {"tokens": prompt})
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


def phase_decode(cfg, params, build_model, ops, KB, gen) -> tuple:
    """Returns (launches, the lever-off record ``lever_off`` makes)."""
    model = build_model(cfg)
    prompt = torch.randint(0, cfg.vocab_size, (DECODE_B, PROMPT),
                           device=params.embed.device, generator=gen)
    with torch.inference_mode():
        decode_run(model, params, prompt[:, :128], 2)       # warm-up
        torch.cuda.reset_peak_memory_stats()
        KB.reset_launches()
        logits, fed, t_pre, t_dec, kv_bytes = decode_run(model, params,
                                                         prompt, STEPS)
        launches = dict(KB.LAUNCHES)
        off = lever_off(model, params, prompt, logits, t_dec, launches)
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
        norms = (4 * L + 1) * (1 + STEPS)      # ln1, ln2, q/k norms; final
        check(launches["rmsnorm"] == norms,
              f"rmsnorm launched {launches['rmsnorm']} times, expected "
              f"{norms}")
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
    return launches, off


# ---------------------------------------------------------------------------
# the cast_weights_bf16 lever (phases 7, 9 and 10): the weights cast once
# ---------------------------------------------------------------------------


def weights_gb(params) -> float:
    return sum(p.numel() * p.element_size()
               for p in params.parameters()) / 1e9


def step_launches(model, params, prompt) -> int:
    """CUDA kernels of one decode step from a token at the last position of
    the greedy run (575) in a CACHE-slot cache, by torch.profiler (a prompt
    of embeds, the vlm's, decodes token 0)."""
    with torch.inference_mode():
        caches = model.init_cache(DECODE_B, CACHE)
        token = torch.zeros((DECODE_B, 1), dtype=torch.long,
                            device=prompt.device) \
            if prompt.is_floating_point() else prompt[:, :1]
        batch = {"token": token, "pos": PROMPT + STEPS - 1}
        return device_launches(
            lambda: model.decode_step(params, caches, batch), ())


def lever_off(model, params, prompt, logits, t_dec, launches) -> dict:
    """What the lever-on run is compared with: the greedy run's logits,
    its decode time and kernel launches, the peak memory since the last
    reset, the launches of one step and the weights' size."""
    return {"logits": logits, "t_dec": t_dec, "launches": launches,
            "peak": torch.cuda.max_memory_allocated() / 2 ** 30,
            "step": step_launches(model, params, prompt),
            "gb": weights_gb(params), "prompt": prompt}


def lever_on(tag, model, run, params, KB, off, equal: bool) -> dict:
    """``run(params, prompt, steps)`` (prefill + greedy decode, returning
    (logits, ..., decode s, ...)) on the weights cast once; with ``equal``
    its logits are held ``torch.equal`` to the lever-off run's.  Prints
    decode tokens/s, kernels a step and peak memory, on and off."""
    prompt = off["prompt"]
    run(params, prompt[:, :128], 2)                               # warm-up
    torch.cuda.reset_peak_memory_stats()
    KB.reset_launches()
    logits, _, _, t_dec, _ = run(params, prompt, STEPS)
    launches = dict(KB.LAUNCHES)
    peak = torch.cuda.max_memory_allocated() / 2 ** 30
    step = step_launches(model, params, prompt)
    check(launches == off["launches"],
          f"{tag}: lever on launched {launches}, off {off['launches']}")
    check(bool(torch.isfinite(logits).all()), f"{tag}: lever-on logits")
    same = torch.equal(logits, off["logits"])
    if equal:
        check(same, f"{tag}: lever-on logits != lever-off logits")
    if same:
        outcome = "torch.equal to the lever-off run"
    else:
        first = (logits[:, 0].float() - off["logits"][:, 0].float()).abs()
        agree = (logits.argmax(-1) == off["logits"].argmax(-1)).all(0)
        outcome = (f"differ from the lever-off run (falcon-mamba reads "
                   f"x_proj, dt_proj and A_log in float32): prefill's last "
                   f"by max abs {float(first.max()):.4g} (max |logit| "
                   f"{float(off['logits'][:, 0].float().abs().max()):.4g}), "
                   f"greedy tokens equal for the first "
                   f"{int(agree.long().cumprod(0).sum())} of {STEPS + 1} "
                   f"steps")
    log(f"[{tag}] cast_weights_bf16 on, weights cast once: "
        f"{off['gb']:.3f} -> {weights_gb(params):.3f} GB; decode "
        f"{DECODE_B * STEPS / off['t_dec']:.1f} -> "
        f"{DECODE_B * STEPS / t_dec:.1f} tokens/s, kernels a decode step "
        f"{off['step']} -> {step}, peak memory {off['peak']:.2f} -> "
        f"{peak:.2f} GiB (off -> on); the same hand-kernel launches; "
        f"logits over prefill and {STEPS} steps {outcome}")
    return launches


# ---------------------------------------------------------------------------
# phase 8: the norm and scan kernels against their plain versions
# ---------------------------------------------------------------------------

NORM_SHAPES = [  # shape, dtype
    ((4, 64, 256), torch.float32),                # tests/test_kernels.py
    ((8, 128), torch.bfloat16),
    ((3, 7, 512), torch.float32),
    ((2048, 4096), torch.bfloat16),               # the recurrent prefills
    ((4, 1, 4096), torch.bfloat16),               # their decode
    ((4, 512, 16, 128), torch.bfloat16),          # qwen3's qk-norm
    ((4, 512, 2048), torch.bfloat16),             # qwen3's layer norms
    ((4, 512, 1024), torch.bfloat16),             # granite-moe's
    ((4, 512, 1536), torch.bfloat16),             # qwen2-vl's
    ((5, 100), torch.float32),                    # ragged
]
RGLRU_SHAPES = [(2, 128, 128), (1, 512, 256), (3, 64, 128),   # test_kernels
                (4, 512, 4096),                   # recurrentgemma prefill
                (2, 37, 100)]
MAMBA_SHAPES = [(2, 64, 128, 16), (1, 128, 256, 8),           # test_kernels
                (4, 512, 8192, 16),               # falcon-mamba prefill
                (2, 37, 100, 4)]
SERVE_RGLRU, SERVE_MAMBA = (4, 512, 4096), (4, 512, 8192, 16)
# rmsnorm timed at the recurrent prefills' rows (the JSON row's numbers),
# qwen3's prefill qk-norm and a recurrent decode step
NORM_TIMED = [(2048, 4096), (4, 512, 16, 128), (4, 1, 4096)]


def scan_inputs(shape, gen, c_shape=None):
    """a ~ U[0.5, 0.999], b ~ N(0, 1) (x 0.1 with C), C ~ N(0, 1), as
    tests/test_kernels.py draws them."""
    a = torch.rand(shape, device="cuda", generator=gen) * 0.499 + 0.5
    b = torch.randn(shape, device="cuda", generator=gen)
    if c_shape is None:
        return a, b
    return a, b * 0.1, torch.randn(c_shape, device="cuda", generator=gen)


def norm_inputs(shape, dtype, gen):
    x = torch.randn(shape, device="cuda", generator=gen).to(dtype)
    return x, torch.randn(shape[-1], device="cuda", generator=gen)


def phase_scans(RN, RG, MB, ref, gen) -> dict:
    err = {"rmsnorm": 0.0, "rglru_scan": 0.0, "mamba_scan": 0.0}
    for shape, dt in NORM_SHAPES:
        x, s = norm_inputs(shape, dt, gen)
        got, want = RN.rmsnorm(x, s), ref.rmsnorm(x, s)
        torch.cuda.synchronize()
        err["rmsnorm"] = max(err["rmsnorm"], assert_close(
            got, want, attn_tol(dt), f"rmsnorm at {shape} {dt}"))
    exact = True
    for shape in RGLRU_SHAPES:
        a, b = scan_inputs(shape, gen)
        got, want = RG.rglru_scan(a, b), ref.rglru_scan(a, b)
        torch.cuda.synchronize()
        err["rglru_scan"] = max(err["rglru_scan"], assert_close(
            got, want, 3e-5, f"rglru_scan at {shape}"))
        exact &= torch.equal(got, want)
    for shape in MAMBA_SHAPES:
        B, S, D, N = shape
        a, b, C = scan_inputs(shape, gen, c_shape=(B, S, N))
        (y, h), (wy, wh) = MB.mamba_scan_with_state(a, b, C), \
            ref.mamba_scan_with_state(a, b, C)
        torch.cuda.synchronize()
        err["mamba_scan"] = max(
            err["mamba_scan"],
            assert_close(y, wy, 2e-4, f"mamba_scan y at {shape}", atol=3e-5),
            assert_close(h, wh, 2e-4, f"mamba_scan h_last at {shape}",
                         atol=3e-5))
        exact &= torch.equal(h, wh)
        # the training entry point: the same y and h_last, and the states
        # at every checkpoint equal to the plain loop's
        y2, h2, chk = MB.mamba_scan_with_checkpoints(a, b, C)
        want_chk = ref.mamba_scan_checkpoints(a, b)
        torch.cuda.synchronize()
        check(torch.equal(y2, y) and torch.equal(h2, h),
              f"mamba_scan_with_checkpoints y / h_last at {shape} differ "
              f"from mamba_scan_with_state's")
        check(torch.equal(chk, want_chk), f"mamba_scan_with_checkpoints "
              f"h_chk at {shape}: max abs err "
              f"{float((chk - want_chk).abs().max()):.3g} against the twin")
        del a, b, C, y, h, wy, wh, y2, h2, chk, want_chk
    log(f"[scans] kernels match their plain versions (rmsnorm 3e-5 f32 / "
        f"2e-2 bf16 at {[x[0] for x in NORM_SHAPES]}; rglru_scan 3e-5 at "
        f"{RGLRU_SHAPES}; mamba_scan y and h_last at rtol 2e-4 atol 3e-5 at "
        f"{MAMBA_SHAPES}); the scans' states equal the plain loop's bit for "
        f"bit: {exact}; max_abs_err {err}; the checkpointing entry point's "
        f"y and h_last torch.equal to the contract entry point's and its "
        f"checkpoints (every {ref.CHECKPOINT_EVERY} steps) to the twin's at "
        f"every shape")
    return err


def phase_scan_timing(RN, RG, MB, ref, gen) -> dict:
    """Kernel, plain version and (rmsnorm) F.rms_norm at the main path's
    shapes; the bound counts each input read once and each output written
    once, and the f32 operations an element: 4 for rmsnorm (the square's
    multiply-add, two products), 2 for rglru (a product and a sum), 4 for
    mamba (the update, the readout's multiply-add)."""
    out = {}
    lib = torch.nn.functional.rms_norm
    shapes = []
    for shape in NORM_TIMED:
        x, s = norm_inputs(shape, torch.bfloat16, gen)
        s16 = s.to(torch.bfloat16)
        d = shape[-1]
        rows = x.numel() // d
        assert_close(lib(x, (d,), s16, 1e-6), RN.rmsnorm(x, s), 2e-2,
                     f"F.rms_norm yardstick against the rmsnorm kernel at "
                     f"{shape}")
        t = timed(lambda: RN.rmsnorm(x, s), lambda: ref.rmsnorm(x, s),
                  lambda: lib(x, (d,), s16, 1e-6),
                  roofline_ms(2 * rows * d * 2 + 4 * d, 4 * rows * d,
                              FP32_OPS_PER_S))
        t["call_ms"] = call_ms(RN.rmsnorm, (x, s))
        log(timing_line("rmsnorm", f"{shape} bf16", t) +
            f"; one call with its host side {t['call_ms']:.5f} ms")
        shapes.append({"shape": list(shape), **t})
    out["rmsnorm"] = {**shapes[0], "shapes": shapes}
    del out["rmsnorm"]["shape"]
    a, b = scan_inputs(SERVE_RGLRU, gen)
    n = a.numel()
    out["rglru_scan"] = timed(
        lambda: RG.rglru_scan(a, b), lambda: ref.rglru_scan(a, b), None,
        roofline_ms(3 * 4 * n, 2 * n, FP32_OPS_PER_S))
    h = torch.empty_like(a)
    add_ms = event_ms(lambda: torch.add(a, b, out=h))
    add_cold = event_ms(lambda: torch.add(a, b, out=h), cold=True)
    log(f"[timing] yardstick, not the same function: torch.add(a, b, out=h) "
        f"at {SERVE_RGLRU} f32 moves rglru_scan's bytes (a and b read, h "
        f"written) in {add_ms:.5f} ms (cold {add_cold:.5f})")
    del a, b, h
    B, S, D, N = SERVE_MAMBA
    a, b, C = scan_inputs(SERVE_MAMBA, gen, c_shape=(B, S, N))
    n = a.numel()
    out["mamba_scan"] = timed(
        lambda: MB.mamba_scan_with_state(a, b, C),
        lambda: ref.mamba_scan_with_state(a, b, C), None,
        roofline_ms(4 * (2 * n + B * S * N + B * S * D + B * D * N), 4 * n,
                    FP32_OPS_PER_S))
    del a, b, C
    for name, shape in (("rglru_scan", f"{SERVE_RGLRU} f32"),
                        ("mamba_scan", f"{SERVE_MAMBA} f32")):
        log(timing_line(name, shape, out[name]))
    torch.cuda.empty_cache()
    return out


# ---------------------------------------------------------------------------
# phases 9 and 10: the recurrent families at full width
# ---------------------------------------------------------------------------

REF_STEPS = 8      # teacher-forced decode steps held against the plain path


def recurrent_run(prefill_step, decode_step, params, prompt, steps,
                  forced=None):
    """Prefill, then ``steps`` decode steps: greedy, or the ``forced``
    tokens.  Returns (logits per step, starting with the prefill's last,
    tokens fed, prefill s, decode s, cache bytes)."""
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    last, caches = prefill_step(params, {"tokens": prompt})
    torch.cuda.synchronize()
    t1 = time.perf_counter()
    out, fed, logits = [last], [], last
    P = prompt.shape[1]
    for t in range(steps):
        nxt = logits.argmax(-1)[:, None] if forced is None \
            else forced[:, t:t + 1]
        fed.append(nxt)
        logits, caches = decode_step(params, caches,
                                     {"token": nxt, "pos": P + t})
        out.append(logits)
    torch.cuda.synchronize()
    nbytes = sum(x.numel() * x.element_size() for pair in caches
                 for x in pair)
    return (torch.stack(out, 1), torch.cat(fed, 1), t1 - t0,
            time.perf_counter() - t1, nbytes)


def layer_by_layer(layer, n_layers, h, ops, what) -> float:
    """Each layer run with the kernels and under ``ops.reference()`` on the
    plain path's input, held at the logits' tolerance; returns the largest
    error over max(1, max |h|)."""
    worst = 0.0
    for i in range(n_layers):
        with ops.reference():
            want = layer(i, h)
        got = layer(i, h)
        scale = max(1.0, float(want.float().abs().max()))
        worst = max(worst, logits_close(got, want, f"{what} layer {i}")
                    / scale)
        h = want
    return worst


def ulp_nudge(x: torch.Tensor, gen) -> torch.Tensor:
    """Every element of a bf16 tensor moved by one bf16 ulp, its magnitude
    up or down at random (zeros up)."""
    bits = x.view(torch.int16)
    up = torch.rand(x.shape, device=x.device, generator=gen) < 0.5
    up |= (bits & 0x7FFF) == 0
    return (bits + torch.where(up, 1, -1).to(torch.int16)).view(torch.bfloat16)


def phase_recurrent(arch, expect, layer, get_config, build_model, step, ops,
                    KB, gen, head_out) -> tuple:
    """``expect(cfg)`` gives the launches of one prefill by kernel; decode
    steps launch only rmsnorm (``expect(cfg)['rmsnorm']`` each).
    ``layer(cfg, params, i, h, positions)`` runs layer i alone.  Then the
    cast_weights_bf16 lever: the weights cast once, the same greedy run
    again; returns (launches lever off, launches lever on)."""
    cfg = get_config(arch)
    model = build_model(cfg)
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    params = model.init(torch.Generator(device="cuda").manual_seed(0))
    torch.cuda.synchronize()
    nparams = sum(p.numel() for p in params.parameters())
    log(f"[{arch}] {nparams} parameters ({cfg.param_dtype}, compute "
        f"{cfg.compute_dtype}, {nparams * 4 / 1e9:.2f} GB) initialised on "
        f"the card in {time.perf_counter() - t0:.2f} s")
    pre, dec = step.make_prefill_step(model), step.make_decode_step(model)
    prompt = torch.randint(0, cfg.vocab_size, (DECODE_B, PROMPT),
                           device="cuda", generator=gen)
    recurrent_run(pre, dec, params, prompt[:, :128], 2)            # warm-up
    KB.reset_launches()
    logits, fed, t_pre, t_dec, nbytes = recurrent_run(pre, dec, params,
                                                      prompt, STEPS)
    launches = dict(KB.LAUNCHES)
    off = lever_off(model, params, prompt, logits, t_dec, launches)
    peak = off["peak"]
    log(f"[{arch}] full width: prefill {DECODE_B} x {PROMPT} in "
        f"{t_pre:.4f} s ({DECODE_B * PROMPT / t_pre:.1f} tokens/s), {STEPS} "
        f"greedy steps in {t_dec:.4f} s ({DECODE_B * STEPS / t_dec:.1f} "
        f"tokens/s), decode state {nbytes / 1e6:.1f} MB, peak memory "
        f"{peak:.2f} GiB; kernel launches {launches}")
    want = expect(cfg)
    want["rmsnorm"] *= 1 + STEPS
    for name in ("rmsnorm", "rglru_scan", "mamba_scan", "flash_attention",
                 "decode_attention"):
        check(launches[name] == want.get(name, 0),
              f"{arch}: {name} launched {launches[name]} times, expected "
              f"{want.get(name, 0)}")
    check(bool(torch.isfinite(logits).all()), f"{arch}: logits not finite")
    check(logits.shape == (DECODE_B, STEPS + 1, cfg.vocab_size),
          f"{arch}: logits {tuple(logits.shape)}")

    with torch.inference_mode():
        h = params.embed[prompt].to(torch.bfloat16)
        positions = torch.arange(PROMPT, dtype=torch.int32,
                                 device=prompt.device)[None].expand(
                                     DECODE_B, PROMPT)
        local = layer_by_layer(
            lambda i, x: layer(cfg, params, i, x, positions),
            cfg.num_layers, h, ops, f"{arch} bf16")
    log(f"[{arch}] bf16 prefill, each of the {cfg.num_layers} layers on the "
        f"plain path's input: within 2e-2 x max(1, max |h|) of the plain "
        f"layer; largest error {local:.4g} of max(1, max |h|)")

    cfg32 = dataclasses.replace(cfg, compute_dtype="float32")
    m32 = build_model(cfg32)
    pre32, dec32 = step.make_prefill_step(m32), step.make_decode_step(m32)
    k32 = recurrent_run(pre32, dec32, params, prompt, REF_STEPS,
                        forced=fed)[0]
    with ops.reference():
        p32 = recurrent_run(pre32, dec32, params, prompt, REF_STEPS,
                            forced=fed)[0]
    errs = [logits_close(k32[:, t], p32[:, t],
                         f"{arch} float32 step {t} vs the plain path")
            for t in range(REF_STEPS + 1)]
    log(f"[{arch}] float32 compute under ops.reference(): prefill's last "
        f"logits differ by {errs[0]:.4g}, teacher-forced decode steps "
        f"1..{REF_STEPS} by {[float(f'{e:.4g}') for e in errs[1:]]} (max "
        f"|logit| {float(p32.abs().max()):.4g}; limit 2e-2 x max(1, max "
        f"|logit|), rtol 2e-2)")
    del k32, p32

    with ops.reference():
        plain = recurrent_run(pre, dec, params, prompt, REF_STEPS,
                              forced=fed)[0]
    diff = (logits[:, :REF_STEPS + 1].float() - plain.float()).abs()
    per_step = diff.amax(dim=(0, 2))
    log(f"[{arch}] record, not a check: the bf16 path against its plain "
        f"rerun, per step (prefill, then teacher-forced decode) max abs "
        f"{[float(f'{float(d):.4g}') for d in per_step]}, max "
        f"|logit| {float(plain.float().abs().max()):.4g}")

    def plain_prefill_last(h):
        for i in range(cfg.num_layers):
            h = layer(cfg, params, i, h, positions)
        return head_out(params, cfg, h)[:, -1].float()

    with torch.inference_mode(), ops.reference():
        h0 = params.embed[prompt].to(torch.bfloat16)
        base = plain_prefill_last(h0)
        moved = plain_prefill_last(ulp_nudge(
            h0, torch.Generator(device="cuda").manual_seed(1)))
    move = float((moved - base).abs().max())
    log(f"[{arch}] record, not a check: the plain bf16 prefill with every "
        f"element of its embedded input moved one bf16 ulp (direction at "
        f"random, seed 1): its last logits move by max abs {move:.4g} (max "
        f"|logit| {float(base.abs().max()):.4g}); the kernel path differs "
        f"from the plain path there by {float(per_step[0]):.4g}")
    del plain, base, moved

    model_on = build_model(dataclasses.replace(cfg, cast_weights_bf16=True))
    params = model_on.cast_weights(params)     # replaces the f32 tree
    torch.cuda.empty_cache()
    pre_on = step.make_prefill_step(model_on)
    dec_on = step.make_decode_step(model_on)
    # falcon-mamba reads x_proj, dt_proj and A_log in float32, so the cast
    # moves its numbers (in the reference too); the others read every cast
    # leaf through .to(bf16) and give the same bits
    equal = cfg.family != "ssm"
    launches_on = lever_on(
        arch, model_on,
        lambda p, prompt, n: recurrent_run(pre_on, dec_on, p, prompt, n),
        params, KB, off, equal)
    if not equal:
        # the lever-on path held against its own plain path, by the same
        # per-layer and float32 checks at the same limits
        with torch.inference_mode():
            h = params.embed[prompt].to(torch.bfloat16)
            local = layer_by_layer(
                lambda i, x: layer(cfg, params, i, x, positions),
                cfg.num_layers, h, ops, f"{arch} lever-on bf16")
        k32 = recurrent_run(pre32, dec32, params, prompt, REF_STEPS,
                            forced=fed)[0]
        with ops.reference():
            p32 = recurrent_run(pre32, dec32, params, prompt, REF_STEPS,
                                forced=fed)[0]
        errs = [logits_close(k32[:, t], p32[:, t],
                             f"{arch} lever-on float32 step {t}")
                for t in range(REF_STEPS + 1)]
        log(f"[{arch}] lever on, against its plain path: each bf16 layer "
            f"within 2e-2 x max(1, max |h|) (largest {local:.4g}); float32 "
            f"compute on the cast weights, prefill's last logits "
            f"{errs[0]:.4g} and teacher-forced steps 1..{REF_STEPS} "
            f"{[float(f'{e:.4g}') for e in errs[1:]]} (limit 2e-2 x max(1, "
            f"max |logit|))")
        del k32, p32
    del params, logits, off
    torch.cuda.empty_cache()
    return launches, launches_on


def mamba_expect(cfg) -> dict:
    return {"mamba_scan": cfg.num_layers, "rmsnorm": cfg.num_layers + 1}


def hybrid_expect(cfg) -> dict:
    kinds = [cfg.hybrid.pattern[i % len(cfg.hybrid.pattern)]
             for i in range(cfg.num_layers)]
    return {"rglru_scan": kinds.count("rec"),
            "flash_attention": kinds.count("attn"),
            "rmsnorm": 2 * cfg.num_layers + 1}


# ---------------------------------------------------------------------------
# phases 11 and 12: the moe and vlm families at full width
# ---------------------------------------------------------------------------

# a routing flip between the kernel and plain paths is held to lie at a near
# tie of the plain path's router logits: its top k + 1 within 4 bf16 ulps of
# the row's largest |logit| (tests/test_torch_moe.py's rule)
FLIP_MARGIN = 4 * 2.0 ** -7


class RouteLog:
    """Records every MoE routing decision made inside the block: for each
    call, the selected experts and the f32 router logits (``moe.route``;
    the logits recomputed by one more matmul, which launches no
    hand-written kernel) and which assignments kept a slot
    (``moe.slots``)."""

    def __init__(self, moe):
        self.moe, self.calls = moe, []

    def __enter__(self):
        self.route, self.slots = route, slots = self.moe.route, self.moe.slots

        def routed(x2d, router_w, cfg):
            out = route(x2d, router_w, cfg)
            self.calls.append([out[2], (x2d @ router_w.to(x2d.dtype))
                               .float()])
            return out

        def slotted(gate_idx, cfg, C):
            keep, slot = slots(gate_idx, cfg, C)
            self.calls[-1].append(keep.reshape(gate_idx.shape))
            return keep, slot

        self.moe.route, self.moe.slots = routed, slotted
        return self

    def __exit__(self, *exc):
        self.moe.route, self.moe.slots = self.route, self.slots


def route_flips(got: RouteLog, want: RouteLog, k: int, what: str) -> list:
    """Call by call (both paths make the same calls in the same order), the
    rows whose kernel-path experts differ from the plain path's, each of
    which must lie at a near tie of the plain path's logits, and the rows
    that kept other slots (a flip moves the capacity positions of later
    assignments to the experts it leaves and joins).  Returns the masks of
    both."""
    check(len(got.calls) == len(want.calls) > 0,
          f"{what}: {len(got.calls)} routing calls against "
          f"{len(want.calls)}")
    masks = []
    for (gi, _, gk), (wi, wl, wk) in zip(got.calls, want.calls, strict=True):
        f = (gi != wi).any(-1)
        if f.any():
            top = wl[f].sort(-1, descending=True).values[:, :k + 1]
            gap = (top[:, :-1] - top[:, 1:]).min(-1).values
            margin = float((gap / wl[f].abs().amax(-1)).max())
            check(margin <= FLIP_MARGIN,
                  f"{what}: a route differs at a margin of {margin:.4g} of "
                  f"the largest logit (> {FLIP_MARGIN:.4g}, not a near tie)")
        masks.append(f | (gk != wk).any(-1))
    return masks


def moe_layer_by_layer(tf, moe, ops, cfg, params, h, positions, what):
    """Each layer with the kernels and under ``ops.reference()`` on the
    plain path's input.  Rows whose experts and slots agree at the logits'
    tolerance (2e-2 x max(1, max |h|)); rows whose experts differ only at
    near ties; the dropped assignments' counts apart by no more than the
    k assignments of each row whose experts or slots differ (equal where
    none does), the aux loss within rtol 1e-2.  Returns (largest error
    over max(1, max |h|), rows whose experts or slots differ, rows, the
    largest difference of ``moe_dropped``, of ``moe_aux`` relative)."""
    worst, flipped, d_drop, d_aux = 0.0, 0, 0.0, 0.0
    k = cfg.moe.experts_per_token
    A = h.shape[0] * h.shape[1] * k
    for i, lp in enumerate(params.layers):
        with RouteLog(moe) as wl, ops.reference():
            want, _, waux = tf._layer_apply(lp, cfg, h, positions,
                                            mode="train")
        with RouteLog(moe) as gl:
            got, _, gaux = tf._layer_apply(lp, cfg, h, positions,
                                           mode="train")
        (f,) = route_flips(gl, wl, k, f"{what} layer {i}")
        keep = ~f.reshape(h.shape[:2])
        scale = max(1.0, float(want.float().abs().max()))
        worst = max(worst, logits_close(got[keep], want[keep],
                                        f"{what} layer {i}") / scale)
        flipped += int(f.sum())
        drop = abs(float(gaux["moe_dropped"]) - float(waux["moe_dropped"]))
        check(round(drop * A) <= k * int(f.sum()),
              f"{what} layer {i}: moe_dropped differs by {drop} with "
              f"{int(f.sum())} rows' experts or slots differing")
        a, b = float(gaux["moe_aux"]), float(waux["moe_aux"])
        check(abs(a - b) <= 1e-2 * abs(b),
              f"{what} layer {i}: moe_aux {a} against {b}")
        d_drop, d_aux = max(d_drop, drop), max(d_aux, abs(a - b) / abs(b))
        h = want
    return (worst, flipped, h.shape[0] * h.shape[1] * len(params.layers),
            d_drop, d_aux)


def step_rows(masks, L, B, P) -> torch.Tensor:
    """[B, 1 + steps] flags of a prefill + decode run's logits rows whose
    own token took other experts in some layer: the prefill's L calls of
    B·P rows (its last token's row), then L calls of B rows a step."""
    pre = torch.stack(masks[:L]).any(0).reshape(B, P)[:, -1]
    steps = [torch.stack(masks[L * (1 + t):L * (2 + t)]).any(0)
             for t in range(len(masks) // L - 1)]
    return torch.stack([pre] + steps, 1)


def zoo_expect(cfg) -> dict:
    """Launches of one prefill and STEPS decode steps."""
    L = cfg.num_layers
    norms = (4 if cfg.qk_norm else 2) * L + 1
    return {"flash_attention": L, "decode_attention": L * STEPS,
            "rmsnorm": norms * (1 + STEPS)}


def phase_zoo(arch, get_config, build_model, serve, schema, tf, moe, ops, KB,
              gen) -> tuple:
    """granite-moe-1b-a400m (split-serve, then prefill + decode from tokens)
    or qwen2-vl-2b (prefill from random embeds at the default M-RoPE
    positions, decode from tokens) at full width, random weights from seed
    0: launches, two runs ``torch.equal``, each bf16 layer and the float32
    path against ``ops.reference()``, then the cast_weights_bf16 lever.
    Returns (launches of serve or None, decode, lever on)."""
    cfg = get_config(arch)
    model = build_model(cfg)
    is_moe = cfg.family == "moe"
    t0 = time.perf_counter()
    params = model.init(torch.Generator(device="cuda").manual_seed(0))
    torch.cuda.synchronize()
    nparams = sum(p.numel() for p in params.parameters())
    log(f"[{arch}] {nparams} parameters ({cfg.param_dtype}, compute "
        f"{cfg.compute_dtype}, {nparams * 4 / 1e9:.2f} GB; active a token "
        f"{cfg.active_param_count()}) initialised on the card in "
        f"{time.perf_counter() - t0:.2f} s")
    served = phase_serve(cfg, params, serve, schema, ops, KB,
                         hold_logits=False) if is_moe else None
    if is_moe:
        prompt = torch.randint(0, cfg.vocab_size, (DECODE_B, PROMPT),
                               device="cuda", generator=gen)
    else:
        prompt = torch.randn((DECODE_B, PROMPT, cfg.d_model), device="cuda",
                             generator=torch.Generator(device="cuda")
                             .manual_seed(0)) * 0.02
    L = cfg.num_layers
    with torch.inference_mode():
        decode_run(model, params, prompt[:, :128], 2)            # warm-up
        torch.cuda.reset_peak_memory_stats()
        KB.reset_launches()
        logits, fed, t_pre, t_dec, kv_bytes = decode_run(model, params,
                                                         prompt, STEPS)
        launches = dict(KB.LAUNCHES)
        off = lever_off(model, params, prompt, logits, t_dec, launches)
        log(f"[{arch}] full width: prefill {DECODE_B} x {PROMPT} "
            f"{'tokens' if is_moe else 'embeds'} in {t_pre:.4f} s "
            f"({DECODE_B * PROMPT / t_pre:.1f} tokens/s), {STEPS} greedy "
            f"steps from tokens in {t_dec:.4f} s "
            f"({DECODE_B * STEPS / t_dec:.1f} tokens/s), KV cache {kv_bytes / 1e6:.1f} MB, peak memory "
            f"{off['peak']:.2f} GiB; kernel launches {launches}")
        for name, n in zoo_expect(cfg).items():
            check(launches[name] == n, f"{arch}: {name} launched "
                  f"{launches[name]} times, expected {n}")
        check(bool(torch.isfinite(logits).all()) and logits.shape == (
            DECODE_B, STEPS + 1, cfg.vocab_size), f"{arch}: logits")
        again = decode_run(model, params, prompt, STEPS)[0]
        check(torch.equal(again, logits), f"{arch}: two runs differ")
        log(f"[{arch}] a second prefill + {STEPS} greedy steps: logits "
            f"torch.equal to the first")
        del again

        h, positions = tf.embed_in(
            params, cfg, {"embeds": prompt} if not is_moe
            else {"tokens": prompt})
        if is_moe:
            local, flipped, rows, d_drop, d_aux = moe_layer_by_layer(
                tf, moe, ops, cfg, params, h, positions, f"{arch} bf16")
            log(f"[{arch}] bf16 prefill, each of the {L} layers on the plain "
                f"path's input: rows whose experts and slots agree within "
                f"2e-2 x max(1, max |h|) of the plain layer (largest error "
                f"{local:.4g}); "
                f"{flipped} of {rows} token-layers took other experts (each "
                f"at a near tie, <= {FLIP_MARGIN:.4g} of the largest router "
                f"logit) or, behind such a flip, other slots; moe_dropped "
                f"apart by at most {d_drop:.4g} (within k assignments a "
                f"differing row), moe_aux by at most {d_aux:.3g} relative "
                f"(limit 1e-2)")
        else:
            local = layer_by_layer(
                lambda i, x: tf._layer_apply(params.layers[i], cfg, x,
                                             positions, mode="train")[0],
                L, h, ops, f"{arch} bf16")
            log(f"[{arch}] bf16 prefill, each of the {L} layers on the plain "
                f"path's input (M-RoPE positions {tuple(positions.shape)}): "
                f"within 2e-2 x max(1, max |h|) of the plain layer; largest "
                f"error {local:.4g} of max(1, max |h|)")
        del h

        m32 = build_model(dataclasses.replace(cfg, compute_dtype="float32"))
        with RouteLog(moe) as gl:
            k32 = decode_run(m32, params, prompt, REF_STEPS, forced=fed)[0]
        with RouteLog(moe) as wl, ops.reference():
            p32 = decode_run(m32, params, prompt, REF_STEPS, forced=fed)[0]
        rows = torch.zeros((DECODE_B, REF_STEPS + 1), dtype=torch.bool,
                           device="cuda")
        if is_moe:
            rows = step_rows(route_flips(gl, wl, cfg.moe.experts_per_token,
                                         f"{arch} float32"),
                             L, DECODE_B, PROMPT)
        errs = [logits_close(k32[:, t][~rows[:, t]], p32[:, t][~rows[:, t]],
                             f"{arch} float32 step {t} vs the plain path")
                for t in range(REF_STEPS + 1)]
        log(f"[{arch}] float32 compute under ops.reference(): prefill's last "
            f"logits differ by {errs[0]:.4g}, teacher-forced decode steps "
            f"1..{REF_STEPS} by {[float(f'{e:.4g}') for e in errs[1:]]} (max "
            f"|logit| {float(p32.abs().max()):.4g}; limit 2e-2 x max(1, max "
            f"|logit|)); rows whose token took other experts or slots (left "
            f"out): {int(rows.sum())}")
        del k32, p32, m32

    model_on = build_model(dataclasses.replace(cfg, cast_weights_bf16=True))
    params = model_on.cast_weights(params)     # replaces the f32 tree
    torch.cuda.empty_cache()
    with torch.inference_mode():
        lever = lever_on(
            arch, model_on,
            lambda p, prompt, n: decode_run(model_on, p, prompt, n),
            params, KB, off, equal=True)
    del params, off, logits
    torch.cuda.empty_cache()
    return served, launches, lever


# ---------------------------------------------------------------------------
# phase 14: training (the backward kernels, then launch.train's path)
# ---------------------------------------------------------------------------

F32, BF16 = torch.float32, torch.bfloat16
BWD_FLASH_SHAPES = [  # B, Sq, Sk, Hq, Hkv, hd, causal, window, dtype
    (2, 128, 128, 4, 2, 64, True, 0, F32),        # tests/test_kernels.py
    (2, 128, 128, 4, 4, 64, False, 0, F32),
    (1, 256, 256, 4, 2, 64, True, 64, F32),
    (1, 256, 256, 8, 1, 128, True, 0, BF16),
    (4, 512, 512, 16, 8, 128, True, 0, BF16),     # rows 3, 3b, 3c, 3d
    (4, 512, 512, 16, 1, 256, True, 0, BF16),
    (4, 512, 512, 16, 8, 64, True, 0, BF16),
    (4, 512, 512, 12, 2, 128, True, 0, BF16),
    (4, 512, 512, 16, 8, 128, True, 0, F32),      # the float32 train step
    (1, 1000, 1000, 4, 1, 256, True, 256, BF16),  # a window that bites
    (1, 300, 300, 4, 2, 64, True, 37, F32),
    (2, 200, 328, 4, 2, 128, True, 0, BF16),      # Sq != Sk
    (2, 328, 200, 4, 2, 64, True, 0, F32),
    (2, 150, 90, 4, 4, 32, False, 0, BF16),
    (2, 77, 77, 4, 2, 16, True, 0, BF16),         # every head_dim, ragged
    (2, 100, 100, 4, 2, 32, True, 0, F32),
    (2, 130, 130, 4, 2, 64, True, 0, BF16),
    (*WHISPER_ENC, False, 0, BF16),               # whisper: rows 3e, 3f
    (*WHISPER_CROSS, False, 0, BF16),
    (4, 448, 448, 16, 16, 64, True, 0, BF16),     # its decoder's self
    (2, 200, 1500, 16, 16, 64, False, 0, F32),    # its float32 train step
    (2, 100, 100, 4, 1, 256, True, 0, F32),       # recurrentgemma's, f32
]
BWD_NORM_SHAPES = [  # shape, dtype
    ((2048, 4096), BF16),                         # the JSON row
    ((4, 512, 16, 128), BF16),                    # qwen3's qk-norm
    ((4, 512, 2048), BF16),                       # qwen3's layer norms
    ((4, 512, 1024), BF16),                       # granite-moe's
    ((4, 512, 1536), BF16),                       # qwen2-vl's
    ((4, 512, 2048), F32),
    ((4, 64, 256), F32),                          # tests/test_kernels.py
    ((8, 128), BF16),
    ((3, 7, 512), F32),
    ((5, 100), F32),                              # ragged
    ((3, 1000), BF16),
    ((1, 8192), F32),
]
# the timed rows: qwen3's prefill shapes (the JSON rows) and recurrentgemma's
BWD_FLASH_TIMED = [SERVE_FLASH, HYBRID_FLASH, MOE_FLASH, VLM_FLASH]
BWD_NORM_TIMED = [(2048, 4096), (4, 512, 16, 128), (4, 512, 2048)]


def flash_bwd_bound_ms(B, S, Hq, Hkv, hd, elt=2, rate=BF16_OPS_PER_S
                       ) -> tuple:
    """q, k, v, o and dO read once, dQ, dK and dV written once; five
    products of 2·hd flops for each (query, key) pair the causal mask
    keeps (the scores, dP, dV, dQ, dK)."""
    nbytes = elt * (4 * B * S * Hq * hd + 4 * B * S * Hkv * hd)
    pairs = B * Hq * S * (S + 1) // 2
    return roofline_ms(nbytes, 10 * hd * pairs, rate)


def norm_bwd_bound_ms(rows, d, elt=2) -> tuple:
    """x and dy read, dx written once, scale read and dscale written once;
    about ten f32 operations an element."""
    return roofline_ms(3 * elt * rows * d + 8 * d, 10 * rows * d,
                       FP32_OPS_PER_S)


def bwd_flash_inputs(B, Sq, Sk, Hq, Hkv, hd, causal, win, dt, gen, ref):
    q, k, v = attn_inputs((B, Sq, Hq, hd), (B, Sk, Hkv, hd), dt, gen)
    o = ref.flash_attention(q, k, v, causal=causal, window=win).contiguous()
    do = torch.randn(o.shape, device="cuda", generator=gen).to(dt)
    return q, k, v, o, do


TRAIN_ARCHS = ("qwen3-1.7b", "granite-moe-1b-a400m", "qwen2-vl-2b")


def bwd_instantiations(NB, get_config) -> dict:
    """The bf16 instantiations of the two backward kernels on the training
    path: the flash kernels at head_dim 64, 128 and 256 and the rmsnorm
    plans of the trained models' norms at 4 x 512 tokens (the layer norms
    and, where the model has one, the qk-norm) -> a fragment of the
    kernel's mangled name."""
    want = {}
    for hd in (64, 128, 256):
        for kern in ("dq", "dkdv"):
            want[f"flash {kern} hd {hd}"] = f"flash_bwd_{kern}_wgmmaILi{hd}E"
    for arch in TRAIN_ARCHS:
        cfg = get_config(arch)
        tokens = TRAIN_B * TRAIN_S
        norms = [(tokens, cfg.d_model)]
        if cfg.qk_norm:
            norms += [(tokens * cfg.num_heads, cfg.head_dim_),
                      (tokens * cfg.num_kv_heads, cfg.head_dim_)]
        for rows, d in norms:
            tpr, nv = NB.bwd_plan(rows, d, BF16)[:2]
            want[f"rmsnorm {arch} ({rows}, {d})"] = (
                f"rmsnorm_bwd_kernelI13__nv_bfloat16Li{tpr}ELi{nv}ELb1E")
    return want


def check_bwd_spills(FB, NB, get_config) -> dict:
    """No bf16 instantiation of the backward kernels on the training path
    spills (the libraries' ptxas reports); returns label -> registers."""
    table = {**ptxas_table(FB.LIB.report()), **ptxas_table(NB.LIB.report())}
    regs = {}
    for label, frag in bwd_instantiations(NB, get_config).items():
        hits = [v for name, v in table.items() if frag in name]
        check(len(hits) == 1, f"ptxas report: {label} ({frag}) found "
              f"{len(hits)} times")
        r, st, ld = hits[0]
        check(st == 0 and ld == 0, f"{label} spills: {st} bytes of stores, "
              f"{ld} bytes of loads")
        regs[label] = r
    log(f"[train] no spills in the training path's bf16 backward kernels; "
        f"registers a thread {regs}")
    return regs


def phase_backward_kernels(FB, NB, ref, gen) -> dict:
    """Both backward kernels against their plain twins at 3e-5 (f32) and
    2e-2 (bf16), as phase 5 holds the forwards; two launches equal."""
    err = {"flash_attention_bwd": 0.0, "rmsnorm_bwd": 0.0}
    for shape in BWD_FLASH_SHAPES:
        B, Sq, Sk, Hq, Hkv, hd, causal, win, dt = shape
        args = bwd_flash_inputs(*shape, gen, ref)
        got = FB.flash_attention_bwd(*args, causal=causal, window=win)
        want = ref.flash_attention_bwd(*args, causal=causal, window=win)
        torch.cuda.synchronize()
        for name, g, w in zip(("dq", "dk", "dv"), got, want):
            err["flash_attention_bwd"] = max(
                err["flash_attention_bwd"],
                assert_close(g, w, attn_tol(dt), f"flash bwd {name} at "
                             f"{shape}"))
        again = FB.flash_attention_bwd(*args, causal=causal, window=win)
        check(all(torch.equal(a, b) for a, b in zip(got, again)),
              f"flash bwd at {shape}: two launches differ")
        del args, got, want, again
    for shape, dt in BWD_NORM_SHAPES:
        x, s = norm_inputs(shape, dt, gen)
        dy = torch.randn(shape, device="cuda", generator=gen).to(dt)
        got = NB.rmsnorm_bwd(x, s, dy)
        want = ref.rmsnorm_bwd(x, s, dy)
        torch.cuda.synchronize()
        for name, g, w in zip(("dx", "dscale"), got, want):
            err["rmsnorm_bwd"] = max(err["rmsnorm_bwd"], assert_close(
                g, w, attn_tol(dt), f"rmsnorm bwd {name} at {shape} {dt}"))
        again = NB.rmsnorm_bwd(x, s, dy)
        check(all(torch.equal(a, b) for a, b in zip(got, again)),
              f"rmsnorm bwd at {shape} {dt}: two launches differ")
    log(f"[train] backward kernels match their plain twins (rtol=atol 3e-5 "
        f"f32, 2e-2 bf16) at flash {[x[:8] for x in BWD_FLASH_SHAPES]} and "
        f"rmsnorm {[x[0] for x in BWD_NORM_SHAPES]}; two launches give "
        f"equal bits; max_abs_err {err}")
    return err


def phase_backward_timing(FB, NB, ref, gen) -> dict:
    """Each backward kernel, its plain twin and the library's backward
    (autograd of SDPA, of ``F.rms_norm``: yardsticks the port never calls),
    warm and cold, at the training shapes; the JSON rows are qwen3's
    (4, 512, 16, 8, 128) bf16 and (2048, 4096) bf16."""
    sdpa = torch.nn.functional.scaled_dot_product_attention
    out = {}
    for shape in BWD_FLASH_TIMED:
        B, S, Hq, Hkv, hd = shape
        q, k, v, o, do = bwd_flash_inputs(B, S, S, Hq, Hkv, hd, True, 0,
                                          BF16, gen, ref)
        qt, kt, vt = (x.transpose(1, 2).contiguous().requires_grad_()
                      for x in (q, k, v))
        ot = sdpa(qt, kt, vt, is_causal=True, enable_gqa=True)
        dot = do.transpose(1, 2).contiguous()
        lib_g = torch.autograd.grad(ot, (qt, kt, vt), dot, retain_graph=True)
        # a yardstick computed another way (bf16 P in its products): held
        # to 2e-2 of each gradient's largest entry
        for name, a, b in zip(("dq", "dk", "dv"), lib_g,
                              FB.flash_attention_bwd(q, k, v, o, do)):
            e = rel_err(a.transpose(1, 2), b)
            check(e <= 2e-2, f"SDPA's backward {name} against the kernel at "
                  f"{shape}: {e:.3g} of its largest entry")
        t = timed(lambda: FB.flash_attention_bwd(q, k, v, o, do),
                  lambda: ref.flash_attention_bwd(q, k, v, o, do),
                  lambda: torch.autograd.grad(ot, (qt, kt, vt), dot,
                                              retain_graph=True),
                  flash_bwd_bound_ms(B, S, Hq, Hkv, hd))
        log(timing_line("flash_attention_bwd", f"{shape} causal bf16", t))
        out.setdefault("flash_attention_bwd", t)
        del q, k, v, o, do, qt, kt, vt, ot, dot, lib_g
    lib = torch.nn.functional.rms_norm
    for shape in BWD_NORM_TIMED:
        x, s = norm_inputs(shape, BF16, gen)
        dy = torch.randn(shape, device="cuda", generator=gen).to(BF16)
        d = shape[-1]
        xl = x.clone().requires_grad_()
        sl = s.to(BF16).requires_grad_()
        yl = lib(xl, (d,), sl, 1e-6)
        e = rel_err(torch.autograd.grad(yl, xl, dy, retain_graph=True)[0],
                    NB.rmsnorm_bwd(x, s, dy)[0])
        check(e <= 2e-2, f"F.rms_norm's backward dx against the kernel at "
              f"{shape}: {e:.3g} of its largest entry")
        t = timed(lambda: NB.rmsnorm_bwd(x, s, dy),
                  lambda: ref.rmsnorm_bwd(x, s, dy),
                  lambda: torch.autograd.grad(yl, (xl, sl), dy,
                                              retain_graph=True),
                  norm_bwd_bound_ms(x.numel() // d, d))
        log(timing_line("rmsnorm_bwd", f"{shape} bf16", t))
        out.setdefault("rmsnorm_bwd", t)
    torch.cuda.empty_cache()
    return out


def phase_whisper_bwd_timing(FB, ref, gen) -> None:
    """The flash backward at whisper's encoder and cross attention (bf16,
    non-causal), timed as ``phase_backward_timing`` times its rows, beside
    autograd of the non-causal SDPA."""
    sdpa = torch.nn.functional.scaled_dot_product_attention
    for shape in (WHISPER_ENC, WHISPER_CROSS):
        B, Sq, Sk, Hq, Hkv, hd = shape
        q, k, v, o, do = bwd_flash_inputs(B, Sq, Sk, Hq, Hkv, hd, False, 0,
                                          BF16, gen, ref)
        qt, kt, vt = (x.transpose(1, 2).contiguous().requires_grad_()
                      for x in (q, k, v))
        ot = sdpa(qt, kt, vt)
        dot = do.transpose(1, 2).contiguous()
        lib_g = torch.autograd.grad(ot, (qt, kt, vt), dot, retain_graph=True)
        for name, a, b in zip(("dq", "dk", "dv"), lib_g,
                              FB.flash_attention_bwd(q, k, v, o, do,
                                                     causal=False)):
            e = rel_err(a.transpose(1, 2), b)
            check(e <= 2e-2, f"SDPA's backward {name} against the kernel at "
                  f"{shape}: {e:.3g} of its largest entry")
        t = timed(lambda: FB.flash_attention_bwd(q, k, v, o, do,
                                                 causal=False),
                  lambda: ref.flash_attention_bwd(q, k, v, o, do,
                                                  causal=False),
                  lambda: torch.autograd.grad(ot, (qt, kt, vt), dot,
                                              retain_graph=True),
                  attn_bound_ms(B, Sq, Sk, Hq, Hkv, hd, False, bwd=True))
        log(timing_line("flash_attention_bwd", f"{shape} non-causal bf16",
                        t))
        del q, k, v, o, do, qt, kt, vt, ot, dot, lib_g
    torch.cuda.empty_cache()


# ---------------------------------------------------------------------------
# phase 14b, continued: the kernels at the mesh path's tensor-parallel shapes
# ---------------------------------------------------------------------------

# (B, S, Hq, Hkv, hd) of one "model" rank's attention at 4 x 512 tokens:
# qwen3-1.7b's 16 q / 8 kv heads over "model" = 2 and 4, qwen3-moe-30b-a3b's
# 32 / 4 over 4; these run only where "model" > 1, which a card's world of
# one never is, so they are held here directly
TP_LOCAL = [(4, 512, 8, 4, 128), (4, 512, 4, 2, 128), (4, 512, 8, 1, 128)]


def phase_tp_local(FA, FB, RN, NB, ref, gen) -> dict:
    """Flash attention forward and backward and the qk-norm's rmsnorm
    forward and backward at TP_LOCAL in bf16, against their plain versions
    (2e-2), two launches equal, then each timed warm and cold beside its
    plain version, its bound and the library call (SDPA, its autograd,
    ``F.rms_norm``); returns the largest errors by kernel."""
    sdpa = torch.nn.functional.scaled_dot_product_attention
    lib = torch.nn.functional.rms_norm
    err = {"flash_attention": 0.0, "flash_attention_bwd": 0.0,
           "rmsnorm": 0.0, "rmsnorm_bwd": 0.0}
    for B, S, Hq, Hkv, hd in TP_LOCAL:
        shape = (B, S, Hq, Hkv, hd)
        q, k, v, o, do = bwd_flash_inputs(B, S, S, Hq, Hkv, hd, True, 0,
                                          BF16, gen, ref)
        got = FA.flash_attention(q, k, v)
        err["flash_attention"] = max(err["flash_attention"], assert_close(
            got, o, 2e-2, f"TP-local flash at {shape}"))
        check(torch.equal(got, FA.flash_attention(q, k, v)),
              f"TP-local flash at {shape}: two launches differ")
        gb = FB.flash_attention_bwd(q, k, v, o, do)
        for name, g, w in zip(("dq", "dk", "dv"), gb,
                              ref.flash_attention_bwd(q, k, v, o, do)):
            err["flash_attention_bwd"] = max(
                err["flash_attention_bwd"], assert_close(
                    g, w, 2e-2, f"TP-local flash bwd {name} at {shape}"))
        check(all(torch.equal(a, b) for a, b in zip(
            gb, FB.flash_attention_bwd(q, k, v, o, do))),
            f"TP-local flash bwd at {shape}: two launches differ")
        qt, kt, vt = (x.transpose(1, 2).contiguous().requires_grad_()
                      for x in (q, k, v))
        ot = sdpa(qt, kt, vt, is_causal=True, enable_gqa=True)
        dot = do.transpose(1, 2).contiguous()
        t = timed(lambda: FA.flash_attention(q, k, v),
                  lambda: ref.flash_attention(q, k, v),
                  lambda: sdpa(qt, kt, vt, is_causal=True, enable_gqa=True),
                  flash_bound_ms(B, S, Hq, Hkv, hd))
        log(timing_line("flash_attention", f"{shape} TP-local causal bf16",
                        t))
        t = timed(lambda: FB.flash_attention_bwd(q, k, v, o, do),
                  lambda: ref.flash_attention_bwd(q, k, v, o, do),
                  lambda: torch.autograd.grad(ot, (qt, kt, vt), dot,
                                              retain_graph=True),
                  flash_bwd_bound_ms(B, S, Hq, Hkv, hd))
        log(timing_line("flash_attention_bwd",
                        f"{shape} TP-local causal bf16", t))
        del q, k, v, o, do, got, gb, qt, kt, vt, ot, dot
        for H in sorted({Hq, Hkv}, reverse=True):
            nshape = (B, S, H, hd)
            x, s = norm_inputs(nshape, BF16, gen)
            dy = torch.randn(nshape, device="cuda", generator=gen).to(BF16)
            y = RN.rmsnorm(x, s)
            err["rmsnorm"] = max(err["rmsnorm"], assert_close(
                y, ref.rmsnorm(x, s), 2e-2, f"TP-local rmsnorm at {nshape}"))
            check(torch.equal(y, RN.rmsnorm(x, s)),
                  f"TP-local rmsnorm at {nshape}: two launches differ")
            for name, g, w in zip(("dx", "dscale"), NB.rmsnorm_bwd(x, s, dy),
                                  ref.rmsnorm_bwd(x, s, dy)):
                err["rmsnorm_bwd"] = max(err["rmsnorm_bwd"], assert_close(
                    g, w, 2e-2, f"TP-local rmsnorm bwd {name} at {nshape}"))
            rows = x.numel() // hd
            s16 = s.to(BF16)
            t = timed(lambda: RN.rmsnorm(x, s), lambda: ref.rmsnorm(x, s),
                      lambda: lib(x, (hd,), s16, 1e-6),
                      roofline_ms(2 * rows * hd * 2 + 4 * hd, 4 * rows * hd,
                                  FP32_OPS_PER_S))
            log(timing_line("rmsnorm", f"{nshape} TP-local qk-norm bf16", t))
            xl, sl = x.clone().requires_grad_(), s16.clone().requires_grad_()
            yl = lib(xl, (hd,), sl, 1e-6)
            t = timed(lambda: NB.rmsnorm_bwd(x, s, dy),
                      lambda: ref.rmsnorm_bwd(x, s, dy),
                      lambda: torch.autograd.grad(yl, (xl, sl), dy,
                                                  retain_graph=True),
                      norm_bwd_bound_ms(rows, hd))
            log(timing_line("rmsnorm_bwd", f"{nshape} TP-local qk-norm "
                            f"bf16", t))
    torch.cuda.empty_cache()
    log(f"[tp-local] flash forward and backward at (B, S, Hq, Hkv, hd) "
        f"{TP_LOCAL} and the qk-norm's rmsnorm forward and backward at "
        f"their heads match their plain versions (2e-2 bf16), two launches "
        f"equal; max_abs_err {err}")
    return err


# ---------------------------------------------------------------------------
# phase 14b: the scans' backward kernels against their plain twins
# ---------------------------------------------------------------------------

SCAN_BWD_RGLRU = [(2, 37, 24), (1, 64, 130), (3, 5, 7), (2, 100, 4099),
                  (1, 1, 64), SERVE_RGLRU]        # B, S, W; the training row
SCAN_BWD_MAMBA = [  # B, S, D, N, with a cotangent of the last state
    (2, 37, 40, 4, False), (1, 29, 64, 16, True), (2, 9, 33, 8, False),
    (1, 77, 100, 12, True), (3, 1, 32, 4, True), (2, 64, 8192, 16, True),
    # S below, at, one past and not a multiple of the checkpoint interval
    # (32), at N = 4 and 16
    (2, 20, 40, 4, True), (2, 32, 36, 4, False), (2, 33, 96, 4, True),
    (1, 101, 64, 4, False), (1, 31, 64, 16, False), (1, 32, 48, 16, True),
    (2, 33, 40, 16, False), (1, 100, 96, 16, True),
    (*SERVE_MAMBA, False)]                        # the training row


def mamba_chk_api(MB) -> bool:
    """Whether these kernel modules keep state checkpoints (the forward's
    second entry point, the backward's ``h_chk``): another checkout's
    modules, timed by ``tools/profile_bwd.py --src``, may predate them."""
    return hasattr(MB, "mamba_scan_with_checkpoints")


def check_scan_bwd_spills(RB, MBB, MB) -> dict:
    """No kernel of the two scan backward libraries spills (every
    instantiation: the chunked backward and the checkpoint kernel at N of
    4, 8, 12 and 16, and the dC sum; another checkout's earlier library:
    its backward at each N and the sum), nor the forward Mamba library
    where it keeps checkpoints (N of 4, 8, 12 and 16, with and without);
    returns name -> registers a thread."""
    regs = {}
    chk = mamba_chk_api(MB)
    expect = {RB.LIB: 1, MBB.LIB: 9 if chk else 5}
    if chk:
        expect[MB.LIB] = 8
    for lib, count in expect.items():
        table = ptxas_table(lib.report())
        check(len(table) == count,
              f"{lib.source.name}: ptxas reported {sorted(table)}")
        for name, (r, st, ld) in table.items():
            check(st == 0 and ld == 0, f"{name} spills: {st} bytes of "
                  f"stores, {ld} bytes of loads")
            regs[name] = r
    log(f"[scan bwd] no spills in the scans' backward kernels; registers a "
        f"thread {regs}")
    return regs


def phase_scan_bwd_kernels(RB, MBB, MB, ref, gen) -> dict:
    """Both scan backward kernels against their plain twins, torch.equal
    (da, db and dC: the twins round and group as the kernels do); two
    launches equal.  The Mamba backward runs both ways: from the forward
    kernel's checkpoints (the training path) and standalone."""
    for shape in SCAN_BWD_RGLRU:
        a, b = scan_inputs(shape, gen)
        h = ref.rglru_scan(a, b)
        dy = torch.randn(shape, device="cuda", generator=gen)
        got = RB.rglru_scan_bwd(a, h, dy)
        again = RB.rglru_scan_bwd(a, h, dy)
        want = ref.rglru_scan_bwd(a, h, dy)
        torch.cuda.synchronize()
        for name, x, y, w in zip(("da", "db"), got, again, want):
            check(torch.equal(x, w) and bool(torch.isfinite(x).all()),
                  f"rglru_scan_bwd {name} at {shape}: max abs err "
                  f"{float((x - w).abs().max()):.3g} against the plain twin")
            check(torch.equal(x, y), f"rglru_scan_bwd {name} at {shape}: "
                  f"two launches differ")
        del a, b, h, dy, got, again, want
    chk_api = mamba_chk_api(MB)
    for *shape, last in SCAN_BWD_MAMBA:
        B, S, D, N = shape
        a, b, C = scan_inputs(tuple(shape), gen, c_shape=(B, S, N))
        dy = torch.randn((B, S, D), device="cuda", generator=gen)
        dl = torch.randn((B, D, N), device="cuda", generator=gen) \
            if last else None
        runs = {}
        if chk_api:
            # the training path: the forward kernel's checkpoints
            chk = MB.mamba_scan_with_checkpoints(a, b, C)[2]
            runs["with the forward's checkpoints"] = MBB.mamba_scan_bwd(
                a, b, C, dy, dl, chk)
            runs["with them, again"] = MBB.mamba_scan_bwd(a, b, C, dy, dl,
                                                          chk)
            del chk
        runs["standalone"] = MBB.mamba_scan_bwd(a, b, C, dy, dl)
        runs["standalone, again"] = MBB.mamba_scan_bwd(a, b, C, dy, dl)
        want = ref.mamba_scan_bwd(a, b, C, dy, dl)
        torch.cuda.synchronize()
        first = next(iter(runs.values()))
        for way, got in runs.items():
            for name, x, y, w in zip(("da", "db", "dC"), got, first, want):
                check(torch.equal(x, w) and bool(torch.isfinite(x).all()),
                      f"mamba_scan_bwd {name} at {shape} (dh_last {last}, "
                      f"{way}): max abs err "
                      f"{float((x - w).abs().max()):.3g} against the plain "
                      f"twin")
                check(torch.equal(x, y), f"mamba_scan_bwd {name} at "
                      f"{shape}: launches differ ({way})")
        del a, b, C, dy, dl, runs, first, want
    torch.cuda.empty_cache()
    ways = ("from the forward kernel's checkpoints and standalone"
            if chk_api else "standalone")
    log(f"[scan bwd] both kernels torch.equal to their plain twins (da, db "
        f"and dC) at rglru {SCAN_BWD_RGLRU} and mamba (B, S, D, N, dh_last) "
        f"{SCAN_BWD_MAMBA}, mamba {ways}; repeated launches give equal bits")
    return {"rglru_scan_bwd": 0.0, "mamba_scan_bwd": 0.0}


def phase_scan_bwd_timing(RB, MBB, MB, ref, gen) -> dict:
    """Each scan backward kernel and its plain twin at the training shapes,
    warm and cold; no single PyTorch call computes either function (None).
    The bound counts each input read once and each output written once, and
    the f32 operations an element: 3 for rglru (a sum, two products), 8
    for mamba (the recomputed update, G's product and sum, da, the carry,
    dC's product and its share of the sums).  The Mamba backward is timed
    on the training path (from the forward kernel's checkpoints: the JSON
    row) and standalone (its own checkpoint launch first), against the one
    bound; the Mamba forward's two entry points beside each other."""
    out = {}
    a, b = scan_inputs(SERVE_RGLRU, gen)
    h = ref.rglru_scan(a, b)
    dy = torch.randn(SERVE_RGLRU, device="cuda", generator=gen)
    n = a.numel()
    out["rglru_scan_bwd"] = timed(
        lambda: RB.rglru_scan_bwd(a, h, dy),
        lambda: ref.rglru_scan_bwd(a, h, dy), None,
        roofline_ms(5 * 4 * n, 3 * n, FP32_OPS_PER_S))
    log(timing_line("rglru_scan_bwd", f"{SERVE_RGLRU} f32",
                    out["rglru_scan_bwd"]))
    del a, b, h, dy
    B, S, D, N = SERVE_MAMBA
    a, b, C = scan_inputs(SERVE_MAMBA, gen, c_shape=(B, S, N))
    dy = torch.randn((B, S, D), device="cuda", generator=gen)
    n = a.numel()
    bound = roofline_ms(4 * (4 * n + 2 * B * S * N + B * S * D), 8 * n,
                        FP32_OPS_PER_S)
    alone = timed(lambda: MBB.mamba_scan_bwd(a, b, C, dy),
                  lambda: ref.mamba_scan_bwd(a, b, C, dy), None, bound)
    if mamba_chk_api(MB):
        chk = MB.mamba_scan_with_checkpoints(a, b, C)[2]
        out["mamba_scan_bwd"] = timed(
            lambda: MBB.mamba_scan_bwd(a, b, C, dy, None, chk),
            lambda: ref.mamba_scan_bwd(a, b, C, dy), None, bound)
        out["mamba_scan_bwd"].update(standalone_ms=alone["ms"],
                                     standalone_cold_ms=alone["cold_ms"])
        log(timing_line("mamba_scan_bwd", f"{SERVE_MAMBA} f32, from the "
                        f"forward's checkpoints (the training path)",
                        out["mamba_scan_bwd"]))
        del chk
    else:
        out["mamba_scan_bwd"] = alone
    log(timing_line("mamba_scan_bwd", f"{SERVE_MAMBA} f32, standalone",
                    alone))
    # the forward beside its checkpointing entry point, in one call; the
    # bound is phase 8's, plus the checkpoints written once
    fwd_bytes = 4 * (2 * n + B * S * N + B * S * D + B * D * N)
    fwd = {"contract": (lambda: MB.mamba_scan_with_state(a, b, C),
                        fwd_bytes)}
    if mamba_chk_api(MB):
        chk_bytes = 4 * B * ((S - 1) // ref.CHECKPOINT_EVERY) * D * N
        fwd["checkpointing"] = (
            lambda: MB.mamba_scan_with_checkpoints(a, b, C),
            fwd_bytes + chk_bytes)
    for name, (fn, nbytes) in fwd.items():
        bound_ms, by = roofline_ms(nbytes, 4 * n, FP32_OPS_PER_S)
        t = {"ms": event_ms(fn), "cold_ms": event_ms(fn, cold=True),
             "bound_ms": bound_ms}
        out.setdefault("mamba_scan_fwd", {})[name] = t
        log(f"[timing] mamba_scan {SERVE_MAMBA} f32, {name} entry point: "
            f"{t['ms']:.5f} ms (cold {t['cold_ms']:.5f}), bound "
            f"{bound_ms:.6f} ms ({by}), {bound_ms / t['cold_ms']:.3f} of "
            f"bound cold")
    del a, b, C, dy
    torch.cuda.empty_cache()
    return out


TRAIN_B, TRAIN_S, TRAIN_STEPS, ZOO_STEPS = 4, 512, 8, 4
RESUME_LAYERS, RESUME_STEPS, RESUME_FAIL = 2, 4, 3
RESUME_DIR = ROOT / "build" / "train_smoke_ckpt"
# granite-moe's configuration weighs the router's aux loss by 0; the run
# here weighs it by 0.01, so that its gradient is on the path
MOE_AUX = 0.01


def params_equal(a, b) -> bool:
    return all(n == m and torch.equal(x, y) for (n, x), (m, y) in
               zip(a.named_parameters(), b.named_parameters(), strict=True))


def loss_and_grads(model, params, batch):
    """``Model.loss`` of a batch and the gradient of every leaf."""
    names, leaves = zip(*params.named_parameters())
    loss, _ = model.loss(params, batch)
    grads = torch.autograd.grad(loss, leaves, allow_unused=True)
    return loss.detach(), {n: torch.zeros_like(p) if g is None else g
                           for n, p, g in zip(names, leaves, grads)}


def grads_close(got, want, frac, what, zero_exact=None) -> float:
    """Each leaf within ``frac`` of its largest entry; returns the largest
    such ratio.  ``zero_exact(name)`` names, for a leaf whose exact
    gradient is zero (both paths return rounding noise), the leaf whose
    largest entry scales it instead."""
    worst = 0.0
    for n, w in want.items():
        other = zero_exact(n) if zero_exact else None
        scale = float((w if other is None else want[other]).abs().max())
        err = float((got[n].float() - w.float()).abs().max())
        check(math.isfinite(err) and err <= frac * scale,
              f"{what}: gradient {n} off by {err:.3g}, over {frac} of its "
              f"largest entry {scale:.3g}")
        worst = max(worst, err / max(scale, 1e-30))
    return worst


def expected_launches(L: int, norms_a_layer: int, steps: int) -> dict:
    """Launches of a train run: under remat "nothing" every layer's forward
    runs twice (the forward, then its recompute in the backward pass) and
    its backward once; the final norm once each way."""
    return {"flash_attention": 2 * L * steps,
            "flash_attention_bwd": L * steps,
            "rmsnorm": (2 * norms_a_layer * L + 1) * steps,
            "rmsnorm_bwd": (norms_a_layer * L + 1) * steps}


def phase_training(get_config, build_model, train_mod, step_mod, data,
                   optim, tf, ops, KB) -> dict:
    """launch.train's path at qwen3-1.7b's full width, then the checks
    around it; returns the launches of the main run and the records."""
    cfg = get_config("qwen3-1.7b")
    L = cfg.num_layers
    model = build_model(cfg)
    tokens = TRAIN_B * TRAIN_S

    def run(c=cfg, steps=TRAIN_STEPS, **kw):
        return train_mod.train(c, steps=steps, batch=TRAIN_B, seq=TRAIN_S,
                               ckpt_dir=None, device="cuda", **kw)

    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    KB.reset_launches()
    t0 = time.perf_counter()
    first = run()
    wall = time.perf_counter() - t0
    launches = {k: v for k, v in KB.LAUNCHES.items() if v}
    peak = torch.cuda.max_memory_allocated()
    want = expected_launches(L, 4, TRAIN_STEPS)
    check(launches == want, f"qwen3 train launches {launches}, expected "
          f"{want} (only the flash and rmsnorm kernels, forward twice and "
          f"backward once a layer a step)")
    losses = [r["loss"] for r in first.records]
    check(all(math.isfinite(x) for x in losses), f"qwen3 losses {losses}")
    # each step's batch is new (random chains over 151,936 tokens), so the
    # steps' losses move by batch noise; the loss of the first batch, seen
    # once, is held before and after the eight steps
    dcfg = data.DataConfig(vocab_size=cfg.vocab_size, seq_len=TRAIN_S,
                           global_batch=TRAIN_B)
    batch = data.batch_at(dcfg, 0, "cuda")
    with torch.no_grad():
        after = float(model.loss(first.state.params, batch)[0])
    check(after < losses[0], f"qwen3: the first batch's loss {losses[0]} "
          f"did not fall in {TRAIN_STEPS} steps ({after})")
    walls = sorted(r["wall_s"] for r in first.records[1:])
    med = statistics.median(walls)
    log(f"[train] qwen3-1.7b full width, {TRAIN_STEPS} steps of {TRAIN_B} x "
        f"{TRAIN_S} from seed 0 through launch.train.train: losses "
        f"{[round(x, 5) for x in losses]}, the first batch's {losses[0]:.5f} "
        f"before and {after:.5f} after; grad norms "
        f"{[round(r['grad_norm'], 4) for r in first.records]}; steps 2-8 "
        f"median {med * 1e3:.3f} ms (min {walls[0] * 1e3:.3f}, max "
        f"{walls[-1] * 1e3:.3f}), {tokens / med:.1f} tokens/s; the run "
        f"with init {wall:.2f} s; peak memory {peak / 2 ** 30:.3f} GiB; "
        f"hand-written kernel launches {launches}, a step "
        f"{ {k: v // TRAIN_STEPS for k, v in launches.items()} }")
    kept = [(n, p.detach().clone())
            for n, p in first.state.params.named_parameters()]
    step1 = first.records[0]
    del first
    torch.cuda.empty_cache()
    second = run()
    check(all(n == m and torch.equal(x, y) for (n, x), (m, y) in zip(
        kept, second.state.params.named_parameters(), strict=True)),
        "two qwen3 train runs from seed 0 give different parameters")
    check([r["loss"] for r in second.records] == losses,
          "two qwen3 train runs give different losses")
    log("[train] a second run from seed 0: every parameter and loss "
        "torch.equal to the first")
    del second, kept
    torch.cuda.empty_cache()

    # step 1 under ops.reference() (bf16): the plain forwards and autograd
    ocfg = optim.OptConfig(lr=1e-3, warmup_steps=20,
                           total_steps=TRAIN_STEPS)

    def fresh(c):
        return step_mod.init_train_state(
            build_model(c), torch.Generator(device="cuda").manual_seed(0),
            "cuda")

    def params_only(c):
        return step_mod.trainable(build_model(c).init(
            torch.Generator(device="cuda").manual_seed(0), device="cuda"))

    with ops.reference():
        st = fresh(cfg)
        _, m = step_mod.make_train_step(model, ocfg)(st, batch)
    del st
    torch.cuda.empty_cache()
    d_loss = abs(float(m["loss"]) - step1["loss"]) / abs(float(m["loss"]))
    d_gn = abs(float(m["grad_norm"]) - step1["grad_norm"]) / float(
        m["grad_norm"])
    check(d_loss <= 2e-2 and d_gn <= 2e-2,
          f"qwen3 step 1 against ops.reference(): loss {step1['loss']} vs "
          f"{float(m['loss'])}, grad norm {step1['grad_norm']} vs "
          f"{float(m['grad_norm'])} (beyond 2e-2 relative)")
    log(f"[train] step 1 against ops.reference() in bf16: loss "
        f"{step1['loss']:.6f} vs {float(m['loss']):.6f} (rel {d_loss:.3g}), "
        f"grad norm {step1['grad_norm']:.6f} vs {float(m['grad_norm']):.6f} "
        f"(rel {d_gn:.3g}), both within 2e-2")

    # float32 compute, TF32 off: every gradient leaf, kernel against plain
    c32 = dataclasses.replace(cfg, compute_dtype="float32")
    m32 = build_model(c32)
    p32 = params_only(c32)
    KB.reset_launches()
    loss_k, g_k = loss_and_grads(m32, p32, batch)
    n32 = dict(KB.LAUNCHES)
    with ops.reference():
        loss_p, g_p = loss_and_grads(m32, p32, batch)
    check(n32["flash_attention_bwd"] == L and n32["rmsnorm_bwd"] == 4 * L + 1,
          f"float32 step launches {n32}")
    worst = grads_close(g_k, g_p, 1e-4, "qwen3 float32 kernel vs plain")
    d32 = abs(float(loss_k) - float(loss_p)) / abs(float(loss_p))
    log(f"[train] float32 compute (TF32 off), kernel against plain: loss "
        f"{float(loss_k):.7f} vs {float(loss_p):.7f} (rel {d32:.3g}); every "
        f"one of {len(g_p)} gradient leaves within 1e-4 of its largest "
        f"entry (worst {worst:.3g})")
    del p32, g_k, g_p
    torch.cuda.empty_cache()

    # the cast_weights_bf16 lever: the gradients reach the f32 leaves
    con = dataclasses.replace(cfg, cast_weights_bf16=True)
    pl = params_only(cfg)
    loss_off, g_off = loss_and_grads(model, pl, batch)
    loss_on, g_on = loss_and_grads(build_model(con), pl, batch)
    cast = [n for n, x, depth in tf._named_leaves(pl, con)
            if tf._casts(x, depth)]
    for n in cast:
        g = g_on[n]
        check(g.dtype == torch.float32 and bool(torch.isfinite(g).all())
              and float(g.abs().max()) > 0,
              f"lever on: no float32 gradient reached {n}")
    worst = grads_close(g_on, g_off, 2e-2, "lever on against off")
    log(f"[train] lever on: {len(cast)} cast leaves, each with a finite "
        f"non-zero float32 gradient; loss {float(loss_on):.6f} (lever off "
        f"{float(loss_off):.6f}, torch.equal: "
        f"{bool(torch.equal(loss_on, loss_off))}); every gradient within "
        f"2e-2 of its largest entry of the lever-off one (worst "
        f"{worst:.3g}: the tied embedding's two cotangents sum in bf16)")
    del pl, g_on, g_off
    torch.cuda.empty_cache()

    # granite-moe (the moe aux loss, head_dim 64) and qwen2-vl (G = 6,
    # M-RoPE, embeds in): ZOO_STEPS steps twice, torch.equal
    for arch in ("granite-moe-1b-a400m", "qwen2-vl-2b"):
        c = get_config(arch)
        if c.moe:
            c = dataclasses.replace(c, moe=dataclasses.replace(
                c.moe, router_aux_loss=MOE_AUX))
        zm = build_model(c)
        g = torch.Generator(device="cuda").manual_seed(1)
        batches = []
        for s in range(ZOO_STEPS):
            b = data.batch_at(data.DataConfig(
                vocab_size=c.vocab_size, seq_len=TRAIN_S,
                global_batch=TRAIN_B), s, "cuda")
            if c.family == "vlm":
                b = {"embeds": torch.randn((TRAIN_B, TRAIN_S, c.d_model),
                                           device="cuda", generator=g
                                           ).to(torch.bfloat16),
                     "labels": b["labels"]}
            batches.append(b)
        runs = []
        for _ in range(2):
            st = fresh(c)
            fn = step_mod.make_train_step(zm, ocfg)
            KB.reset_launches()
            t0 = time.perf_counter()
            recs = []
            for b in batches:
                st, m = fn(st, b)
                recs.append({k: float(v) for k, v in m.items()})
            torch.cuda.synchronize()
            runs.append((st, recs, time.perf_counter() - t0,
                         dict(KB.LAUNCHES)))
        (a, ra, wa, na), (b_, rb, _, _) = runs
        check(params_equal(a.params, b_.params) and ra == rb,
              f"{arch}: two train runs differ")
        check(all(math.isfinite(r["loss"]) for r in ra),
              f"{arch}: a loss is not finite")
        zw = expected_launches(c.num_layers, 4 if c.qk_norm else 2,
                               ZOO_STEPS)
        check({k: na[k] for k in zw} == zw,
              f"{arch}: launches {na}, expected {zw}")
        extra = (f", moe_aux {[round(r['moe_aux'], 5) for r in ra]}, "
                 f"moe_dropped {[round(r['moe_dropped'], 5) for r in ra]}"
                 if c.moe else "")
        log(f"[train] {arch} full width, {ZOO_STEPS} steps of {TRAIN_B} x "
            f"{TRAIN_S}{' from random embeds' if c.family == 'vlm' else ''}"
            f": losses {[round(r['loss'], 5) for r in ra]}{extra}; "
            f"{wa:.2f} s; launches {na}; a second run torch.equal")
        del runs, a, b_, st
        torch.cuda.empty_cache()

    # kill and resume at step RESUME_FAIL on qwen3's widths cut to 2 layers
    cut = dataclasses.replace(cfg, num_layers=RESUME_LAYERS)
    shutil.rmtree(RESUME_DIR, ignore_errors=True)
    clean = run(cut, steps=RESUME_STEPS)
    t0 = time.perf_counter()
    resumed = train_mod.train(cut, steps=RESUME_STEPS, batch=TRAIN_B,
                              seq=TRAIN_S, ckpt_dir=str(RESUME_DIR),
                              ckpt_every=2, keep=1, device="cuda",
                              fail_at_step=RESUME_FAIL)
    t_res = time.perf_counter() - t0
    check(params_equal(clean.state.params, resumed.state.params)
          and all(torch.equal(clean.state.opt.m[n], resumed.state.opt.m[n])
                  and torch.equal(clean.state.opt.v[n],
                                  resumed.state.opt.v[n])
                  for n in clean.state.opt.m),
          "kill and resume: the resumed run differs from the clean one")
    steps_run = [r["step"] for r in resumed.records]
    check(steps_run == [1, 2, 3, 3, 4], f"resumed steps {steps_run}")
    nbytes = sum(f.stat().st_size for f in RESUME_DIR.rglob("*")
                 if f.is_file())
    shutil.rmtree(RESUME_DIR, ignore_errors=True)
    log(f"[train] kill and resume (qwen3-1.7b widths, {RESUME_LAYERS} "
        f"layers, checkpoints every 2 steps, a failure injected at step "
        f"{RESUME_FAIL}): steps {steps_run}, parameters, m and v "
        f"torch.equal to the uninterrupted run; {t_res:.2f} s with a "
        f"{nbytes / 1e9:.3f} GB checkpoint written twice and read once")
    del clean, resumed
    torch.cuda.empty_cache()
    return {"launches": launches, "tokens_per_s": tokens / med,
            "peak_gib": peak / 2 ** 30}


# ---------------------------------------------------------------------------
# phase 14c: the ssm and hybrid families trained on the card
# ---------------------------------------------------------------------------

# full width, depth cut so that the train state (f32 parameters, gradients,
# m and v: 16 bytes a parameter) fits on one card with about 10 GB free:
# falcon-mamba at 24 of 64 layers (3.06 B parameters, 49 GB of state),
# recurrentgemma at 9 of 38, three of its ("rec", "rec", "attn") super
# blocks (2.83 B, 45 GB), so that the hd-256 MQA attention layer (PERF.md
# §6 row 8b) stays on the path.  At 16 and 6 layers the peak on an H100
# 80GB HBM3 at 700 W was 49.9 and 50.3 GiB of its 79.2 (PERF.md §6)
SCAN_TRAIN = (("falcon-mamba-7b", 24), ("recurrentgemma-9b", 9))
SCAN_TRAIN_STEPS = 4
# the step before the Mamba backward read the forward's state checkpoints
# (one H100 80GB HBM3 at 700 W, PERF.md §5), logged beside this run's
SCAN_TRAIN_BEFORE = {"falcon-mamba-7b": "with the two-pass Mamba backward "
                     "that kept no checkpoints: 957.602 ms a step, 2,138.7 "
                     "tokens/s"}


def scan_train_launches(cfg, steps: int) -> dict:
    """The hand-written launches of ``steps`` train steps of the ssm or
    hybrid family under remat "nothing": each layer's forward twice, its
    backward once; the final norm once each way."""
    pat = cfg.hybrid.pattern if cfg.hybrid else ("ssm",)
    kinds = [pat[i % len(pat)] for i in range(cfg.num_layers)]
    n_att = kinds.count("attn")
    n_scan = len(kinds) - n_att
    norms = 1 if cfg.family == "ssm" else 2          # a layer's rmsnorms
    scan = "mamba_scan" if cfg.family == "ssm" else "rglru_scan"
    want = {scan: 2 * n_scan, f"{scan}_bwd": n_scan,
            "rmsnorm": 2 * norms * cfg.num_layers + 1,
            "rmsnorm_bwd": norms * cfg.num_layers + 1}
    if n_att:
        want.update(flash_attention=2 * n_att, flash_attention_bwd=n_att)
    return {k: v * steps for k, v in want.items()}


def phase_scan_training(get_config, build_model, train_mod, step_mod,
                        data, KB, ops) -> dict:
    """falcon-mamba-7b and recurrentgemma-9b at full width and the depth
    cut through ``launch.train.train``: SCAN_TRAIN_STEPS steps of 4 x 512
    from seed 0, twice, ``torch.equal``; then one float32 step's loss and
    every gradient leaf, kernel against ``ops.reference()``, within 1e-4
    of the leaf's largest entry.  Returns the launches of the main runs."""
    tokens = TRAIN_B * TRAIN_S
    total: dict = {}
    for arch, L in SCAN_TRAIN:
        t_arch = time.perf_counter()
        full = get_config(arch)
        cfg = dataclasses.replace(full, num_layers=L)

        def run(c=cfg):
            return train_mod.train(c, steps=SCAN_TRAIN_STEPS, batch=TRAIN_B,
                                   seq=TRAIN_S, ckpt_dir=None, device="cuda")

        torch.cuda.empty_cache()
        torch.cuda.reset_peak_memory_stats()
        KB.reset_launches()
        first = run()
        launches = {k: v for k, v in KB.LAUNCHES.items() if v}
        peak = torch.cuda.max_memory_allocated()
        want = scan_train_launches(cfg, SCAN_TRAIN_STEPS)
        check(launches == want, f"{arch} train launches {launches}, "
              f"expected {want}")
        losses = [r["loss"] for r in first.records]
        check(all(math.isfinite(x) for x in losses), f"{arch} losses "
              f"{losses}")
        walls = sorted(r["wall_s"] for r in first.records[1:])
        med = statistics.median(walls)
        n_params = sum(p.numel() for p in first.state.params.parameters())
        log(f"[train] {arch} full width (d_model {cfg.d_model}), depth cut "
            f"to {L} of {full.num_layers} layers ({n_params:,} parameters, "
            f"{16 * n_params / 1e9:.1f} GB of train state), "
            f"{SCAN_TRAIN_STEPS} steps of {TRAIN_B} x {TRAIN_S} from seed 0 "
            f"through launch.train.train: losses "
            f"{[round(x, 5) for x in losses]}, grad norms "
            f"{[round(r['grad_norm'], 4) for r in first.records]}; steps "
            f"2-{SCAN_TRAIN_STEPS} median {med * 1e3:.3f} ms (min "
            f"{walls[0] * 1e3:.3f}, max {walls[-1] * 1e3:.3f}), "
            f"{tokens / med:.1f} tokens/s; peak memory "
            f"{peak / 2 ** 30:.3f} GiB; hand-written kernel launches "
            f"{launches}" + (f"; {SCAN_TRAIN_BEFORE[arch]}"
                             if arch in SCAN_TRAIN_BEFORE else ""))
        for k, v in launches.items():
            total[k] = total.get(k, 0) + v
        # the first run's parameters wait on the host: beside a second
        # train state they would not fit on the card at this depth
        kept = [(n, p.detach().cpu())
                for n, p in first.state.params.named_parameters()]
        del first
        torch.cuda.empty_cache()
        second = run()
        check(all(n == m and torch.equal(x, y.cpu()) for (n, x), (m, y) in
                  zip(kept, second.state.params.named_parameters(),
                      strict=True)),
              f"two {arch} train runs from seed 0 give different parameters")
        check([r["loss"] for r in second.records] == losses,
              f"two {arch} train runs give different losses")
        del second, kept
        torch.cuda.empty_cache()

        # float32 compute: every gradient leaf, kernel against plain
        c32 = dataclasses.replace(cfg, compute_dtype="float32")
        m32 = build_model(c32)
        p32 = step_mod.trainable(m32.init(
            torch.Generator(device="cuda").manual_seed(0), device="cuda"))
        batch = data.batch_at(data.DataConfig(
            vocab_size=c32.vocab_size, seq_len=TRAIN_S,
            global_batch=TRAIN_B), 0, "cuda")
        KB.reset_launches()
        loss_k, g_k = loss_and_grads(m32, p32, batch)
        n32 = {k: v for k, v in KB.LAUNCHES.items() if v}
        check(n32 == scan_train_launches(c32, 1), f"{arch} float32 step "
              f"launches {n32}")
        with ops.reference():
            loss_p, g_p = loss_and_grads(m32, p32, batch)
        worst = grads_close(g_k, g_p, 1e-4, f"{arch} float32 kernel vs plain")
        d32 = abs(float(loss_k) - float(loss_p)) / abs(float(loss_p))
        check(d32 <= 1e-5, f"{arch} float32 loss {float(loss_k)} vs "
              f"{float(loss_p)}")
        log(f"[train] {arch} float32 compute (TF32 off), kernel against "
            f"plain: loss {float(loss_k):.7f} vs {float(loss_p):.7f} (rel "
            f"{d32:.3g}); every one of {len(g_p)} gradient leaves within "
            f"1e-4 of its largest entry (worst {worst:.3g}); a second run "
            f"of {SCAN_TRAIN_STEPS} steps torch.equal to the first; "
            f"{time.perf_counter() - t_arch:.1f} s for {arch}")
        del p32, g_k, g_p
        torch.cuda.empty_cache()
    return total


# ---------------------------------------------------------------------------
# phase 14d: the mesh path on a world of one
# ---------------------------------------------------------------------------

MESH_STEPS = 2
MESH_CKPT_DIR = ROOT / "build" / "mesh_smoke_ckpt"


def states_equal(a, b) -> bool:
    """Every leaf of two train states (``checkpoint.flatten``'s names)."""
    from repro_torch.checkpoint import flatten
    fa, fb = flatten(a), flatten(b)
    return fa.keys() == fb.keys() and all(torch.equal(fa[n], fb[n])
                                          for n in fa)


def mesh_run(cfg, mesh, step_mod, build_model, data, optim, steps, seed=0):
    """``steps`` train steps of 4 x 512 from seed ``seed`` through
    ``build_model(cfg, mesh)`` (``mesh`` None: the one-process path); the
    state, each step's metrics and wall."""
    model = build_model(cfg, mesh)
    state = step_mod.init_train_state(
        model, torch.Generator(device="cuda").manual_seed(seed), "cuda")
    fn = step_mod.make_train_step(model, optim.OptConfig(
        lr=1e-3, warmup_steps=20, total_steps=TRAIN_STEPS))
    dcfg = data.DataConfig(vocab_size=cfg.vocab_size, seq_len=TRAIN_S,
                           global_batch=TRAIN_B)
    recs, walls = [], []
    for s in range(steps):
        b = data.batch_at(dcfg, s, "cuda")
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        state, m = fn(state, b)
        torch.cuda.synchronize()
        walls.append(time.perf_counter() - t0)
        recs.append(m)
    return state, recs, walls


def metrics_same(a, b) -> bool:
    return all(x.keys() == y.keys() and all(torch.equal(x[k], y[k])
                                            for k in x)
               for x, y in zip(a, b, strict=True))


def phase_mesh(get_config, build_model, step_mod, data, optim, ckpt, dist,
               mesh_mod, KB, smi) -> dict:
    """The mesh path (``launch.mesh``, ``models.parallel``) on a ("data",
    "model") mesh of (1, 1) over an NCCL group of one process: qwen3-1.7b
    at full width and granite-moe-1b-a400m through the expert-parallel
    path (``n_shards`` 1), MESH_STEPS steps each, each ``torch.equal``
    to the one-process steps (loss, grad norm, every parameter, m and v:
    a mesh axis of 1 takes no mask and no collective); qwen3's widths cut
    to 2 layers, saved under the mesh and restored with ``restore_into(...,
    mesh=)``, equal leaf for leaf.  The group is destroyed at the end.
    Returns the mesh runs' kernel launches."""
    from torch.distributed import HashStore
    dist.init("nccl", store=HashStore(), rank=0, world_size=1)
    launches = {}
    try:
        mesh = mesh_mod.make_mesh((1, 1), ("data", "model"), "cuda")
        cfg = get_config("qwen3-1.7b")
        plain, plain_recs, plain_walls = mesh_run(
            cfg, None, step_mod, build_model, data, optim, MESH_STEPS)
        torch.cuda.empty_cache()
        torch.cuda.reset_peak_memory_stats()
        KB.reset_launches()
        sharded, recs, walls = mesh_run(cfg, mesh, step_mod, build_model,
                                        data, optim, MESH_STEPS)
        launches = {k: v for k, v in KB.LAUNCHES.items() if v}
        peak = torch.cuda.max_memory_allocated()
        check(build_model(cfg, mesh).sharding is not None,
              "qwen3 on the mesh did not take the mesh path")
        check(metrics_same(recs, plain_recs),
              f"qwen3 on the (1, 1) mesh: metrics {recs} differ from the "
              f"one-process run's {plain_recs}")
        check(states_equal(sharded, plain), "qwen3 on the (1, 1) mesh: "
              "parameters, m or v differ from the one-process run")
        want = expected_launches(cfg.num_layers, 4, MESH_STEPS)
        check(launches == want, f"qwen3 mesh launches {launches}, expected "
              f"{want}")
        log(f"[mesh] {smi}")
        log(f"[mesh] qwen3-1.7b full width on a (1, 1) (data, model) mesh "
            f"over NCCL, {MESH_STEPS} steps of {TRAIN_B} x {TRAIN_S} from "
            f"seed 0: losses {[round(float(r['loss']), 5) for r in recs]}, "
            f"grad norms {[round(float(r['grad_norm']), 4) for r in recs]}; "
            f"loss, grad norm and every parameter, m and v torch.equal to "
            f"the one-process run")
        log(f"[mesh] step walls: mesh path "
            f"{[round(w * 1e3, 3) for w in walls]} ms, one-process "
            f"{[round(w * 1e3, 3) for w in plain_walls]} ms; peak memory of "
            f"the mesh run {peak / 2 ** 30:.3f} GiB (the one-process state "
            f"held beside it); launches {launches}")
        del plain, sharded, plain_recs, recs
        torch.cuda.empty_cache()

        c = get_config("granite-moe-1b-a400m")
        c = dataclasses.replace(c, moe=dataclasses.replace(
            c.moe, router_aux_loss=MOE_AUX))
        plain, plain_recs, plain_walls = mesh_run(
            c, None, step_mod, build_model, data, optim, MESH_STEPS)
        KB.reset_launches()
        sharded, recs, walls = mesh_run(c, mesh, step_mod, build_model,
                                        data, optim, MESH_STEPS)
        for k, v in KB.LAUNCHES.items():
            launches[k] = launches.get(k, 0) + v
        check(metrics_same(recs, plain_recs) and states_equal(sharded,
                                                              plain),
              "granite-moe on the (1, 1) mesh differs from the one-process "
              "step")
        log(f"[mesh] granite-moe-1b-a400m full width, {MESH_STEPS} steps "
            f"through the expert-parallel path (n_shards 1, aux loss "
            f"weighed {MOE_AUX}): losses "
            f"{[round(float(r['loss']), 5) for r in recs]}, moe_aux "
            f"{[round(float(r['moe_aux']), 5) for r in recs]}; torch.equal "
            f"to the one-process steps; walls mesh path "
            f"{[round(w * 1e3, 3) for w in walls]} ms, one-process "
            f"{[round(w * 1e3, 3) for w in plain_walls]} ms")
        del plain, sharded
        torch.cuda.empty_cache()

        cut = dataclasses.replace(cfg, num_layers=RESUME_LAYERS)
        shutil.rmtree(MESH_CKPT_DIR, ignore_errors=True)
        state, _, _ = mesh_run(cut, mesh, step_mod, build_model, data,
                               optim, 1)
        t0 = time.perf_counter()
        ckpt.save(str(MESH_CKPT_DIR), 1, state, keep=1, mesh=mesh)
        t_save = time.perf_counter() - t0
        fresh = step_mod.init_train_state(
            build_model(cut, mesh),
            torch.Generator(device="cuda").manual_seed(1), "cuda")
        t0 = time.perf_counter()
        back, man = ckpt.restore_into(str(MESH_CKPT_DIR), fresh, mesh=mesh)
        torch.cuda.synchronize()
        t_restore = time.perf_counter() - t0
        check(man["step"] == 1 and states_equal(back, state),
              "the state restored under the mesh differs from the saved one")
        nbytes = sum(f.stat().st_size for f in MESH_CKPT_DIR.rglob("*")
                     if f.is_file())
        shutil.rmtree(MESH_CKPT_DIR, ignore_errors=True)
        log(f"[mesh] qwen3-1.7b widths at {RESUME_LAYERS} layers: saved "
            f"under the mesh in {t_save:.2f} s ({nbytes / 1e9:.3f} GB), "
            f"restored with restore_into(..., mesh=) in {t_restore:.2f} s, "
            f"every leaf torch.equal")
        del state, fresh, back
        torch.cuda.empty_cache()
    finally:
        dist.destroy()
    return launches


# ---------------------------------------------------------------------------
# phase 5, continued: the decode kernel's partial entry point
# ---------------------------------------------------------------------------

# decode_32k's per-device cache on the (16, 16) mesh: B 128 / 16, S 32768 /
# 16 (B, S, Hq, Hkv, hd), and the kept ranges of a rank's slice: every slot
# (a slice before pos), part of it (the slice that holds pos), none (a
# slice past pos)
PARTIAL_SHAPE = (8, 2048, 16, 8, 128)
PARTIAL_RANGES = [(0, 2047), (0, 1000), (0, -1)]
# the emulated 16-rank flash-decode: (B, S, Hq, Hkv, hd), pos
EMULATED = [((4, 1024, 16, 8, 128), 1023), ((8, 32768, 16, 8, 128), 32767)]
EMULATED_RANKS = 16


def partial_bound_ms(B, S, Hq, Hkv, hd, kept, elt=2) -> tuple:
    """q read once, the kept K and V rows read once, the partial (f32, hd
    + 2 a head) written once; 4·hd flops a (query head, kept slot)."""
    nbytes = elt * (B * Hq * hd + 2 * B * kept * Hkv * hd) \
        + 4 * B * Hq * (hd + 2)
    return roofline_ms(nbytes, 4 * hd * B * Hq * kept, BF16_OPS_PER_S)


def phase_partial(DA, ref, gen) -> tuple:
    """The partial entry point against its plain twin at PARTIAL_SHAPE in
    bf16 (o and m at phase 5's 2e-2, l at rtol 2e-2: a sum of up to S
    weights; the empty range exactly o = 0, m = -inf, l = 0), 50 launches
    equal; the emulated flash-decode: the cache
    cut into EMULATED_RANKS slices, each through the partial kernel, the
    partials combined in rank order (``combine_partials``), held against
    the whole-cache kernel and the plain path at 2e-2; then the kernel
    timed warm and cold at the slice with every slot kept, beside its twin
    and the library call that returns the same partial (the efficient
    SDPA kernel with its log-sum-exp, on K and V repeated to the query
    heads: it takes no grouped heads).  Returns (max error, timing)."""
    t0 = time.perf_counter()
    B, S, Hq, Hkv, hd = PARTIAL_SHAPE
    q, k, v = attn_inputs((B, Hq, hd), (B, S, Hkv, hd), BF16, gen)
    err = 0.0
    for lo, hi in PARTIAL_RANGES:
        got = DA.decode_attention_partial(q, k, v, lo, hi)
        want = ref.decode_attention_partial(q, k, v, lo, hi)
        torch.cuda.synchronize()
        what = f"partial at {PARTIAL_SHAPE} slots {lo}..{hi}"
        check(not bool(torch.isnan(got).any()), f"{what}: NaN")
        if hi < lo:
            check(bool((got[..., hd] == -math.inf).all())
                  and bool((got[..., hd + 1] == 0).all())
                  and bool((got[..., :hd] == 0).all()),
                  f"{what}: an empty slice is not o = 0, m = -inf, l = 0")
        else:
            err = max(err, assert_close(got[..., :hd], want[..., :hd], 2e-2,
                                        f"{what}: o"))
            assert_close(got[..., hd], want[..., hd], 2e-2, f"{what}: m")
            assert_close(got[..., hd + 1], want[..., hd + 1], 2e-2,
                         f"{what}: l", atol=0.0)
        again = [DA.decode_attention_partial(q, k, v, lo, hi)
                 for _ in range(50)]
        check(all(torch.equal(got, x) for x in again),
              f"{what}: 50 launches differ")
    for (Be, Se, Hqe, Hkve, hde), pos in EMULATED:
        qe, ke, ve = attn_inputs((Be, Hqe, hde), (Be, Se, Hkve, hde), BF16,
                                 gen)
        n = Se // EMULATED_RANKS
        parts = [DA.decode_attention_partial(
            qe, ke[:, r * n:(r + 1) * n].contiguous(),
            ve[:, r * n:(r + 1) * n].contiguous(),
            *DA.slice_range(pos, 0, r * n, n))
            for r in range(EMULATED_RANKS)]
        got = DA.combine_partials(parts).to(BF16)
        whole = DA.decode_attention(qe, ke, ve, pos)
        plain = ref.decode_attention(qe, ke, ve, pos)
        torch.cuda.synchronize()
        what = f"{EMULATED_RANKS}-rank flash-decode at {(Be, Se, Hqe, Hkve, hde)} pos {pos}"
        e1 = assert_close(got, whole, 2e-2, f"{what} vs the whole-cache "
                          f"kernel")
        e2 = assert_close(got, plain, 2e-2, f"{what} vs the plain path")
        log(f"[partial] {what}: max abs err {e1:.4g} against the "
            f"whole-cache kernel, {e2:.4g} against the plain path")
        del qe, ke, ve, parts, got, whole, plain
    q4 = q[:, :, None, :]
    kt, vt = (x.repeat_interleave(Hq // Hkv, dim=2).transpose(1, 2)
              .contiguous() for x in (k, v))
    eff = torch.ops.aten._scaled_dot_product_efficient_attention
    lib = eff(q4, kt, vt, None, True)
    mine = DA.decode_attention_partial(q, k, v, 0, S - 1)
    assert_close(lib[0][:, :, 0], mine[..., :hd], 2e-2,
                 "efficient SDPA's o against the partial kernel's")
    assert_close(lib[1][:, :, 0], mine[..., hd] + torch.log(mine[..., hd + 1]),
                 2e-2, "efficient SDPA's log-sum-exp against m + log l")
    t = timed(lambda: DA.decode_attention_partial(q, k, v, 0, S - 1),
              lambda: ref.decode_attention_partial(q, k, v, 0, S - 1),
              lambda: eff(q4, kt, vt, None, True),
              partial_bound_ms(B, S, Hq, Hkv, hd, S))
    log(timing_line("decode_attention_partial", f"{PARTIAL_SHAPE} slots "
                    f"0..{S - 1} bf16 (decode_32k's slice on (16, 16))", t))
    log(f"[partial] the partial entry point matches its plain twin at "
        f"{PARTIAL_SHAPE} slots {PARTIAL_RANGES} (2e-2 bf16; the empty "
        f"range o = 0, m = -inf, l = 0), 50 launches equal; max_abs_err "
        f"of o {err:.4g}; checks and timing {time.perf_counter() - t0:.1f} s")
    del q, k, v, kt, vt, lib, mine
    torch.cuda.empty_cache()
    return err, t


# ---------------------------------------------------------------------------
# phase 14b, continued: the scans at the tensor-parallel widths
# ---------------------------------------------------------------------------

# 4 x 512 tokens at W = 4096 / m (recurrentgemma's RG-LRU) and D = 8192 / m
# (falcon-mamba's d_inner) for m = 2 and 4 "model" ranks
TP_SCANS = [(m, (4, 512, 4096 // m), (4, 512, 8192 // m, 16)) for m in (2, 4)]


def phase_tp_scans(RG, MB, RB, MBB, ref, gen) -> dict:
    """The scan kernels at TP_SCANS's rank-local widths, held as their
    contracts require: rglru_scan's h, mamba_scan's h_last and
    checkpoints, and both backward kernels' gradients torch.equal to their
    twins (mamba_scan's y at rtol 2e-4, atol 3e-5, its own summation
    order); the checkpointing entry point's y and h_last torch.equal to
    the contract entry point's; then each timed warm and cold at m = 4
    beside its twin (the median of 5 calls of the plain loop) and its
    bound.  Returns the mamba y's largest error."""
    t0 = time.perf_counter()
    err = 0.0
    timing = {}
    for m, rshape, mshape in TP_SCANS:
        a, b = scan_inputs(rshape, gen)
        h = RG.rglru_scan(a, b)
        check(torch.equal(h, ref.rglru_scan(a, b)),
              f"rglru_scan at {rshape} (W / {m}) differs from its twin")
        dy = torch.randn(rshape, device="cuda", generator=gen)
        got, want = RB.rglru_scan_bwd(a, h, dy), ref.rglru_scan_bwd(a, h, dy)
        check(all(torch.equal(x, w) for x, w in zip(got, want)),
              f"rglru_scan_bwd at {rshape} (W / {m}) differs from its twin")
        if m == 4:
            n = a.numel()
            timing["rglru_scan"] = timed(
                lambda: RG.rglru_scan(a, b), lambda: ref.rglru_scan(a, b),
                None, roofline_ms(3 * 4 * n, 2 * n, FP32_OPS_PER_S),
                plain_reps=5)
            timing["rglru_scan_bwd"] = timed(
                lambda: RB.rglru_scan_bwd(a, h, dy),
                lambda: ref.rglru_scan_bwd(a, h, dy), None,
                roofline_ms(5 * 4 * n, 3 * n, FP32_OPS_PER_S),
                plain_reps=5)
        del a, b, h, dy, got, want
        B, S, D, N = mshape
        a, b, C = scan_inputs(mshape, gen, c_shape=(B, S, N))
        (y, hl), (wy, wh) = MB.mamba_scan_with_state(a, b, C), \
            ref.mamba_scan_with_state(a, b, C)
        err = max(err, assert_close(y, wy, 2e-4, f"mamba_scan y at {mshape}",
                                    atol=3e-5))
        check(torch.equal(hl, wh), f"mamba_scan h_last at {mshape} (D / "
              f"{m}) differs from its twin")
        y2, h2, chk = MB.mamba_scan_with_checkpoints(a, b, C)
        check(torch.equal(y2, y) and torch.equal(h2, hl)
              and torch.equal(chk, ref.mamba_scan_checkpoints(a, b)),
              f"mamba_scan_with_checkpoints at {mshape} (D / {m}) differs")
        dy = torch.randn((B, S, D), device="cuda", generator=gen)
        got = MBB.mamba_scan_bwd(a, b, C, dy, None, chk)
        want = ref.mamba_scan_bwd(a, b, C, dy)
        check(all(torch.equal(x, w) for x, w in zip(got, want)),
              f"mamba_scan_bwd at {mshape} (D / {m}) differs from its twin")
        if m == 4:
            n = a.numel()
            timing["mamba_scan"] = timed(
                lambda: MB.mamba_scan_with_state(a, b, C),
                lambda: ref.mamba_scan_with_state(a, b, C), None,
                roofline_ms(4 * (2 * n + B * S * N + B * S * D + B * D * N),
                            4 * n, FP32_OPS_PER_S), plain_reps=5)
            timing["mamba_scan_bwd"] = timed(
                lambda: MBB.mamba_scan_bwd(a, b, C, dy, None, chk),
                lambda: ref.mamba_scan_bwd(a, b, C, dy), None,
                roofline_ms(4 * (4 * n + 2 * B * S * N + B * S * D), 8 * n,
                            FP32_OPS_PER_S), plain_reps=5)
        del a, b, C, y, hl, wy, wh, y2, h2, chk, dy, got, want
    for name, t in timing.items():
        shape = TP_SCANS[1][1] if name.startswith("rglru") else TP_SCANS[1][2]
        log(timing_line(name, f"{shape} f32 (TP-local, m = 4)", t))
    torch.cuda.empty_cache()
    log(f"[tp-scans] rglru_scan and its backward at W = 4096 / m, "
        f"mamba_scan (both entry points) and its backward at D = 8192 / m, "
        f"m in (2, 4), as their contracts require (torch.equal; mamba's y "
        f"max abs err {err:.3g}); {time.perf_counter() - t0:.1f} s")
    return {"mamba_scan": err}


# ---------------------------------------------------------------------------
# phase 14d, continued: serving and the other families on the (1, 1) mesh
# ---------------------------------------------------------------------------

# the families trained and served at full width and a depth cut
MESH_FAMILY_LAYERS = {"falcon-mamba-7b": 2, "recurrentgemma-9b": 3,
                      "whisper-medium": 2}
MESH_DECODE_STEPS = 8
MESH_TRAIN = (2, 256)             # the families' train batch and prompt


def trees_equal(a, b) -> bool:
    """Two nested caches (dicts, lists, tuples of tensors) bit for bit."""
    if torch.is_tensor(a):
        return torch.equal(a, b)
    if isinstance(a, dict):
        return a.keys() == b.keys() and all(trees_equal(a[k], b[k])
                                            for k in a)
    return len(a) == len(b) and all(trees_equal(x, y) for x, y in zip(a, b))


def serve_run(model, params, prompt, steps, frames=None):
    """Prefill ``prompt`` (tokens, or embeds when floating; over
    ``frames`` for the encdec family), ``model.fill_cache`` into a cache of
    prompt + steps slots, ``steps`` greedy decode steps.  Returns (logits
    per step, the caches)."""
    P = prompt.shape[1]
    if frames is not None:
        batch = {"enc_embeds": frames, "tokens": prompt}
    elif prompt.is_floating_point():
        batch = {"embeds": prompt}
    else:
        batch = {"tokens": prompt}
    with torch.inference_mode():
        last, pc = model.prefill(params, batch)
        caches = model.fill_cache(
            model.init_cache(prompt.shape[0], P + steps), pc)
        del pc
        out, logits = [last], last
        for t in range(steps):
            logits, caches = model.decode_step(
                params, caches, {"token": logits.argmax(-1)[:, None],
                                 "pos": P + t})
            out.append(logits)
    torch.cuda.synchronize()
    return torch.stack(out, 1), caches


def phase_mesh_serving(get_config, build_model, step_mod, optim, dist,
                       mesh_mod, KB, gen) -> dict:
    """On a (1, 1) ("data", "model") mesh over an NCCL group of one:
    qwen3-1.7b and granite-moe-1b-a400m at full width, a prefill of 4 x 512
    and 64 greedy decode steps through ``build_model(cfg, mesh)`` (the
    serving layout, ``shard_params``); falcon-mamba-7b, recurrentgemma-9b
    and whisper-medium at full width and a depth cut
    (MESH_FAMILY_LAYERS): one train step, then a prefill and
    MESH_DECODE_STEPS decode steps; each logits, cache and train state
    torch.equal to the one-process run's.  Returns the mesh runs' kernel
    launches: (serving, training)."""
    from torch.distributed import HashStore
    t_phase = time.perf_counter()
    dist.init("nccl", store=HashStore(), rank=0, world_size=1)
    launches, trained = {}, {}

    def count(into=launches):
        for k, v in KB.LAUNCHES.items():
            into[k] = into.get(k, 0) + v

    try:
        mesh = mesh_mod.make_mesh((1, 1), ("data", "model"), "cuda")
        for arch in ("qwen3-1.7b", "granite-moe-1b-a400m"):
            t0 = time.perf_counter()
            cfg = get_config(arch)
            one = build_model(cfg)
            params = one.init(torch.Generator(device="cuda").manual_seed(0))
            prompt = torch.randint(0, cfg.vocab_size, (DECODE_B, PROMPT),
                                   device="cuda", generator=gen)
            want, wc = serve_run(one, params, prompt, STEPS)
            del wc
            sharded = build_model(cfg, mesh)
            step_mod.shard_params(params, mesh)
            KB.reset_launches()
            got, gc = serve_run(sharded, params, prompt, STEPS)
            count()
            check(sharded.serve_sharding is not None and torch.equal(got, want),
                  f"{arch} served on the (1, 1) mesh: logits differ from "
                  f"the one-process run's")
            log(f"[mesh] {arch} full width on the (1, 1) mesh: prefill "
                f"{DECODE_B} x {PROMPT} and {STEPS} greedy decode steps "
                f"through the serving layout, logits torch.equal to one "
                f"process; {time.perf_counter() - t0:.1f} s")
            del params, prompt, want, got, gc
            torch.cuda.empty_cache()
        opt = optim.OptConfig(lr=1e-3, warmup_steps=20,
                              total_steps=TRAIN_STEPS)
        for arch, layers in MESH_FAMILY_LAYERS.items():
            t0 = time.perf_counter()
            cfg = get_config(arch)
            kw = {"num_layers": layers}
            if cfg.family == "encdec":
                kw["encdec"] = dataclasses.replace(cfg.encdec,
                                                   encoder_layers=layers)
            cfg = dataclasses.replace(cfg, **kw)
            g = torch.Generator(device="cuda").manual_seed(1)
            batch = {"tokens": torch.randint(0, cfg.vocab_size,
                                             MESH_TRAIN, device="cuda",
                                             generator=g)}
            batch["labels"] = torch.roll(batch["tokens"], -1, 1)
            frames = None
            if cfg.family == "encdec":
                frames = torch.randn((MESH_TRAIN[0],
                                      cfg.encdec.source_positions,
                                      cfg.d_model), device="cuda",
                                     generator=g).to(BF16)
                batch["enc_embeds"] = frames
            states, recs, served = [], [], []
            for m in (None, mesh):
                model = build_model(cfg, m)
                st = step_mod.init_train_state(
                    model, torch.Generator(device="cuda").manual_seed(0))
                KB.reset_launches()
                st, met = step_mod.make_train_step(model, opt)(st, batch)
                if m is not None:
                    count(trained)
                states.append(st)
                recs.append(met)
                params = st.params
                if m is not None:
                    # the serving layout is the train layout here
                    step_mod.shard_params(params, m)
                KB.reset_launches()
                served.append(serve_run(model, params, batch["tokens"],
                                        MESH_DECODE_STEPS, frames))
                if m is not None:
                    count()
            check(metrics_same(recs[1:], recs[:1])
                  and states_equal(states[1], states[0]),
                  f"{arch}: the train step on the (1, 1) mesh differs from "
                  f"one process")
            check(torch.equal(served[1][0], served[0][0])
                  and trees_equal(served[1][1], served[0][1]),
                  f"{arch}: prefill and decode on the (1, 1) mesh differ "
                  f"from one process")
            log(f"[mesh] {arch} full width at {layers} layers on the (1, 1) "
                f"mesh: one train step of {MESH_TRAIN} (loss "
                f"{float(recs[1]['loss']):.5f}), then a prefill of "
                f"{MESH_TRAIN} and {MESH_DECODE_STEPS} decode "
                f"steps; state, logits and caches torch.equal to one "
                f"process; {time.perf_counter() - t0:.1f} s")
            del states, recs, served, batch, frames, params, st
            torch.cuda.empty_cache()
    finally:
        dist.destroy()
    log(f"[mesh] serving and the other families on the (1, 1) mesh took "
        f"{time.perf_counter() - t_phase:.1f} s; launches: serving "
        f"{launches}, training {trained}")
    return launches, trained


# ---------------------------------------------------------------------------
# phase 14e: the distributed flash-decode on a (1, 2) mesh sharing the card
# ---------------------------------------------------------------------------

SPLIT_LAYERS, SPLIT_STEPS = 4, 16
SPLIT_DIR = ROOT / "build" / "mesh_split_smoke"


def split_rank(rank: int, world: int, cfg, prompt, forced) -> None:
    """A rank of phase 14e: a gloo group from a file store (the card's
    tensors go through the host), a (1, 2) mesh, qwen3's shards in the
    serving layout, a prefill and SPLIT_STEPS decode steps of forced
    tokens; writes its logits, its caches' shapes and its launches."""
    from repro_torch.kernels import build as KB
    from repro_torch.launch import dist
    from repro_torch.launch.mesh import make_mesh
    from repro_torch.launch.step import shard_params
    from repro_torch.models import build_model
    torch.cuda.set_device(0)
    prompt, forced = prompt.cuda(), forced.cuda()
    dist.init("gloo", init_method=f"file://{SPLIT_DIR / 'store'}",
              rank=rank, world_size=world)
    try:
        mesh = make_mesh((1, world), ("data", "model"), "cpu")
        model = build_model(cfg, mesh)
        params = shard_params(model.init(
            torch.Generator(device="cuda").manual_seed(0)), mesh)
        P = prompt.shape[1]
        with torch.inference_mode():
            KB.reset_launches()
            last, pc = model.prefill(params, {"tokens": prompt})
            caches = model.fill_cache(
                model.init_cache(prompt.shape[0], P + SPLIT_STEPS), pc)
            out = [last]
            for t in range(SPLIT_STEPS):
                logits, caches = model.decode_step(
                    params, caches, {"token": forced[:, t:t + 1],
                                     "pos": P + t})
                out.append(logits)
            torch.cuda.synchronize()
        torch.save({"logits": torch.stack(out, 1).cpu(),
                    "cache": tuple(caches["k"].shape),
                    "launches": dict(KB.LAUNCHES)},
                   SPLIT_DIR / f"rank{rank}.pt")
    finally:
        dist.destroy()


def phase_split_decode(get_config, build_model, gen) -> dict:
    """qwen3-1.7b at full width and SPLIT_LAYERS layers on a (1, 2) mesh of
    two processes that share the card over gloo: the "model" axis splits
    the attention heads, the MLP columns, the vocabulary and the K/V cache
    along S, so decode goes through the distributed flash-decode, the
    partial kernel on each rank's slice.  The ranks' logits against the
    one-process run's (phase 7's rule, 2e-2 of the largest), equal to each
    other, the cache's S halved, and the partial kernel launched
    SPLIT_LAYERS x SPLIT_STEPS times on each rank.  Returns rank 0's
    launches."""
    t0 = time.perf_counter()
    cfg = dataclasses.replace(get_config("qwen3-1.7b"),
                              num_layers=SPLIT_LAYERS)
    shutil.rmtree(SPLIT_DIR, ignore_errors=True)
    SPLIT_DIR.mkdir(parents=True)
    prompt = torch.randint(0, cfg.vocab_size, (DECODE_B, PROMPT // 4),
                           device="cuda", generator=gen)
    forced = torch.randint(0, cfg.vocab_size, (DECODE_B, SPLIT_STEPS),
                           device="cuda", generator=gen)
    model = build_model(cfg)
    params = model.init(torch.Generator(device="cuda").manual_seed(0))
    P = prompt.shape[1]
    with torch.inference_mode():
        last, pc = model.prefill(params, {"tokens": prompt})
        caches = model.fill_cache(model.init_cache(DECODE_B, P + SPLIT_STEPS),
                                  pc)
        want = [last]
        for t in range(SPLIT_STEPS):
            logits, caches = model.decode_step(
                params, caches, {"token": forced[:, t:t + 1], "pos": P + t})
            want.append(logits)
    want = torch.stack(want, 1).cpu()
    del params, caches, pc
    torch.cuda.empty_cache()
    torch.multiprocessing.spawn(split_rank, args=(2, cfg, prompt.cpu(),
                                                  forced.cpu()),
                                nprocs=2, join=True)
    ranks = [torch.load(SPLIT_DIR / f"rank{r}.pt") for r in range(2)]
    shutil.rmtree(SPLIT_DIR, ignore_errors=True)
    err = logits_close(ranks[0]["logits"].cuda(), want.cuda(),
                       "the (1, 2) mesh's logits vs one process")
    check(torch.equal(ranks[0]["logits"], ranks[1]["logits"]),
          "the two ranks' logits differ")
    n = SPLIT_LAYERS * SPLIT_STEPS
    for r, res in enumerate(ranks):
        check(res["launches"]["decode_attention_partial"] == n
              and res["launches"]["decode_attention"] == 0,
              f"rank {r} launched the partial kernel "
              f"{res['launches']['decode_attention_partial']} times, the "
              f"whole-cache one {res['launches']['decode_attention']}; "
              f"expected {n} and 0")
        check(res["cache"][2] == (P + SPLIT_STEPS) // 2,
              f"rank {r}'s cache {res['cache']} does not hold half the "
              f"slots")
    log(f"[split] qwen3-1.7b full width at {SPLIT_LAYERS} layers on a (1, 2) "
        f"mesh of two processes sharing the card over gloo: prefill "
        f"{DECODE_B} x {P}, {SPLIT_STEPS} decode steps through the "
        f"distributed flash-decode (each rank's K/V cache "
        f"{ranks[0]['cache']}, the partial kernel launched {n} times a "
        f"rank); logits within 2e-2 of the largest of one process's (max "
        f"abs err {err:.4g}), the ranks' equal; "
        f"{time.perf_counter() - t0:.1f} s; rank 0's launches "
        f"{ranks[0]['launches']}")
    return {k: v for k, v in ranks[0]["launches"].items() if v}


# ---------------------------------------------------------------------------
# phase 15: whisper-medium (encdec) at full width, served and trained
# ---------------------------------------------------------------------------

WHISPER_B, WHISPER_PROMPT, WHISPER_STEPS = 4, 64, 64
WHISPER_TRAIN_S, WHISPER_TRAIN_STEPS = 448, 3


def whisper_run(model, params, frames, prompt, steps, forced=None):
    """Prefill of ``prompt`` over ``frames``, its self K/V copied into a
    cache of prompt + steps slots (the caller's step, as in the
    reference), ``steps`` decode steps: greedy, or the ``forced`` tokens.
    Returns (logits per step, starting with the prefill's last, tokens
    fed, prefill s, decode s)."""
    P = prompt.shape[1]
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    last, pc = model.prefill(params, {"enc_embeds": frames,
                                      "tokens": prompt})
    torch.cuda.synchronize()
    t1 = time.perf_counter()
    caches = model.init_cache(prompt.shape[0], P + steps,
                              device=prompt.device)
    for j in (0, 1):
        caches[j][:, :, :P] = pc[j]
    for j in (2, 3):
        caches[j].copy_(pc[j])
    del pc
    out, fed, logits = [last], [], last
    for t in range(steps):
        nxt = logits.argmax(-1)[:, None] if forced is None \
            else forced[:, t:t + 1]
        fed.append(nxt)
        logits, caches = model.decode_step(params, caches,
                                           {"token": nxt, "pos": P + t})
        out.append(logits)
    torch.cuda.synchronize()
    return (torch.stack(out, 1), torch.cat(fed, 1), t1 - t0,
            time.perf_counter() - t1)


def phase_whisper(get_config, build_model, step_mod, optim, ops, KB,
                  gen) -> dict:
    """whisper-medium at full width (24 + 24 layers, random weights from
    seed 0, frames [4, 1500, 1024] from the phase's generator): prefill and
    greedy decode twice (torch.equal), every step against forward and
    against a teacher-forced run under ``ops.reference()`` at phase 7's
    tolerance, then the lever on (``torch.equal``); then training through
    ``make_train_step``, twice, ``torch.equal``, and the float32 gradient
    check.  Returns the launches of the serving and training runs."""
    t_phase = time.perf_counter()
    cfg = get_config("whisper-medium")
    E, L = cfg.encdec.encoder_layers, cfg.num_layers
    F = cfg.encdec.source_positions
    model = build_model(cfg)
    params = model.init(torch.Generator(device="cuda").manual_seed(0),
                        device="cuda")
    frames = torch.randn((WHISPER_B, F, cfg.d_model), device="cuda",
                         generator=gen).to(torch.bfloat16)
    prompt = torch.randint(0, cfg.vocab_size, (WHISPER_B, WHISPER_PROMPT),
                           device="cuda", generator=gen)
    with torch.inference_mode():
        whisper_run(model, params, frames, prompt[:, :8], 2)   # warm-up
        torch.cuda.reset_peak_memory_stats()
        KB.reset_launches()
        logits, fed, t_pre, t_dec = whisper_run(model, params, frames,
                                                prompt, WHISPER_STEPS)
        serve = {k: v for k, v in KB.LAUNCHES.items() if v}
        peak = torch.cuda.max_memory_allocated() / 2 ** 30
        want = {"flash_attention": E + 2 * L,
                "decode_attention": 2 * L * WHISPER_STEPS}
        check(serve == want, f"whisper serving launches {serve}, expected "
              f"{want}")
        again = whisper_run(model, params, frames, prompt, WHISPER_STEPS)
        check(torch.equal(again[0], logits) and torch.equal(again[1], fed),
              "two whisper decode runs differ")
        full = model.forward(params, {"enc_embeds": frames, "tokens":
                                      torch.cat([prompt, fed], 1)})[0]
        ferr = max(logits_close(logits[:, t], full[:, WHISPER_PROMPT - 1 + t],
                                f"whisper decode step {t} vs forward")
                   for t in range(WHISPER_STEPS + 1))
        del full
        with ops.reference():
            plain = whisper_run(model, params, frames, prompt, WHISPER_STEPS,
                                forced=fed)[0]
        perr = [logits_close(logits[:, t], plain[:, t],
                             f"whisper decode step {t} vs the plain path")
                for t in range(WHISPER_STEPS + 1)]
        log(f"[whisper] whisper-medium full width ({E} + {L} layers, "
            f"{sum(p.numel() for p in params.parameters()):,} parameters): "
            f"prefill {WHISPER_B} x {WHISPER_PROMPT} over {F} frames in "
            f"{t_pre * 1e3:.3f} ms, {WHISPER_STEPS} greedy steps in "
            f"{t_dec:.4f} s ({WHISPER_B * WHISPER_STEPS / t_dec:.1f} "
            f"tokens/s, {t_dec / WHISPER_STEPS * 1e3:.3f} ms a step); peak "
            f"{peak:.3f} GiB; launches {serve}; a second run torch.equal; "
            f"every step against forward max abs {ferr:.4g}; teacher-forced "
            f"under ops.reference(): per-step max abs "
            f"{[round(e, 5) for e in perr[::8]]} (every 8th), max "
            f"{max(perr):.4g}; max |logit| "
            f"{float(logits.float().abs().max()):.4g}")
        con = dataclasses.replace(cfg, cast_weights_bf16=True)
        mon = build_model(con)
        cast = mon.cast_weights(params)
        n_cast = sum(p.dtype == torch.bfloat16 for p in cast.parameters())
        on = whisper_run(mon, cast, frames, prompt, WHISPER_STEPS)[0]
        check(torch.equal(on, logits), "whisper: lever-on logits != "
              "lever-off logits")
        log(f"[whisper] cast_weights_bf16 on: {n_cast} leaves cast once, "
            f"{weights_gb(params):.3f} -> {weights_gb(cast):.3f} GB; logits "
            f"over prefill and {WHISPER_STEPS} steps torch.equal to the "
            f"lever-off run")
        del cast, on, plain, again, logits
    del params
    torch.cuda.empty_cache()

    # training: batches of 4 x 448 tokens over 1500 frames
    ocfg = optim.OptConfig(lr=1e-3, warmup_steps=20,
                           total_steps=WHISPER_TRAIN_STEPS)
    tg = torch.Generator(device="cuda").manual_seed(2)
    batches = []
    for _ in range(WHISPER_TRAIN_STEPS):
        toks = torch.randint(0, cfg.vocab_size,
                             (WHISPER_B, WHISPER_TRAIN_S + 1), device="cuda",
                             generator=tg)
        batches.append({"enc_embeds": torch.randn(
            (WHISPER_B, F, cfg.d_model), device="cuda",
            generator=tg).to(torch.bfloat16),
            "tokens": toks[:, :-1], "labels": toks[:, 1:]})
    runs = []
    for r in range(2):
        st = step_mod.init_train_state(
            model, torch.Generator(device="cuda").manual_seed(0), "cuda")
        fn = step_mod.make_train_step(model, ocfg)
        torch.cuda.reset_peak_memory_stats()
        KB.reset_launches()
        recs, walls = [], []
        for b in batches:
            t0 = time.perf_counter()
            st, m = fn(st, b)
            torch.cuda.synchronize()
            walls.append(time.perf_counter() - t0)
            recs.append({k: float(v) for k, v in m.items()})
        runs.append((recs, walls, dict(KB.LAUNCHES),
                     torch.cuda.max_memory_allocated() / 2 ** 30))
        if r == 0:
            kept = [(n, p.detach().clone())
                    for n, p in st.params.named_parameters()]
            del st
            torch.cuda.empty_cache()
    (ra, wa, na, pa), (rb, _, _, _) = runs
    check(all(n == m and torch.equal(x, y) for (n, x), (m, y) in zip(
        kept, st.params.named_parameters(), strict=True)) and ra == rb,
        "two whisper train runs differ")
    check(all(math.isfinite(r["loss"]) for r in ra), "whisper losses")
    train = {k: v for k, v in na.items() if v}
    tw = {"flash_attention": 2 * (E + 2 * L) * WHISPER_TRAIN_STEPS,
          "flash_attention_bwd": (E + 2 * L) * WHISPER_TRAIN_STEPS}
    check(train == tw, f"whisper train launches {train}, expected {tw}")
    med = statistics.median(wa[1:])
    n_params = sum(p.numel() for p in st.params.parameters())
    log(f"[whisper] training through make_train_step, {WHISPER_TRAIN_STEPS} "
        f"steps of {WHISPER_B} x {WHISPER_TRAIN_S} tokens over {F} frames "
        f"({n_params:,} parameters, {16 * n_params / 1e9:.1f} GB of train "
        f"state): losses {[round(r['loss'], 5) for r in ra]}; steps "
        f"{[round(w * 1e3, 3) for w in wa]} ms, "
        f"{WHISPER_B * WHISPER_TRAIN_S / med:.1f} tokens/s after the first; "
        f"peak {pa:.3f} GiB; launches {train}; a second run torch.equal")
    del runs, st, kept
    torch.cuda.empty_cache()

    c32 = dataclasses.replace(cfg, compute_dtype="float32")
    m32 = build_model(c32)
    p32 = step_mod.trainable(m32.init(
        torch.Generator(device="cuda").manual_seed(0), device="cuda"))
    b32 = {**batches[0], "enc_embeds": batches[0]["enc_embeds"].float()}
    loss_k, g_k = loss_and_grads(m32, p32, b32)
    with ops.reference():
        loss_p, g_p = loss_and_grads(m32, p32, b32)
    worst = grads_close(g_k, g_p, 1e-4, "whisper float32 kernel vs plain",
                        zero_exact=key_bias_of)
    d32 = abs(float(loss_k) - float(loss_p)) / abs(float(loss_p))
    check(d32 <= 1e-5, f"whisper float32 loss {float(loss_k)} vs "
          f"{float(loss_p)}")
    log(f"[whisper] float32 compute (TF32 off), kernel against plain: loss "
        f"{float(loss_k):.7f} vs {float(loss_p):.7f} (rel {d32:.3g}); every "
        f"one of {len(g_p)} gradient leaves within 1e-4 of its largest "
        f"entry (worst {worst:.3g}; the key biases, whose exact gradient is "
        f"zero, within 1e-4 of their key weights'); phase 15 took "
        f"{time.perf_counter() - t_phase:.1f} s")
    del p32, g_k, g_p, batches
    torch.cuda.empty_cache()
    return {"serve": serve, "train": train}


def key_bias_of(name: str):
    """The key weights whose gradient scales a key bias's (``...bk``), whose
    exact gradient is zero: a bias on every key of a row shifts the row's
    scores by one constant, which the softmax drops."""
    return name[:-2] + "wk" if name.endswith(".bk") else None


# ---------------------------------------------------------------------------
# phase 16: the ops tier of the port's swarmlint on the card
# ---------------------------------------------------------------------------

# the ops tier records ~70 runs of the simulator at N = 13, each launching
# ~35k small kernels from the host (about a second a run on the card): on
# the critical path it would not fit the phase's 20 s, so both runs start
# in the background when phase 3 starts, on the cores that the
# single-threaded simulator phases leave idle, and phase 16 waits for them
# and checks what they found
OPS_TIER_TIMEOUT_S = 600.0


def start_ops_tier() -> dict:
    """``python -m repro_torch.analysis --tier ops`` without the baseline,
    on the card and on the CPU, as two background processes; each writes
    its findings (stdout, JSON) and its report (``--report``)."""
    out = ROOT / "build" / "ops_tier"
    out.mkdir(parents=True, exist_ok=True)
    env = dict(os.environ, PYTHONPATH=str(ROOT / "src"),
               OMP_NUM_THREADS="1")
    runs = {}
    for dev in ("cuda", "cpu"):
        report = out / f"report_{dev}.json"
        report.unlink(missing_ok=True)
        cmd = [sys.executable, "-m", "repro_torch.analysis", "--root",
               str(ROOT), "--tier", "ops", "--device", dev, "--no-baseline",
               "--format", "json", "--report", str(report)]
        runs[dev] = {"proc": subprocess.Popen(
            cmd, cwd=str(ROOT), env=env, stdout=subprocess.PIPE,
            stderr=subprocess.PIPE, text=True),
            "report": report, "t0": time.perf_counter()}
    atexit.register(stop_ops_tier, runs)
    return runs


def stop_ops_tier(runs: dict) -> None:
    for run in runs.values():
        if run["proc"].poll() is None:
            run["proc"].kill()
            run["proc"].wait()


def phase_ops_tier(runs: dict) -> dict:
    """The card's findings against the port's baseline and the CPU's, the
    φ kernels' launches in the recorded programs, the stand-in sweeps'
    fingerprints; returns the phase's JSON line."""
    from repro_torch.analysis.baseline import load_baseline
    t_phase = time.perf_counter()
    found, reports, walls = {}, {}, {}
    for dev, run in runs.items():
        proc = run["proc"]
        try:
            out, err = proc.communicate(
                timeout=max(1.0, OPS_TIER_TIMEOUT_S
                            - (time.perf_counter() - run["t0"])))
        except subprocess.TimeoutExpired:
            stop_ops_tier(runs)
            check(False, f"the ops tier on {dev} did not end in "
                  f"{OPS_TIER_TIMEOUT_S:g} s")
        walls[dev] = json.loads(run["report"].read_text())["total_s"] \
            if run["report"].exists() else None
        # exit 1: findings, as expected without the baseline
        check(proc.returncode in (0, 1) and walls[dev] is not None,
              f"the ops tier on {dev} failed ({proc.returncode}):\n"
              f"{err[-4000:]}")
        found[dev] = [(f["rule"], f["file"], f["symbol"])
                      for f in json.loads(out)["findings"]]
        reports[dev] = json.loads(run["report"].read_text())
    baseline = load_baseline(str(ROOT))
    left = sorted({t for t in found["cuda"] if t not in baseline.allows_})
    check(left == [], f"ops-tier findings on the card beyond the port's "
          f"baseline: {left}")
    for rule in ("J001", "J005"):
        card = sorted({t for t in found["cuda"] if t[0] == rule})
        cpu = sorted({t for t in found["cpu"] if t[0] == rule})
        check(card == cpu, f"{rule} on the card {card} != on the CPU {cpu}")
    card = reports["cuda"]
    check(card["device"].startswith("cuda"), f"recorded on {card['device']}")
    # 5 strategies x 5 epochs, one fused φ update an epoch
    for target, kernel in (("sim_dense", "phi_update"),
                           ("sim_sparse", "phi_update_sparse")):
        n = card["targets"][target]["kernels"].get(kernel, 0)
        check(n == 25, f"{target} recorded {n} {kernel} launches, "
              f"expected 25")
    sweeps = {t["sweep"]: t for t in card["sweeps"]}
    for name in ("j005_gamma", "j005_sparse_gamma"):
        groups = sweeps[name]["groups"]
        check(all(g["distinct_programs"] == 1 for g in groups),
              f"{name}: {[g['programs'] for g in groups]}")
    line = {"ops_tier": {
        "device": card["device"],
        "findings_raw": {r: sum(1 for t in found["cuda"] if t[0] == r)
                         for r in sorted({t[0] for t in found["cuda"]})},
        "j001_sites": sorted({f"{t[1]}::{t[2]}" for t in found["cuda"]
                              if t[0] == "J001"}),
        "targets": len(card["targets"]),
        "ops_recorded": sum(t["ops"] for t in card["targets"].values()),
        "kernel_events": {k: sum(t["kernels"].get(k, 0)
                                 for t in card["targets"].values())
                          for k in sorted({k for t in card["targets"].values()
                                           for k in t["kernels"]})},
        "sweep_programs": {n: t["distinct_programs"]
                           for n, t in sweeps.items()},
        "cuda_s": walls["cuda"], "cpu_s": walls["cpu"],
        "phase_s": time.perf_counter() - t_phase}}
    log(f"[ops] the ops tier on the card ({walls['cuda']:.1f} s in the "
        f"background) and on the CPU ({walls['cpu']:.1f} s): no finding "
        f"beyond the baseline, J001 and J005 as on the CPU "
        f"({line['ops_tier']['j001_sites']}), the φ kernels in the "
        f"recorded programs, one program per gamma group")
    return line


# ---------------------------------------------------------------------------
# phase 13: the serving stack's host paths
# ---------------------------------------------------------------------------

KNEE_MULT = 1.1            # the slo_serve knee point held to the artifact
KNEE_MAX_RECORDS = 100_000  # benchmarks/loadtest.py's --max-records default


def phase_host_paths(get_config, planner, obs, loadgen, slo, prom, hist
                     ) -> None:
    """The stage planner's seed and refined plans; one knee point of the
    artifact's ``slo_serve`` section through the synthetic engine, its
    counts and quantiles against the artifact's; its registry rendered to
    Prometheus text and parsed back; and a histogram fill on the card
    against the host fill."""
    F = np.maximum(np.random.default_rng(0).normal(400, 100, 4), 50.0)
    for arch in ("granite-moe-1b-a400m", "qwen3-1.7b", "recurrentgemma-9b"):
        cfg = get_config(arch)
        seed, sc, plan, pc = planner.plan_and_refine(cfg, F)
        legal = set(planner.split_points(cfg)) | {0, cfg.num_layers}
        check(set(plan.boundaries) <= legal and set(seed.boundaries)
              <= legal, f"{arch}: a plan cuts at an illegal split point")
        check(pc.throughput_rps >= sc.throughput_rps,
              f"{arch}: the refinement lowered the throughput")
        log(f"[planner] {arch} on F {np.round(F, 1).tolist()}: φ seed "
            f"{seed.boundaries} on executors {seed.executors}, "
            f"{sc.throughput_rps:.4f} req/s, latency {sc.latency_s:.4f} s; "
            f"refined {plan.boundaries}, {pc.throughput_rps:.4f} req/s, "
            f"latency {pc.latency_s:.4f} s")

    art = json.loads(ARTIFACT.read_text())["slo_serve"]
    meta = art["meta"]
    want = art["processes"]["poisson"]["points"][f"x{KNEE_MULT:g}"]
    dt, mb = meta["dt_s"], meta["max_batch_rows"]
    rate = KNEE_MULT * mb / dt
    horizon = meta["requests_per_point"] / rate
    # benchmarks/loadtest.py's rules: the seed of a point, the stride of the
    # flight recorder
    seed = meta["seed"] + int(round(1000 * KNEE_MULT))
    t0 = time.perf_counter()
    times = loadgen.poisson_arrivals(rate, horizon, seed=seed)
    eng = loadgen.SyntheticServeEngine(
        n_stages=meta["stages"], max_queue=meta["max_queue"],
        state_every=max(1, max(int(horizon / dt), 1) // 2048),
        max_records=KNEE_MAX_RECORDS)
    st = loadgen.run_open_loop(eng, times, dt=dt, max_batch=mb)
    point = slo.slo_indices(st, horizon_s=float(eng.clock),
                            offered_rows=int(times.size), rate_rps=rate,
                            max_queue=meta["max_queue"])
    wall = time.perf_counter() - t0
    keys = ("offered_rows", "completed", "dropped", "exit_counts")
    for key in keys:
        check(point[key] == want[key],
              f"knee x{KNEE_MULT}: {key} {point[key]} against the "
              f"artifact's {want[key]}")
    for q in ("p50", "p99", "p999"):
        check(point["latency_s"][q] == want["latency_s"][q],
              f"knee x{KNEE_MULT}: {q} {point['latency_s'][q]} against "
              f"{want['latency_s'][q]}")
    log(f"[slo] poisson x{KNEE_MULT} ({meta['requests_per_point']} rows, "
        f"{meta['stages']} stages, max_queue {meta['max_queue']}, dt {dt}, "
        f"max_batch {mb}, seed {seed}): "
        f"{ {k: point[k] for k in keys} }, latency "
        f"{ {q: point['latency_s'][q] for q in ('p50', 'p99', 'p999')} }, "
        f"goodput {point['goodput_rps']:.1f} rows/s; equal to the "
        f"artifact's; {wall:.2f} s on the host")
    reg = slo.fill_registry(obs.Registry(), st, process="poisson")
    text = prom.render(reg)
    parsed = prom.parse(text)
    counts = [v for name, _, v in parsed["samples"]
              if name == "repro_slo_poisson_latency_seconds_count"]
    check(counts == [float(st.completed)], "Prometheus round trip")
    log(f"[slo] the point's registry rendered to {len(text)} bytes of "
        f"Prometheus text and parsed back strictly: {len(parsed['types'])} "
        f"families, {len(parsed['samples'])} samples")

    spec = hist.DEFAULT_LATENCY_HIST
    vals = np.random.default_rng(0).lognormal(-2.0, 2.0, 1_000_000)
    on_card = hist.fill(spec, hist.empty(spec), torch.from_numpy(vals)
                        .cuda())
    check(np.array_equal(on_card.cpu().numpy(),
                         hist.fill_np(spec, hist.empty_np(spec), vals)),
          "hist.fill on the card differs from fill_np")
    log("[slo] hist.fill of 1,000,000 values on the card equals fill_np")


def main() -> int:
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device; nothing was run", file=sys.stderr)
        return 2
    from repro_torch import rng
    from repro_torch import fleet, trace
    from repro_torch.configs import SwarmConfig, get_config
    from repro_torch.core import diffusive
    from repro_torch.kernels import build as KB
    from repro_torch.kernels import decode_attention as DA
    from repro_torch.kernels import diffusive_phi as K
    from repro_torch.kernels import flash_attention as FA
    from repro_torch.kernels import flash_attention_bwd as FB
    from repro_torch.kernels import mamba_scan as MB
    from repro_torch.kernels import mamba_scan_bwd as MBB
    from repro_torch.kernels import ops, ref
    from repro_torch.kernels import rglru_scan as RG
    from repro_torch.kernels import rglru_scan_bwd as RB
    from repro_torch.kernels import rmsnorm as RN
    from repro_torch.kernels import rmsnorm_bwd as NB
    from repro_torch import checkpoint, data, optim
    from repro_torch.launch import dist
    from repro_torch.launch import mesh as mesh_mod
    from repro_torch.launch import train as train_mod
    from repro_torch import obs
    from repro_torch.launch import step
    from repro_torch.launch.serve import serve
    from repro_torch.models import build_model, hybrid, moe, ssm_lm
    from repro_torch.models import transformer as tf
    from repro_torch.models.transformer import head_out
    from repro_torch.obs import hist, loadgen, prom, slo
    from repro_torch.splitcompute import planner
    from repro_torch.swarm import simulator as S
    from repro_torch.trace import schema

    smi = nvidia_smi()
    log(f"[device] {smi}; {torch.cuda.get_device_name(0)}; torch "
        f"{torch.__version__} CUDA {torch.version.cuda}; python "
        f"{sys.version.split()[0]}")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    t0 = time.perf_counter()
    all_libs = (K.LIB, FA.LIB, DA.LIB, RN.LIB, RG.LIB, MB.LIB, FB.LIB,
                NB.LIB, RB.LIB, MBB.LIB)
    libs = KB.build_all(all_libs)
    log(f"[build] {[str(p.relative_to(ROOT)) for p in libs]} in "
        f"{time.perf_counter() - t0:.2f} s, one nvcc per source")
    for lib in all_libs:
        table = ptxas_table(lib.report())
        regs = sorted({r for r, _, _ in table.values()})
        spills = [f"{name}: {st} bytes spill stores, {ld} bytes spill loads"
                  for name, (_, st, ld) in table.items() if st or ld]
        log(f"[build] {lib.source.name}: ptxas registers per thread {regs}; "
            f"spills: {spills or 'none'}")

    gen = torch.Generator(device="cuda").manual_seed(0)
    t_run = time.perf_counter()
    marks = [("build", t_run)]

    def mark(name):
        marks.append((name, time.perf_counter()))
        log(f"[time] phase {name} ended {marks[-1][1] - t_run:.1f} s into "
            f"the run ({marks[-1][1] - marks[-2][1]:.1f} s)")

    err = phase_kernels(K, ref, ops, diffusive, gen)
    timing = phase_timing(K, ref, ops, gen)
    mark("2")
    ops_runs = start_ops_tier()       # phase 16, in the background
    main_launches = phase_main_path(S, rng, ops, K, SwarmConfig)
    mark("3")
    sparse_launches = phase_sparse(S, rng, ops, K, SwarmConfig)
    mark("4")
    fleet_launches = phase_fleet(fleet, SwarmConfig, S, K)
    mark("4b")
    trace_launches = phase_telemetry(S, rng, ops, K, fleet, trace,
                                     SwarmConfig)
    mark("4c")
    err.update(phase_attention(FA, DA, ref, gen))
    timing.update(phase_attention_timing(FA, DA, ref, gen))
    err["decode_attention_partial"], timing["decode_attention_partial"] = \
        phase_partial(DA, ref, gen)
    mark("5")

    cfg = get_config("qwen3-1.7b")
    t0 = time.perf_counter()
    params = build_model(cfg).init(torch.Generator(device="cuda")
                                   .manual_seed(0))
    torch.cuda.synchronize()
    log(f"[serve] {cfg.name}: {sum(p.numel() for p in params.parameters())} "
        f"parameters ({cfg.param_dtype}, compute {cfg.compute_dtype}) "
        f"initialised on the card in {time.perf_counter() - t0:.2f} s")
    serve_launches = phase_serve(cfg, params, serve, schema, ops, KB)
    decode_launches, off = phase_decode(cfg, params, build_model, ops, KB,
                                        gen)
    model_on = build_model(dataclasses.replace(cfg, cast_weights_bf16=True))
    params = model_on.cast_weights(params)     # replaces the f32 tree
    torch.cuda.empty_cache()
    with torch.inference_mode():
        lever_launches = lever_on(
            "decode", model_on,
            lambda p, prompt, n: decode_run(model_on, p, prompt, n),
            params, KB, off, equal=True)
    del params, off
    torch.cuda.empty_cache()
    mark("6-7")

    err.update(phase_scans(RN, RG, MB, ref, gen))
    timing.update(phase_scan_timing(RN, RG, MB, ref, gen))
    mark("8")

    def mamba_layer(cfg, params, i, h, positions):
        return ssm_lm.run_layers(params.layers[i:i + 1], cfg, h,
                                 mode="train")[0]

    def hybrid_layer(cfg, params, i, h, positions):
        return hybrid.run_layers(params.layers[i:i + 1], cfg, h, positions,
                                 mode="train", start=i)[0]

    mamba_launches, mamba_on = phase_recurrent(
        "falcon-mamba-7b", mamba_expect, mamba_layer, get_config,
        build_model, step, ops, KB, gen, head_out)
    mark("9")
    hybrid_launches, hybrid_on = phase_recurrent(
        "recurrentgemma-9b", hybrid_expect, hybrid_layer, get_config,
        build_model, step, ops, KB, gen, head_out)
    mark("10")
    moe_serve, moe_launches, moe_on = phase_zoo(
        "granite-moe-1b-a400m", get_config, build_model, serve, schema, tf,
        moe, ops, KB, gen)
    mark("11")
    _, vlm_launches, vlm_on = phase_zoo(
        "qwen2-vl-2b", get_config, build_model, serve, schema, tf, moe, ops,
        KB, gen)
    mark("12")
    phase_host_paths(get_config, planner, obs, loadgen, slo, prom, hist)
    mark("13")
    check_bwd_spills(FB, NB, get_config)
    err.update(phase_backward_kernels(FB, NB, ref, gen))
    timing.update(phase_backward_timing(FB, NB, ref, gen))
    phase_whisper_bwd_timing(FB, ref, gen)
    trained = phase_training(get_config, build_model, train_mod, step, data,
                             optim, tf, ops, KB)
    mark("14")
    check_scan_bwd_spills(RB, MBB, MB)
    err.update(phase_scan_bwd_kernels(RB, MBB, MB, ref, gen))
    timing.update(phase_scan_bwd_timing(RB, MBB, MB, ref, gen))
    for name, e in phase_tp_local(FA, FB, RN, NB, ref, gen).items():
        err[name] = max(err[name], e)
    for name, e in phase_tp_scans(RG, MB, RB, MBB, ref, gen).items():
        err[name] = max(err[name], e)
    mark("14b")
    scan_trained = phase_scan_training(get_config, build_model, train_mod,
                                       step, data, KB, ops)
    mark("14c")
    mesh_launches = phase_mesh(get_config, build_model, step, data, optim,
                               checkpoint, dist, mesh_mod, KB, smi)
    mesh_serve, mesh_train = phase_mesh_serving(
        get_config, build_model, step, optim, dist, mesh_mod, KB, gen)
    mark("14d")
    split_launches = phase_split_decode(get_config, build_model, gen)
    mark("14e")
    whisper = phase_whisper(get_config, build_model, step, optim, ops, KB,
                            gen)
    mark("15")
    ops_line = phase_ops_tier(ops_runs)
    mark("16")
    serving = (serve_launches, decode_launches, lever_launches,
               mamba_launches, mamba_on, hybrid_launches, hybrid_on,
               moe_serve, moe_launches, moe_on, vlm_launches, vlm_on,
               whisper["serve"], mesh_serve, split_launches)
    trainings = (trained["launches"], scan_trained, whisper["train"],
                 mesh_launches, mesh_train)

    def on_serving_paths(name):
        return sum(ln.get(name, 0) for ln in serving)

    def on_training_paths(name):
        return sum(ln.get(name, 0) for ln in trainings)

    kernels = []
    for name, source, line, launches in (
            ("phi_update", "diffusive_phi", "diffusive_phi.py:62",
             main_launches["phi_update"] + fleet_launches["phi_update"]
             + trace_launches["phi_update"]),
            ("diffusive_phi", "diffusive_phi", "diffusive_phi.py:62",
             main_launches["diffusive_phi"]),
            ("diffusive_phi_sparse", "diffusive_phi", "diffusive_phi.py:121",
             sparse_launches["diffusive_phi_sparse"]),
            ("phi_update_sparse", "diffusive_phi", "diffusive_phi.py:121",
             sparse_launches["phi_update_sparse"]
             + trace_launches["phi_update_sparse"]),
            ("flash_attention", "flash_attention", "flash_attention.py:77",
             on_serving_paths("flash_attention")
             + on_training_paths("flash_attention")),
            ("decode_attention", "decode_attention",
             "decode_attention.py:65", on_serving_paths("decode_attention")),
            # the distributed flash-decode's entry point of the same kernel
            ("decode_attention_partial", "decode_attention",
             "decode_attention.py:65",
             on_serving_paths("decode_attention_partial")),
            ("rmsnorm", "rmsnorm", "rmsnorm.py:24",
             on_serving_paths("rmsnorm") + on_training_paths("rmsnorm")),
            # no TPU kernel: JAX differentiates the plain path (ref.py)
            ("flash_attention_bwd", "flash_attention_bwd", "ref.py:56",
             on_training_paths("flash_attention_bwd")),
            ("rmsnorm_bwd", "rmsnorm_bwd", "ref.py:148",
             on_training_paths("rmsnorm_bwd")),
            ("rglru_scan", "rglru_scan", "rglru_scan.py:47",
             on_serving_paths("rglru_scan") + on_training_paths("rglru_scan")),
            ("mamba_scan", "mamba_scan", "mamba_scan.py:49",
             on_serving_paths("mamba_scan") + on_training_paths("mamba_scan")),
            ("rglru_scan_bwd", "rglru_scan_bwd", "ref.py:105",
             on_training_paths("rglru_scan_bwd")),
            ("mamba_scan_bwd", "mamba_scan_bwd", "ref.py:125",
             on_training_paths("mamba_scan_bwd"))):
        kernels.append({
            "name": name, "route": "cuda",
            "source": f"src/repro_torch/kernels/csrc/{source}.cu",
            "replaces": f"src/repro/kernels/{line}",
            "launches": launches, "max_abs_err": err[name],
            **{k: v for k, v in timing[name].items()
               if k not in ("call_ms", "launches_per_call")}})
    check(all(math.isfinite(k["ms"]) for k in kernels), "kernel timing")
    check(all(k["launches"] > 0 for k in kernels if k["name"] not in (
        "diffusive_phi", "diffusive_phi_sparse")) and len(kernels) == 14,
        f"launches on the main paths: "
        f"{ {k['name']: k['launches'] for k in kernels} }")
    log(f"[time] the run after the build took "
        f"{time.perf_counter() - t_run:.1f} s")
    print(json.dumps(ops_line))
    print(json.dumps({"kernels": kernels}))
    print(smi)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
