"""The MoE block's training path on the card:
``python3 tools/profile_moe.py [--block] [--cell] [--steps N] [--src DIR]``.

``--block``: granite-moe-1b-a400m's MoE block at its training shape (T
8,192 tokens, d 1,024, 32 experts top-8, capacity 2,560, bfloat16, a
shared shift of the tokens that drops about 40 % of the assignments), on
one shard and on shard 1 of two: one forward and backward of
``models.moe._moe_shard`` through the kernel route and through
``kernels.ops.reference()`` (autograd of the plain indexing), their
gradients ``torch.equal``, two backward passes equal (``--save FILE``
keeps the gradients, for a comparison of two trees); each timed (CUDA
events, the median of 20 after 3 warm-up passes, the two routes in turns);
then one backward under ``torch.profiler``, its device kernels listed by
time, and one forward and backward traced on the host, its synchronising
runtime calls listed by the ops they ran under.  ``--cell``: the ``train.granite-moe-1b-a400m.seq4k`` cell's state
and step (``bench/harness``, the cell's seed-drawn weights and batches),
3 warm steps, then ``--steps`` steps with the program's spans on, read by
``bench/harness/spans.py``: the cell's span readings, and the median card
ms a step or a layer of ``train.step``, ``moe.*`` and their ``.bwd``;
then one step traced on the host and the card: the host's ops by self
time, its synchronising calls by the ops they ran under, and its CUDA
runtime calls.
Without either flag, both.  ``--src DIR``: another checkout's ``src``
(its kernels built into that checkout's ``build/``), so that two trees can
be read in turns in one call.

Needs a CUDA card.
"""
from __future__ import annotations

import argparse
import statistics
import sys
from pathlib import Path

import torch

ROOT = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT))

import chip_smoke as cs  # noqa: E402

CELL = "train.granite-moe-1b-a400m.seq4k"


def waits(prof) -> dict:
    """The synchronising runtime calls and copies of a host trace, counted
    by the ops they ran under."""
    out = {}
    for e in prof.events():
        if e.name in ("cudaStreamSynchronize", "cudaDeviceSynchronize",
                      "cudaMemcpyAsync", "cudaMemcpy"):
            chain, up = [], e.cpu_parent
            while up is not None and len(chain) < 4:
                chain.append(up.name)
                up = up.cpu_parent
            key = f"{e.name} under {' < '.join(chain)}"
            out[key] = out.get(key, 0) + 1
    return out


def block(T: int, shift: float, reps: int, save=None) -> None:
    from repro_torch.kernels import build as KB
    from repro_torch.kernels import ops
    from repro_torch.models import moe

    gen = torch.Generator(device="cuda").manual_seed(0)
    kept = {}
    for shard_id, n_shards in ((0, 1), (1, 2)):
        cfg, args = cs.moe_train_inputs(T, shift, gen, n_shards, shard_id)
        leaves = [t.clone().requires_grad_() for t in args]
        dy = torch.randn(args[0].shape, device="cuda", generator=gen
                         ).to(args[0].dtype)
        what = f"T {T} shard {shard_id} of {n_shards}"

        def run():
            y, aux, dropped = moe._moe_shard(*leaves, cfg, shard_id=shard_id,
                                             n_shards=n_shards)
            return torch.autograd.grad((y, aux), leaves,
                                       (dy, torch.ones_like(aux))), dropped

        def run_library():
            with ops.reference():
                return run()

        (got, dropped), (again, _) = run(), run()
        want, _ = run_library()
        names = ("x", "router", "w_gate", "w_up", "w_down")
        for n, g, a, w in zip(names, got, again, want, strict=True):
            cs.check(torch.equal(g, w), f"{what}: d{n} of the kernel route "
                     f"differs from the library's")
            cs.check(torch.equal(g, a), f"{what}: two backward passes give "
                     f"other d{n}")
        cs.log(f"[moe block] {what}: drops {float(dropped):.4f}; the five "
               f"gradients torch.equal to the library's, twice")
        kept[what] = [g.cpu() for g in got]
        times = {"kernel": [], "library": []}
        for _ in range(3):
            run(), run_library()
        for _ in range(reps):
            for name, fn in (("kernel", run), ("library", run_library)):
                a, b = (torch.cuda.Event(enable_timing=True),
                        torch.cuda.Event(enable_timing=True))
                a.record()
                fn()
                b.record()
                torch.cuda.synchronize()
                times[name].append(a.elapsed_time(b))
        cs.log(f"[moe block] {what}: forward + backward, median of {reps}: "
               f"kernel route {statistics.median(times['kernel']):.4f} ms, "
               f"library {statistics.median(times['library']):.4f} ms")
        y, aux, _ = moe._moe_shard(*leaves, cfg, shard_id=shard_id,
                                   n_shards=n_shards)
        torch.cuda.synchronize()
        KB.reset_launches()
        with torch.profiler.profile(
                activities=[torch.profiler.ProfilerActivity.CUDA]) as prof:
            torch.autograd.grad((y, aux), leaves, (dy, torch.ones_like(aux)))
            torch.cuda.synchronize()
        kern = {}
        for e in prof.events():
            if e.device_type == torch.autograd.DeviceType.CUDA:
                kern[e.name] = kern.get(e.name, 0.0) + e.device_time_total
        cs.log(f"[moe block] {what}: backward launches "
               f"{ {k: v for k, v in KB.LAUNCHES.items() if v} }; device "
               f"kernels by time (ms): " + "; ".join(
                   f"{n[:90]} {t / 1e3:.4f}" for n, t in sorted(
                       kern.items(), key=lambda kv: -kv[1])[:14]))
        # the host's waits in one forward and backward: each synchronising
        # runtime call by the ops it ran under
        acts = [torch.profiler.ProfilerActivity.CPU,
                torch.profiler.ProfilerActivity.CUDA]
        torch.cuda.synchronize()
        with torch.profiler.profile(activities=acts) as prof:
            run()
        cs.log(f"[moe block] {what}: the host's waits in one forward and "
               f"backward: {waits(prof)}")
        del leaves, got, again, want, y, aux
        torch.cuda.empty_cache()
    if save is not None:
        torch.save(kept, save)


def cell(steps: int, seed: int) -> None:
    sys.path.insert(0, str(ROOT / "bench"))
    from harness import program
    from harness import spans as hspans
    from harness.common import find_cell
    from harness.weights import draw_weights, train_tokens

    c = find_cell(CELL)
    model = c.model
    B, S, V = model["train"]["batch"], model["train"]["seq"], \
        model["vocab_size"]
    cfg = program.port_config(model)
    device = torch.device("cuda", 0)
    state = program.train_state(cfg, draw_weights(model, seed, device))
    step = program.train_step(cfg, c.mix)

    def feed(j):
        tokens, labels = train_tokens(seed, j, B, S, V, device)
        return {"tokens": tokens, "labels": labels}

    for j in range(1, 4):
        state, _ = step(state, feed(j))
    torch.cuda.synchronize()
    if not hspans.spans_on():
        cs.log("[moe cell] the program has no spans")
        return
    for j in range(4, 4 + steps):
        state, _ = step(state, feed(j))
    got = hspans.collect_spans()
    ctx = {"spans": got["spans"], "counters": got["counters"]}
    read = hspans.readings(ctx, CELL)
    cs.log(f"[moe cell] {CELL}, {steps} steps, seed {seed}: " + ", ".join(
        f"{k} {v:.4f}" if v is not None else f"{k} none"
        for k, v in read.items()))
    by = {}
    for s in got["spans"]:
        if s["card"]:
            by.setdefault(s["name"], []).append(s["card"][1] - s["card"][0])
    cs.log("[moe cell] card ms, median a call (calls): " + "; ".join(
        f"{n} {1e3 * statistics.median(v):.4f} ({len(v)})"
        for n, v in sorted(by.items()) if n.startswith(
            ("train.step", "moe.", "optim.", "lm."))))
    # one step traced on the host and the card: where the host's time goes
    acts = [torch.profiler.ProfilerActivity.CPU,
            torch.profiler.ProfilerActivity.CUDA]
    torch.cuda.synchronize()
    with torch.profiler.profile(activities=acts) as prof:
        state, _ = step(state, feed(4 + steps))
        torch.cuda.synchronize()
    avg = prof.key_averages()
    top = sorted(avg, key=lambda e: -e.self_cpu_time_total)[:16]
    cs.log("[moe cell] one step's host ops by self time (ms, calls): "
           + "; ".join(f"{e.key} {e.self_cpu_time_total / 1e3:.2f} "
                       f"({e.count})" for e in top))
    cs.log(f"[moe cell] one step's waits: {waits(prof)}")
    rt = [e for e in avg if e.key.startswith("cuda")]
    cs.log("[moe cell] CUDA runtime calls (ms, calls): " + "; ".join(
        f"{e.key} {e.self_cpu_time_total / 1e3:.2f} ({e.count})"
        for e in sorted(rt, key=lambda e: -e.self_cpu_time_total)[:10]))


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--block", action="store_true")
    ap.add_argument("--cell", action="store_true")
    ap.add_argument("--steps", type=int, default=8)
    ap.add_argument("--seed", type=int, default=3000000019)
    ap.add_argument("--reps", type=int, default=20)
    ap.add_argument("--src", type=Path, default=ROOT / "src")
    ap.add_argument("--save", type=Path, default=None,
                    help="--block: save the gradients here (torch.save)")
    args = ap.parse_args()
    if not torch.cuda.is_available():
        print("profile_moe: no CUDA device; nothing was run", file=sys.stderr)
        return 2
    sys.path.insert(0, str(args.src.resolve()))
    import repro_torch
    cs.log(f"[device] {cs.nvidia_smi()}; torch {torch.__version__}; "
           f"repro_torch of {Path(repro_torch.__file__).parent}")
    both = not (args.block or args.cell)
    if args.block or both:
        block(8192, cs.MOE_TRAIN_SHIFT, args.reps, args.save)
    if args.cell or both:
        cell(args.steps, args.seed)
    cs.log(cs.nvidia_smi())
    return 0


if __name__ == "__main__":
    sys.exit(main())
