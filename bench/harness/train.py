"""The training driver (mixes with ``"driver": "train"``).

Set-up draws the weights from the seed, builds the program's train state
on them and its step (``launch.step.make_train_step``), and runs the mix's
``checked_steps`` steps through that same step and feed: they warm every
shape, and the comparison reads the first ``ref_steps`` of them (each
step's loss; the first step's gradient, as the optimizer got it, from its
first moment ``m = (1 - b1) g``; the parameters' change after the last
of them, against the initial weights drawn again).  The window then steps the same state back to back
until the first step that ends after ``--seconds``.  A traced run adds
``trace_steps`` steps under the profiler after the window.  Once the
program's state is freed, the reference follows those steps from the
same weights and batches."""
from __future__ import annotations

import gc
import statistics
import sys
import time
from typing import Callable, Dict, List, Optional

import torch

from harness import flops, program, trace as tracing
from harness.common import Cell, Outcome, compare
from harness.weights import (draw_leaf, draw_weights, leaf_specs,
                             train_tokens)
from reference import decoder as ref


def _sync(device) -> None:
    if torch.device(device).type == "cuda":
        torch.cuda.synchronize()


def initial_norm_diffs(model: Dict, seed: int, params: Dict, device
                       ) -> Dict[str, float]:
    """||p - p0|| by the program's leaf names, p0 drawn again leaf by
    leaf."""
    out = {}
    for name, shape, std in leaf_specs(model):
        p0 = draw_leaf(seed, name, shape, std, device)
        if name.startswith("layers."):
            _, sub, leaf = name.split(".")
            for i in range(shape[0]):
                n = f"layers.{i}.{sub}.{leaf}"
                out[n] = float((params[n].detach() - p0[i]).norm())
        else:
            out[name] = float((params[name].detach() - p0).norm())
        del p0
    return out


def _rel(prog: Dict, refr: Dict, names) -> Dict[str, float]:
    """|prog - ref| / max(ref, the median leaf's ref) by leaf."""
    med = statistics.median(refr[n] for n in names)
    return {n: abs(prog[n] - refr[n]) / max(refr[n], med) for n in names}


def gaps(prog: Dict, refr: Dict) -> Dict[str, tuple]:
    """The numbers compared, each with where it was read (the step or the
    leaf): the widest loss gap over the checked steps; the worst leaf's gap
    of first-gradient norms and of change norms, each against the
    reference's norm of that leaf or of the median leaf, whichever is
    larger, and the median leaf's of each.  A leaf whose reference gradient
    is under a thousandth of the median leaf's moves by round-off alone and
    is left out of the change."""
    loss = max((abs(a - b), f"step {j}") for j, (a, b) in enumerate(
        zip(prog["losses"], refr["losses"]), start=1))
    gr = refr["grad_norms"]
    grad = _rel(prog["grad_norms"], gr, list(gr))
    med_g = statistics.median(gr.values())
    moved = [n for n, g in gr.items() if g >= 1e-3 * med_g]
    change = _rel(prog["change"], refr["change"], moved)
    return {"loss_gap": loss,
            "grad_gap": max((v, n) for n, v in grad.items()),
            "change_gap": max((v, n) for n, v in change.items()),
            "grad_median_gap": (statistics.median(grad.values()), "median"),
            "change_median_gap": (statistics.median(change.values()),
                                  "median")}


def run(cell: Cell, seed: int, seconds: float, trace: bool, device,
        t_start: float, fault: Optional[Callable] = None,
        model: Optional[Dict] = None) -> Outcome:
    """``fault`` wraps the program's step (the harness's own tests plant
    faults with it); ``model`` stands in for the cell's configuration."""
    model = model or cell.model
    mix = cell.mix
    B, S = model["train"]["batch"], model["train"]["seq"]
    V = model["vocab_size"]
    cfg = program.port_config(model)
    state = program.train_state(cfg, draw_weights(model, seed, device))
    step = program.train_step(cfg, mix)
    if fault is not None:
        step = fault(step)

    def feed(j: int) -> Dict[str, torch.Tensor]:
        tokens, labels = train_tokens(seed, j, B, S, V, device)
        return {"tokens": tokens, "labels": labels}

    b1 = mix["optimizer"]["beta1"]
    prog = {"losses": []}
    n_checked = mix["checked_steps"]
    n_ref = ref_steps(cell)
    for j in range(1, n_checked + 1):
        state, met = step(state, feed(j))
        if j <= n_ref:
            prog["losses"].append(float(met["loss"]))
        if j == 1:
            prog["grad_norms"] = {
                n: float(m.norm()) / (1 - b1)
                for n, m in program.first_moment(state).items()}
        if j == n_ref:
            prog["change"] = initial_norm_diffs(
                model, seed, program.named_params(state), device)
    if trace:
        tracing.warm_profiler()
    _sync(device)
    setup_s = time.perf_counter() - t_start

    losses: List[torch.Tensor] = []
    j = n_checked
    t0 = time.perf_counter()
    while True:
        j += 1
        state, met = step(state, feed(j))
        losses.append(met["loss"])
        _sync(device)
        window_s = time.perf_counter() - t0
        if window_s >= seconds:
            break
    steps = len(losses)
    failed = sum(1 for x in losses if not torch.isfinite(x).item())

    ctx = {"kind": "train", "window_s": window_s,
           "model_flops": steps * flops.train_step_flops(model, B, S)}
    out_extra, breakdown = {}, None
    if trace:
        with program.FlashShapes() as shapes, tracing.Window() as w:
            for _ in range(mix["trace_steps"]):
                j += 1
                state, _ = step(state, feed(j))
        with tracing.Window(host=True) as wh:
            j += 1
            state, _ = step(state, feed(j))
        ctx.update(trace=w, flash_calls=shapes.calls)
        out_extra = {"busy_s": w.busy_s, "window_s": w.window_s}
        breakdown = tracing.breakdown(w, wh)
    peak = torch.cuda.max_memory_allocated() \
        if torch.device(device).type == "cuda" else 0

    del state, step, met, losses
    gc.collect()
    if torch.device(device).type == "cuda":
        torch.cuda.empty_cache()
    t_ref = time.perf_counter()
    refr = reference(model, mix, seed, device, ref.FP32, feed, n_ref)
    print(f"reference: {n_ref} steps in {time.perf_counter() - t_ref:.1f} s",
          file=sys.stderr)
    read = {}
    for k, (v, where) in gaps(prog, refr).items():
        read[k] = v
        print(f"{k} read at {where}", file=sys.stderr)
    out = Outcome(attempted=steps, failed=failed,
                  end_to_end={"train_tokens_per_s": steps * B * S / window_s,
                              "setup_s": setup_s},
                  ctx=ctx, compared=compare(read, cell.limits),
                  readings=read,
                  device_extra=out_extra, breakdown=breakdown,
                  memory_peak_bytes=peak)
    return out


def ref_steps(cell: Cell) -> int:
    """How many of the checked steps the reference follows: the mix's
    ``checked_steps``, or fewer where the cell's limits file says so (a
    reference that would outlast the window follows two of three)."""
    return int(cell.check.get("reference_steps", cell.mix["checked_steps"]))


def reference(model: Dict, mix: Dict, seed: int, device, nm, feed,
              steps: int, batch_rows: Optional[int] = None) -> Dict:
    """The reference through the first ``steps`` checked steps
    (``batch_rows``: only the first rows of each batch, the half-batch
    fault)."""
    if torch.device(device).type == "cuda":
        ref.plain_mode()
    specs = {n: (s, std) for n, s, std in leaf_specs(model)}
    tree = draw_weights(model, seed, device)
    batches = []
    for j in range(1, steps + 1):
        b = feed(j)
        rows = slice(0, batch_rows)
        batches.append((b["tokens"][rows], b["labels"][rows]))
    return ref.train_steps(
        tree, model, batches, mix["optimizer"], nm,
        initial=lambda n: draw_leaf(seed, n, *specs[n], device))
