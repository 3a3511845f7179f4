"""The split-serving driver (mixes with ``"driver": "split"``).

Set-up draws the weights from the seed, plans the stages over the mix's
executors (``plan_stages``, the φ rule) and builds the program's
``SplitServeEngine`` on them; a second engine on the same weights serves
one request of every length bucket to warm each shape.  The arrival
times and lengths come from the seed (``arrivals``), and so does each
request's [B, S] prompt.

The window drives the engine's ``submit`` and ``step`` with the wall clock
from its start: each request is submitted once it is due, stamped with its
due time; the engine steps whenever a queue holds work (``dt`` from the
mix).  The host waits for the card only where a step returns completions,
on a CUDA event recorded after it, which marks their logits being ready
(a server hands an answer out once it is ready); a step that completes
nothing overlaps with the next one's host work.  Events around each step
give its span on the card; all are read once the drive has ended, against
an event recorded at its start on an idle card.  A mix with ``drain``
serves every request due in the window to its end after the window
closes; one without stops at the close.  A traced run then serves
``trace_seconds`` more of the same process (fresh arrivals) under the
profiler.

Correctness: a sample drawn from the seed among the requests due in the
first ``sample.from_first`` of the window, with the longest of them,
keeps the token the program puts first at every position (its served
tokens); a sampled request that the window left unfinished is served to
its end after the close (up to a minute, outside every metric); once the
window has closed and the engine is freed, the
reference runs each finished sample at the depth it was served at, and
the number compared is the widest gap by which a served token's logit
lies below the reference's best."""
from __future__ import annotations

import gc
import sys
import time
from typing import Callable, Dict, List, Optional

import numpy as np
import torch

from harness import arrivals as arr
from harness import flops, program, readers, trace as tracing
from harness.common import Cell, Outcome, compare
from harness.weights import draw_weights, request_tokens
from reference import decoder as ref


def schedule(mix: Dict, knee_hz: float, seconds: float, stream: str):
    """(due times, lengths) of the requests due in [0, seconds): the same for
    every run, drawn from the mix's ``schedule_seed`` (a run's seed draws its
    prompts and weights, not the schedule: the order of a schedule alone
    moves the tail by more than any bound can hold, PERF.md §2)."""
    seed = mix["schedule_seed"]
    rng = arr.rng_for(seed, stream)
    if mix["arrivals"] == "poisson":
        times = arr.poisson_arrivals(mix["rate_x_knee"] * knee_hz, seconds,
                                     rng)
    else:
        r, d = mix["rate_x_knee"], mix["dwell_s"]
        times, _ = arr.mmpp_arrivals(r["low"] * knee_hz, r["high"] * knee_hz,
                                     seconds, rng, mean_lo_s=d["low"],
                                     mean_hi_s=d["high"],
                                     start_high=mix["start_high"])
    ln = mix["length"]
    lens = arr.lognormal_lengths(len(times), ln["median"], ln["sigma"],
                                 ln["lo"], ln["hi"], ln["multiple"],
                                 arr.rng_for(seed, stream + ".lengths"))
    return times, lens


def sample(lens: np.ndarray, mix: Dict, seed: int) -> List[int]:
    """The requests whose answers the comparison reads: the longest of the
    first ``from_first`` of the window's requests and others drawn from
    the seed among them."""
    n = min(len(lens), max(1, int(len(lens) * mix["sample"]["from_first"])))
    if n == 0:
        return []
    first = int(np.argmax(lens[:n]))
    rest = [i for i in arr.rng_for(seed, "sample").permutation(n).tolist()
            if i != first]
    return [first] + rest[:mix["sample"]["requests"] - 1]


class Driver:
    """Serves one schedule through an engine on the wall clock."""

    def __init__(self, engine, model: Dict, mix: Dict, seed: int, device,
                 keep=()):
        self.engine, self.model, self.mix = engine, model, mix
        self.seed, self.device = seed, device
        self.cuda = torch.device(device).type == "cuda"
        self.B = model["serve"]["batch"]
        self.keep = set(keep)
        self.served: Dict[int, torch.Tensor] = {}   # request -> tokens
        self.done_at: Dict[int, float] = {}         # request -> seconds
        self.step_s: List[float] = []               # spans on the card
        self.req_of: Dict[int, int] = {}            # engine id -> request

    def _sync(self) -> None:
        if self.cuda:
            torch.cuda.synchronize()

    def _mark(self):
        """A point of the card's timeline: a CUDA event on the stream (on
        the CPU, whose work is done when the call returns, the clock)."""
        if not self.cuda:
            return time.perf_counter()
        ev = torch.cuda.Event(enable_timing=True)
        ev.record()
        return ev

    def drive(self, times, lens, seconds: float, drain: bool,
              offset: int = 0, limit_s: float = 120.0,
              until: Optional[set] = None) -> float:
        """Serve requests ``offset + i`` due at ``times[i]`` seconds after
        this call, on an idle card, stopping early once every request of
        ``until`` is served; returns the seconds the call took, the card's
        work included."""
        eng = self.engine
        V = self.model["vocab_size"]
        t0 = time.perf_counter()
        origin = self._mark()
        spans, finished = [], []
        i, n = 0, len(times)
        while until is None or not until <= self.served.keys():
            t = time.perf_counter() - t0
            while i < n and times[i] <= t:
                toks = request_tokens(self.seed, offset + i, self.B,
                                      int(lens[i]), V, self.device)
                rid = eng.submit({"tokens": toks}, t_now=float(times[i]))
                self.req_of[rid] = offset + i
                i += 1
            closed = t >= seconds
            if closed and (not drain or t >= seconds + limit_s):
                break
            if not any(eng.queues):
                if i >= n and closed:
                    break
                if i < n:
                    time.sleep(max(0.0, min(times[i] - t, 0.002)))
                continue
            m0 = self._mark()
            done = eng.step(dt=self.mix["dt"], t_now=t)
            m1 = self._mark()
            if t < seconds:
                spans.append((m0, m1))
            for rid, logits in done:
                if self.req_of[rid] in self.keep:
                    self.served[self.req_of[rid]] = logits.argmax(-1)
            if done:
                finished.append((m1, [self.req_of[rid] for rid, _ in done]))
                if self.cuda:
                    m1.synchronize()    # answers are handed out when ready
        self._sync()
        if self.cuda:
            at = lambda m: origin.elapsed_time(m) / 1e3  # noqa: E731
        else:
            at = lambda m: m - origin  # noqa: E731
        self.step_s += [at(b) - at(a) for a, b in spans]
        for m, reqs in finished:
            for r in reqs:
                self.done_at[r] = at(m)
        return time.perf_counter() - t0


def warm(cfg, params, model: Dict, mix: Dict, seed: int, device) -> None:
    """Serve one request of every length bucket through all stages."""
    eng = program.serve_engine(cfg, None, dict(mix, tau_med=1e30,
                                               tau_high=1e30), params)
    ln = mix["length"]
    buckets = arr.length_buckets(ln["lo"], ln["hi"], ln["multiple"])
    offset = 1 << 40
    d = Driver(eng, model, mix, seed, device,
               keep=[offset + k for k in range(len(buckets))])
    d.drive(np.zeros(len(buckets)), np.array(buckets), 0.0, drain=True,
            offset=offset)


def run(cell: Cell, seed: int, seconds: float, trace: bool, device,
        t_start: float, fault: Optional[Callable] = None,
        model: Optional[Dict] = None) -> Outcome:
    """``fault`` takes the engine and may break it (the harness's own
    tests); ``model`` stands in for the cell's configuration."""
    model = model or cell.model
    mix = cell.mix
    B, L = model["serve"]["batch"], model["num_hidden_layers"]
    knee = model["serve"]["knee_hz"]
    cfg = program.port_config(model)
    params = program.port_lm(cfg, draw_weights(model, seed, device))
    times, lens = schedule(mix, knee, seconds, "arrivals")
    keep = sample(lens, mix, seed)
    warm(cfg, params, model, mix, seed, device)
    engine = program.serve_engine(cfg, None, mix, params)
    if fault is not None:
        fault(engine)
    if trace:
        tracing.warm_profiler()
    drv = Driver(engine, model, mix, seed, device, keep=keep)
    drv._sync()
    setup_s = time.perf_counter() - t_start

    drv.drive(times, lens, seconds, drain=mix["drain"])
    comp = program.completions(engine)
    in_window = [i for i, t in drv.done_at.items() if t <= seconds]
    label = {drv.req_of[rid]: v for rid, v in comp.items()}
    lat = np.array([drv.done_at.get(i, np.inf) - times[i]
                    for i in range(len(times))])
    failed = int(np.sum(~np.isfinite(lat))) if mix["drain"] else 0
    work = sum(B * int(lens[i]) * label[i][1] / L for i in in_window)
    ctx = {"kind": "serve", "window_s": seconds, "step_s": list(drv.step_s),
           "model_flops": sum(flops.forward_flops(model, B, int(lens[i]),
                                                  label[i][1])
                              for i in in_window),
           "rows": {lbl: B * sum(1 for i in in_window if label[i][0] == lbl)
                    for lbl in (0, 1, 2)},
           "latency_s": [drv.done_at[i] - times[i] for i in in_window]}
    # the sampled answers the window left unfinished (a mix without drain)
    # are waited for, up to a minute past the close: late, not wrong
    drv.drive([], [], 0.0, drain=True, limit_s=60.0, until=set(keep))
    label = {drv.req_of[rid]: v
             for rid, v in program.completions(engine).items()}
    extra, breakdown = {}, None
    if trace:
        t_times, t_lens = schedule(mix, knee, mix["trace_seconds"], "trace")
        with program.FlashShapes() as shapes, tracing.Window() as w:
            drv.drive(t_times, t_lens, mix["trace_seconds"], drain=False,
                      offset=len(times))
        h_times, h_lens = schedule(mix, knee, mix["trace_seconds"] / 2,
                                   "trace.host")
        with tracing.Window(host=True) as wh:
            drv.drive(h_times, h_lens, mix["trace_seconds"] / 2, drain=False,
                      offset=len(times) + len(t_times))
        ctx.update(trace=w, flash_calls=shapes.calls)
        launches = w.time_of(lambda n: readers.FLASH_FWD in n)[0]
        print(f"traced window: {len(shapes.calls)} flash calls, "
              f"{launches} flash launches", file=sys.stderr)
        extra = {"busy_s": w.busy_s, "window_s": w.window_s}
        breakdown = tracing.breakdown(w, wh)
    peak = torch.cuda.max_memory_allocated() \
        if torch.device(device).type == "cuda" else 0

    served = {i: drv.served[i] for i in keep
              if i in drv.served and i in label}
    del engine, drv, params
    gc.collect()
    if torch.device(device).type == "cuda":
        torch.cuda.empty_cache()
    gaps = reference_gaps(model, seed, device, lens, served,
                          {i: label[i][1] for i in served})
    e2e = {"setup_s": setup_s, "serve_tokens_per_s": work / seconds}
    if mix["drain"]:
        e2e["serve_p95_ms"] = float(np.percentile(lat, 95)) * 1e3
    return Outcome(attempted=len(times), failed=failed, end_to_end=e2e,
                   ctx=ctx, compared=compare(gaps, cell.limits),
                   readings=gaps,
                   device_extra=extra, breakdown=breakdown,
                   memory_peak_bytes=peak)


def reference_gaps(model: Dict, seed: int, device, lens, served: Dict,
                   layers: Dict) -> Dict[str, float]:
    """The numbers the serve cells compare, over the finished samples: the
    widest gap of any served token (``logit_gap``) and the mean gap over
    every served position (``mean_logit_gap``); empty where none
    finished."""
    if not served:
        return {}
    if torch.device(device).type == "cuda":
        ref.plain_mode()
    tree = draw_weights(model, seed, device)
    B, V = model["serve"]["batch"], model["vocab_size"]
    widest, total, n = 0.0, 0.0, 0
    for i, toks in served.items():
        prompt = request_tokens(seed, i, B, int(lens[i]), V, device)
        w, mean = ref.served_gap(tree, model, prompt, layers[i], toks)
        widest = max(widest, w)
        total += mean * prompt.numel()
        n += prompt.numel()
    return {"logit_gap": widest, "mean_logit_gap": total / n}
