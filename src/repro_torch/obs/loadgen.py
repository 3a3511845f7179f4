"""Open-loop load generation for the serve path (DESIGN.md §14.2); port
of ``repro/obs/loadgen.py``.

Three arrival processes on the **deterministic clock** — every arrival
time is a pure function of (process parameters, seed), drawn up front
from an explicitly seeded generator, never from ambient randomness:

  * :func:`poisson_arrivals` — homogeneous Poisson (i.i.d. exponential
    inter-arrivals at ``rate_hz``);
  * :func:`mmpp_arrivals` — 2-state Markov-modulated Poisson process
    (exponential dwell in a low-rate and a high-rate state; the serve
    analogue of the sim's ON/OFF bursty arrivals, DESIGN.md §3.2);
  * :func:`replay_arrivals` — replay a recorded timestamp trace.

:func:`run_open_loop` drives an engine's ``submit`` with those arrivals
coalesced onto the epoch grid — *open-loop*: arrivals never wait for
completions, so overload shows up as queue growth / drops, not as a
throttled generator.  The engine's service capacity is one batch per
stage per epoch, so offered load is controlled as
``rate_hz · dt / max_batch`` batches per epoch and the knee sits at
``rate_hz* = max_batch / dt`` rows/s.

:class:`SyntheticServeEngine` is the scheduling-faithful double of
:class:`~repro_torch.splitcompute.serve_engine.SplitServeEngine` — same queues,
same epoch snapshot, same congestion EMA and exit ladder (a numpy mirror
of Eqs. 14-16), same ``ServeStats`` — with the model math replaced by
identity stage functions, so a ≥ 1M-request load test completes on the
host in seconds while exercising exactly the scheduler the real engine
runs.  The arrival draws are the reference's ``np.random.default_rng(seed)``
draws, so both packages offer the same arrival times.
"""
from __future__ import annotations

from collections import deque
from types import SimpleNamespace
from typing import Callable, Optional

import numpy as np

from repro_torch.core.early_exit import CongestionState
from repro_torch.obs.hist import HistSpec
from repro_torch.splitcompute.serve_engine import (ServeStats,
                                                   SplitServeEngine)

# generation chunk for arrival draws (bounds memory while staying vector)
_CHUNK = 65_536


def poisson_arrivals(rate_hz: float, horizon_s: float,
                     seed: int = 0) -> np.ndarray:
    """Arrival times of a homogeneous Poisson process on [0, horizon)."""
    if rate_hz <= 0.0 or horizon_s <= 0.0:
        return np.zeros((0,), np.float64)
    rng = np.random.default_rng(seed)
    out = []
    t = 0.0
    while t < horizon_s:
        gaps = rng.exponential(1.0 / rate_hz, size=_CHUNK)
        times = t + np.cumsum(gaps)
        out.append(times)
        t = float(times[-1])
    times = np.concatenate(out)
    return times[times < horizon_s]


def mmpp_arrivals(rate_lo_hz: float, rate_hi_hz: float, horizon_s: float,
                  *, mean_lo_s: float = 6.0, mean_hi_s: float = 2.0,
                  seed: int = 0) -> np.ndarray:
    """2-state MMPP: Poisson at ``rate_lo_hz`` / ``rate_hi_hz`` while the
    modulating chain dwells (exponentially, means ``mean_lo_s`` /
    ``mean_hi_s``) in its low/high state.  Starts low; long-run mean rate
    is the dwell-weighted average of the two rates."""
    rng = np.random.default_rng(seed)
    out = []
    t = 0.0
    hi = False
    while t < horizon_s:
        dwell = rng.exponential(mean_hi_s if hi else mean_lo_s)
        rate = rate_hi_hz if hi else rate_lo_hz
        end = min(t + dwell, horizon_s)
        if rate > 0.0:
            seg = t
            while seg < end:
                gaps = rng.exponential(1.0 / rate, size=_CHUNK)
                times = seg + np.cumsum(gaps)
                out.append(times[times < end])
                seg = float(times[-1])
        t = end
        hi = not hi
    if not out:
        return np.zeros((0,), np.float64)
    return np.sort(np.concatenate(out))


def replay_arrivals(times, horizon_s: Optional[float] = None) -> np.ndarray:
    """Replay a recorded arrival-time trace: sorted, non-negative,
    optionally clipped to [0, horizon)."""
    t = np.sort(np.asarray(times, np.float64).ravel())
    t = t[t >= 0.0]
    if horizon_s is not None:
        t = t[t < horizon_s]
    return t


class SyntheticServeEngine(SplitServeEngine):
    """Scheduling-faithful, model-free serve engine for load tests.

    Inherits ``step``/``drain``/``_enqueue``/``_exit_stage`` — the entire
    scheduler — from :class:`SplitServeEngine`; only the model execution
    (identity stage and head functions over empty ``[rows, 0]`` payloads)
    and the congestion block (a float64 numpy mirror of Eqs. 14-16, no
    tensor in the million-epoch loop) are replaced.
    """

    def __init__(self, *, n_stages: int = 4, layers_per_stage: int = 15,
                 tau_med: float = 1.5, tau_high: float = 2.5,
                 alpha: float = 0.3, max_queue: Optional[int] = None,
                 state_every: int = 1, max_records: Optional[int] = None,
                 latency_hist: Optional[HistSpec] = None):
        num_layers = n_stages * layers_per_stage
        self.cfg = SimpleNamespace(
            family="dense", num_layers=num_layers,
            exit_layers_=(max(num_layers // 4, 1), max(num_layers // 2, 1)))
        self.plan = SimpleNamespace(
            boundaries=[i * layers_per_stage for i in range(n_stages + 1)],
            executors=list(range(n_stages)))
        self.n_stages = n_stages
        self.cong = CongestionState(np.zeros((n_stages,), np.float64),
                                    np.zeros((n_stages,), np.float64))
        self.tau = (tau_med, tau_high)
        self.alpha = alpha
        self.queues = [deque() for _ in range(n_stages)]
        self.max_queue = max_queue
        self.state_every = max(int(state_every), 1)
        self._epoch = 0
        self.stats = ServeStats(max_records=max_records,
                                latency_hist=latency_hist)
        self.results = {}
        self.max_results = 0          # never stash synthetic logits
        self.clock = 0.0
        self._next_id = 0

    def _stage_fn(self, i: int, h, positions):
        return h

    def _head_fn(self, h):
        return h

    def submit(self, rows: int = 1,
               t_now: Optional[float] = None) -> Optional[int]:
        """Enqueue one synthetic batch of ``rows`` samples (no tokens, no
        embedding — the payload is an empty ``[rows, 0]`` array, so memory
        stays flat at any request count)."""
        h = np.empty((int(rows), 0), np.float32)
        return self._enqueue(h, None, t_now, rows=int(rows))

    def _congestion_labels(self, qlens, dt: float) -> np.ndarray:
        # numpy mirror of congestion_update + exit_label (same strict
        # inequalities as core.early_exit) — no device round-trip per epoch
        T = np.asarray(qlens, np.float64)
        dT = (T - self.cong.prev_T) / dt
        D = self.cong.D + self.alpha * (dT - self.cong.D)
        self.cong = CongestionState(T, D)
        return np.where(D > self.tau[1], 2, np.where(D > self.tau[0], 1, 0))


def run_open_loop(engine, arrivals, *, dt: float = 0.01,
                  max_batch: int = 64, drain_epochs: int = 1_000_000,
                  on_epoch: Optional[Callable] = None) -> ServeStats:
    """Drive ``engine`` with ``arrivals`` (sorted seconds) in open loop.

    Arrivals are coalesced onto the epoch grid into **full** batches of
    ``max_batch`` rows — a partial batch waits for the next epoch's
    arrivals rather than consuming a whole service slot (the engine
    serves one batch per stage per epoch, so full batches make the
    batch-level utilization exactly ``rate · dt / max_batch`` and the
    knee land at capacity; the tail is flushed partial once arrivals
    end).  Each batch is stamped with its *first* row's true arrival
    time — coalescing quantizes service start, never the latency origin.
    After the last arrival the engine drains (bounded by
    ``drain_epochs``).  ``on_epoch(epoch, t, engine)`` fires every epoch
    for progress/gauge emission.  Returns ``engine.stats``.
    """
    times = np.asarray(arrivals, np.float64)
    n = int(times.size)
    i = 0                 # arrivals admitted to the batching window
    s = 0                 # arrivals submitted to the engine
    epoch = 0
    idle = 0
    while True:
        t = (epoch + 1) * dt
        while i < n and times[i] <= t:
            i += 1
        while i - s >= max_batch:
            engine.submit(max_batch, t_now=float(times[s]))
            s += max_batch
        if i >= n and s < n:
            # tail flush: no future arrival can complete this batch
            engine.submit(n - s, t_now=float(times[s]))
            s = n
        engine.step(dt=dt, t_now=t)
        if on_epoch is not None:
            on_epoch(epoch, t, engine)
        epoch += 1
        if s >= n:
            if not any(engine.queues):
                break
            idle += 1
            if idle >= drain_epochs:
                break
    return engine.stats
