"""Batched-request serve engine over a φ-partitioned model; port of
``repro/splitcompute/serve_engine.py``.

The paper's protocol driving real model execution: an LM is split at
vertical split points into stages (``plan_stages``), each stage is bound to
a simulated heterogeneous executor, and requests flow stage to stage as
partial inferences flow UAV to UAV in the swarm.  The congestion-aware
early exit (Eqs. 14-16) watches each executor's queue and truncates
inference at the model's exit layers under load.

The engine keeps the reference's deterministic epoch clock, queue
snapshot, admission control, results stash and flight-recorder rows.  Its
bookkeeping (queues, congestion state, records, histograms) lives on the
host, in float32 tensors on the CPU and numpy, and rounds as the
reference's eager JAX does, so counters, records and histograms do not
depend on the device or on whether the kernels ran.  The stage functions
run on the parameters' device under ``torch.inference_mode()``.
"""
from __future__ import annotations

from collections import deque
from typing import Dict, List, Optional, Tuple

import numpy as np
import torch

from repro_torch.configs import ModelConfig
from repro_torch.core.early_exit import (CongestionState,
                                         congestion_update_eager, exit_label)
from repro_torch.models.common import slice_layers
from repro_torch.models.transformer import (DECODER_FAMILIES, LM, embed_in,
                                            head_out, run_layers)
from repro_torch.obs import hist as obs_hist
from repro_torch.splitcompute.partitioner import StagePlan
from repro_torch.trace import schema
from repro_torch.trace.schema import SEGMENTS


class ServeStats:
    """Deterministic serving telemetry on the shared TaskRecord vocabulary
    (``repro_torch.trace.schema``, DESIGN.md §10.1): one record row per served
    sample — request id as ``seq``, entry stage as ``src``, completing
    stage as ``dst``, stages traversed as ``hops`` — so sim and serve
    aggregate/export through the same record pipeline.  All
    timestamps come from the caller's clock domain (``submit``/``step``
    ``t_now``), never from wall time; the historical counter surface
    (``completed`` / ``latency_sum`` / ``exit_counts`` / ``avg_latency``)
    is derived from the records.

    Streaming SLO surface (DESIGN.md §14.1): every ``record()`` also fills
    a log-bucketed latency histogram plus per-segment histograms
    (compute / queue-wait / airtime / stall), so p50/p99/p999 stay O(1)
    in memory however many requests flow through — the record rows can be
    bounded (``max_records``) without losing the quantile story.
    """

    def __init__(self, max_records: Optional[int] = None,
                 latency_hist: Optional[obs_hist.HistSpec] = None):
        # counters are maintained incrementally (O(1) access however long
        # the serve loop runs); the rows are the exportable telemetry and
        # can be bounded like the sim side's trace_capacity — beyond
        # ``max_records`` the counters keep counting, rows overflow
        self._rows: List[np.ndarray] = []
        self.max_records = max_records
        self.record_overflow = 0
        self._completed = 0
        self._latency_sum = 0.0
        self._exit_counts: Dict[int, int] = {0: 0, 1: 0, 2: 0}
        # flight-recorder stream (sim's trace_state analogue): one system
        # gauge row + one per-stage gauge row per sampled epoch, on the
        # shared SYS_GAUGES / STATE_GAUGES vocabulary
        self._state_rows: List[np.ndarray] = []
        self._stage_rows: List[np.ndarray] = []
        self._dropped = 0
        self._generated = 0
        self._generated_rows = 0
        # streaming histograms: end-to-end latency + the critical-path
        # segment decomposition (same spec everywhere ⇒ mergeable)
        self.hist_spec = latency_hist or obs_hist.DEFAULT_LATENCY_HIST
        self.latency_counts = obs_hist.empty_np(self.hist_spec)
        self.segment_counts: Dict[str, np.ndarray] = {
            s: obs_hist.empty_np(self.hist_spec) for s in SEGMENTS}
        # exact per-segment second totals: latency_sum == Σ segment_sums
        # whenever every record carried service_s (the reconciliation
        # invariant slo_indices reports)
        self.segment_sums: Dict[str, float] = {s: 0.0 for s in SEGMENTS}
        # deterministic time-to-first-exit anchors (caller clock domain)
        self.first_submit_t: Optional[float] = None
        self.first_exit_t: Optional[float] = None

    def record_state(self, *, t, queue_depths, in_flight=None,
                     completed=None, dropped=None, generated=None,
                     load=None) -> None:
        """Append one flight-recorder sample (sim's ``write_state``
        analogue) on the shared gauge vocabulary.

        ``queue_depths`` is the per-stage depth snapshot; ``load``
        optionally carries the per-stage congestion metric D (Eqs. 14-15)
        into the ``phi`` gauge lane — the serve side's diffusive-metric
        stand-in, so the same decode/aggregate/export pipeline renders
        both.  Counters default from the incremental record() totals.
        """
        q = np.asarray(queue_depths, np.float64)
        completed = self._completed if completed is None else completed
        dropped = self._dropped if dropped is None else dropped
        generated = self._generated if generated is None else generated
        jain = (q.sum() ** 2) / (len(q) * (q * q).sum() + 1e-12)
        self._state_rows.append(schema.pack_state_sys_np(
            t, q.sum() if in_flight is None else in_flight,
            0.0, completed, dropped, generated,
            q.mean() if len(q) else 0.0, q.max() if len(q) else 0.0, jain,
            *( (float(np.mean(load)), float(np.min(load)),
                float(np.max(load))) if load is not None else (0, 0, 0) )))
        phi = (np.asarray(load, np.float64) if load is not None
               else np.zeros_like(q))
        rows = np.zeros((len(q), schema.NUM_STATE_GAUGES), np.float64)
        rows[:, schema.ST_PHI] = phi
        rows[:, schema.ST_QUEUE_DEPTH] = q
        rows[:, schema.ST_ALIVE] = 1.0
        self._stage_rows.append(rows)

    @property
    def state_records(self) -> np.ndarray:
        """``[samples, NUM_SYS_GAUGES]`` system gauge rows
        (``trace.decode_state(sys=...)``-able)."""
        if not self._state_rows:
            return np.zeros((0, schema.NUM_SYS_GAUGES), np.float64)
        return np.stack(self._state_rows)

    @property
    def stage_state(self) -> np.ndarray:
        """``[samples, n_stages, NUM_STATE_GAUGES]`` per-stage gauge rows
        (``trace.decode_state(state=...)``-able)."""
        if not self._stage_rows:
            return np.zeros((0, 0, schema.NUM_STATE_GAUGES), np.float64)
        return np.stack(self._stage_rows)

    def note_submit(self, t: float, rows: int = 1) -> None:
        """Stamp an admission: first-submit anchor + row-level counter
        (``_generated`` keeps its historical submit-count semantics)."""
        if self.first_submit_t is None:
            self.first_submit_t = float(t)
        self._generated_rows += rows

    def record(self, *, seq, src, dst, created_t, completed_t, exit_label,
               layers, hops, count=1, service_s=None) -> None:
        """Append ``count`` identical sample records (one per batch row).

        ``service_s`` is the caller's estimate of pure execution time for
        the request (stages run × epoch dt on the serve path); clamped to
        the recorded latency it becomes the compute segment, the rest
        queue-wait — the serve side of the DESIGN.md §14.4 decomposition
        (no radio ⇒ airtime/stall stay zero).
        """
        self._completed += count
        lat = float(completed_t - created_t)
        self._latency_sum += lat * count
        if self.first_exit_t is None:
            self.first_exit_t = float(completed_t)
        obs_hist.fill_np(self.hist_spec, self.latency_counts, [lat],
                         [count])
        if service_s is not None:
            comp = min(float(service_s), max(lat, 0.0))
            wait = max(lat, 0.0) - comp
            obs_hist.fill_np(self.hist_spec,
                             self.segment_counts["compute_s"],
                             [comp], [count])
            obs_hist.fill_np(self.hist_spec,
                             self.segment_counts["queue_wait_s"],
                             [wait], [count])
            self.segment_sums["compute_s"] += comp * count
            self.segment_sums["queue_wait_s"] += wait * count
        lbl = int(exit_label)
        self._exit_counts[lbl] = self._exit_counts.get(lbl, 0) + count
        kept = count
        if self.max_records is not None:
            kept = max(0, min(count, self.max_records - len(self._rows)))
            self.record_overflow += count - kept
        if kept:
            row = schema.pack_np(seq, src, dst, created_t, completed_t,
                                 exit_label, layers, hops)
            self._rows.extend([row] * kept)

    def drop(self, *, seq, src, t_now, count=1) -> None:
        """Record an admission-control drop: ``count`` DROPPED rows at
        ``t_now`` (created == completed — the request never entered), on
        the same vocabulary the sim uses for its drops."""
        self._dropped += count
        kept = count
        if self.max_records is not None:
            kept = max(0, min(count, self.max_records - len(self._rows)))
            self.record_overflow += count - kept
        if kept:
            row = schema.pack_np(seq, src, src, t_now, t_now,
                                 schema.DROPPED, 0, 0)
            self._rows.extend([row] * kept)

    @property
    def records(self) -> np.ndarray:
        """``[completed, NUM_FIELDS]`` TaskRecord rows (trace.decode-able)."""
        if not self._rows:
            return np.zeros((0, schema.NUM_FIELDS), np.float64)
        return np.stack(self._rows)

    @property
    def completed(self) -> int:
        return self._completed

    @property
    def latency_sum(self) -> float:
        return self._latency_sum

    @property
    def exit_counts(self) -> Dict[int, int]:
        return dict(self._exit_counts)

    @property
    def dropped(self) -> int:
        return self._dropped

    @property
    def generated(self) -> int:
        return self._generated

    @property
    def generated_rows(self) -> int:
        return self._generated_rows

    @property
    def avg_latency(self) -> float:
        """Mean completion latency; ``nan`` (not a fake 0) before the
        first completion — well-defined and unmistakable downstream."""
        if self._completed == 0:
            return float("nan")
        return self._latency_sum / self._completed

    @property
    def time_to_first_exit(self) -> float:
        """First completion time minus first submit time, both in the
        caller's clock domain — deterministic by construction; ``nan``
        until both anchors exist."""
        if self.first_submit_t is None or self.first_exit_t is None:
            return float("nan")
        return self.first_exit_t - self.first_submit_t

    def latency_quantiles(self, qs=obs_hist.SLO_QS) -> Dict:
        """Streaming p50/p99/p999 summary of the latency histogram."""
        return obs_hist.summary(self.hist_spec, self.latency_counts, qs)

    def __repr__(self):
        return (f"ServeStats(completed={self.completed}, "
                f"avg_latency={self.avg_latency:.4f}, "
                f"exit_counts={self.exit_counts})")


class SplitServeEngine:
    """Decoder-only families (dense/moe/vlm): stages = layer ranges of
    ``params``."""

    def __init__(self, cfg: ModelConfig, params: LM, plan: StagePlan, *,
                 tau_med=1.0, tau_high=3.0, alpha=0.3, max_results=64,
                 max_queue: Optional[int] = None, state_every: int = 1,
                 max_records: Optional[int] = None,
                 latency_hist: Optional[obs_hist.HistSpec] = None):
        if cfg.family not in DECODER_FAMILIES:
            raise NotImplementedError(
                f"the split-serve engine takes the decoder-only families "
                f"{DECODER_FAMILIES}, not {cfg.family!r}")
        self.cfg = cfg
        self.params = params
        self.plan = plan
        self.n_stages = len(plan.executors)
        # per-stage layers (a slice of the module list, shared)
        self.stage_layers = [
            slice_layers(params.layers, plan.boundaries[i],
                         plan.boundaries[i + 1])
            for i in range(self.n_stages)]
        # early-exit bookkeeping per executor (host, float32)
        self.cong = CongestionState(torch.zeros(self.n_stages),
                                    torch.zeros(self.n_stages))
        self.tau = (tau_med, tau_high)
        self.alpha = alpha
        self.queues = [deque() for _ in range(self.n_stages)]
        # admission control: submits beyond max_queue are dropped and
        # recorded; None keeps the queue unbounded
        self.max_queue = max_queue
        # flight-recorder stride: sample every state_every-th epoch
        self.state_every = max(int(state_every), 1)
        self._epoch = 0
        self.stats = ServeStats(max_records=max_records,
                                latency_hist=latency_hist)
        # completion stash, request_id -> logits (oldest evicted beyond
        # max_results; each entry pins a [batch, seq, vocab] buffer)
        self.results: Dict[int, torch.Tensor] = {}
        self.max_results = max_results
        self.clock = 0.0          # internal epoch clock (t_now fallback)
        self._next_id = 0

    def _stage_fn(self, i: int, h: torch.Tensor,
                  positions: torch.Tensor) -> torch.Tensor:
        with torch.inference_mode():
            h2, _, _ = run_layers(self.stage_layers[i], self.cfg, h,
                                  positions, mode="train")
        return h2

    def _head_fn(self, h: torch.Tensor) -> torch.Tensor:
        with torch.inference_mode():
            return head_out(self.params, self.cfg, h)

    # -- exit boundaries in *stage* space -----------------------------------
    def _exit_stage(self, label: int) -> int:
        """How many stages to run for a congestion label (Eq. 16 analogue):
        full / exit at L//2 / exit at L//4."""
        L = self.cfg.num_layers
        exit_layers = {0: L, 1: max(self.cfg.exit_layers_[1], 1),
                       2: max(self.cfg.exit_layers_[0], 1)}[label]
        for s in range(self.n_stages):
            if self.plan.boundaries[s + 1] >= exit_layers:
                return s + 1
        return self.n_stages

    def submit(self, batch: Dict, t_now: Optional[float] = None
               ) -> Optional[int]:
        """Enqueue one request batch ({'tokens': [B, S]}, or the vlm's
        {'embeds': [B, S, d]}, on the parameters' device); returns its
        request id, or ``None`` when admission control
        (``max_queue``) rejects it (recorded as a DROPPED row).  ``t_now``
        stamps arrival in the caller's clock domain; omitted, the engine's
        deterministic epoch clock."""
        with torch.inference_mode():
            h, positions = embed_in(self.params, self.cfg, batch)
        return self._enqueue(h, positions, t_now, rows=int(h.shape[0]))

    def _enqueue(self, h, positions, t_now: Optional[float],
                 rows: int = 1) -> Optional[int]:
        """Admission + queue push shared by submit() and subclasses that
        skip the embedding (synthetic load)."""
        t0 = self.clock if t_now is None else t_now
        rid = self._next_id
        self._next_id += 1
        self.stats._generated += 1
        self.stats.note_submit(t0, rows)
        if self.max_queue is not None and \
                len(self.queues[0]) >= self.max_queue:
            self.stats.drop(seq=rid, src=0, t_now=t0, count=rows)
            return None
        self.queues[0].append({
            "id": rid, "h": h, "positions": positions,
            "t0": t0, "stage": 0})
        return rid

    def step(self, dt: float = 0.05, t_now: Optional[float] = None
             ) -> List[Tuple[int, torch.Tensor]]:
        """One scheduling epoch: per-executor congestion update (Eqs.
        14-15), exit decision (Eq. 16), then each executor advances one
        request, and only requests that were queued when the epoch began
        (the queue lengths are snapshotted first, so a request moves at
        most one stage an epoch).  Returns the requests completed this
        epoch as ``(request_id, logits)`` pairs, also stashed in
        ``self.results``."""
        if t_now is None:
            self.clock += dt
            t_now = self.clock
        else:
            self.clock = t_now
        self._epoch += 1
        labels = self._congestion_labels([len(q) for q in self.queues], dt)

        depth = [len(q) for q in self.queues]
        completed: List[Tuple[int, torch.Tensor]] = []
        for s in range(self.n_stages):
            if depth[s] == 0:
                continue
            req = self.queues[s].popleft()
            h = self._stage_fn(s, req["h"], req["positions"])
            nxt = s + 1
            lbl = int(labels[s])
            stop_at = self._exit_stage(lbl)
            if nxt >= stop_at or nxt >= self.n_stages:
                logits = self._head_fn(h)
                size = h.shape[0]
                self.stats.record(
                    seq=req["id"], src=0, dst=s, created_t=req["t0"],
                    completed_t=t_now, exit_label=lbl,
                    layers=int(self.plan.boundaries[s + 1]), hops=s,
                    count=size, service_s=(s + 1) * dt)
                if self.max_results:
                    self.results[req["id"]] = logits
                    while len(self.results) > self.max_results:
                        self.results.pop(next(iter(self.results)))
                completed.append((req["id"], logits))
            else:
                req["h"] = h
                req["stage"] = nxt
                self.queues[nxt].append(req)
        # flight-recorder sample: post-step depths + the congestion metric
        # D in the phi lane
        if self._epoch % self.state_every == 0:
            self.stats.record_state(
                t=t_now, queue_depths=[len(q) for q in self.queues],
                load=np.asarray(self.cong.D))
        return completed

    def _congestion_labels(self, qlens: List[int], dt: float) -> np.ndarray:
        """Per-executor congestion update (Eqs. 14-15) + exit decision
        (Eq. 16) for one epoch; subclasses may override with an equivalent
        host-side mirror (the synthetic load engine does)."""
        qlen = torch.tensor([float(x) for x in qlens], dtype=torch.float32)
        self.cong = congestion_update_eager(self.cong, qlen, dt, self.alpha)
        return np.asarray(exit_label(self.cong.D, *self.tau))

    def drain(self, max_steps=1000, dt: float = 0.05) -> ServeStats:
        for _ in range(max_steps):
            if not any(self.queues):
                break
            self.step(dt)
        return self.stats
