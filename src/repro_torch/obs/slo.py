"""SLO report builder (DESIGN.md §14.3); port of ``repro/obs/slo.py``
(numpy, over the port's trace decoding): turn one load-test run's
:class:`~repro_torch.splitcompute.serve_engine.ServeStats` into the JSON-ready
``slo_serve`` payload — p50/p99/p999 latency, goodput, time-to-first-exit,
drop rate, queue-saturation gauges, and the per-segment latency quantiles
with their exact reconciliation residual — plus the Prometheus registry
and Perfetto counter-track exports of the same numbers.
"""
from __future__ import annotations

import math
from typing import Dict, List, Optional

import numpy as np

from repro_torch.obs import hist as obs_hist
from repro_torch.obs.registry import Registry
from repro_torch.trace import SEGMENTS, decode_state, state_counter_events


def _none_if_nan(x: float) -> Optional[float]:
    return None if x is None or math.isnan(x) else float(x)


def slo_indices(stats, *, horizon_s: float, offered_rows: int,
                rate_rps: Optional[float] = None,
                max_queue: Optional[int] = None) -> Dict:
    """One run's ServeStats → the per-point ``slo_serve`` section.

    Stable key set; quantiles are the streaming-histogram summaries
    (``None`` in the overflow bin), ``segment_reconcile_err_s`` is
    ``|Σ latency − Σ segments|`` — exactly 0 up to float rounding because
    the serve path computes queue-wait as the per-record remainder.
    """
    lat = stats.latency_quantiles()
    segs = {}
    seg_sum_total = 0.0
    for name in SEGMENTS:
        s = obs_hist.summary(stats.hist_spec, stats.segment_counts[name])
        s["sum_s"] = float(stats.segment_sums[name])
        seg_sum_total += s["sum_s"]
        segs[name] = s
    drop_rate = (stats.dropped / max(stats.generated_rows, 1)
                 if stats.generated_rows else 0.0)
    out: Dict = {
        "offered_rows": int(offered_rows),
        "offered_rate_rps": (None if rate_rps is None else float(rate_rps)),
        "horizon_s": float(horizon_s),
        "completed": int(stats.completed),
        "dropped": int(stats.dropped),
        "drop_rate": float(drop_rate),
        "goodput_rps": (float(stats.completed / horizon_s)
                        if horizon_s > 0 else 0.0),
        "avg_latency_s": _none_if_nan(stats.avg_latency),
        "time_to_first_exit_s": _none_if_nan(stats.time_to_first_exit),
        "exit_counts": {str(k): int(v)
                        for k, v in sorted(stats.exit_counts.items())},
        "latency_s": lat,
        "segments": segs,
        "segment_reconcile_err_s": abs(float(stats.latency_sum)
                                       - seg_sum_total),
    }
    # queue-saturation gauges from the flight-recorder stream
    out["queue_depth_mean"] = None
    out["queue_depth_max"] = None
    out["queue_depth_final"] = None
    out["queue_saturation"] = None
    sysbuf = stats.state_records
    if sysbuf.shape[0]:
        sdec = decode_state(sys=sysbuf)
        qmean = np.asarray(sdec["queue_depth_mean"], np.float64)[0]
        qmax = np.asarray(sdec["queue_depth_max"], np.float64)[0]
        out["queue_depth_mean"] = float(qmean.mean())
        out["queue_depth_max"] = float(qmax.max())
        out["queue_depth_final"] = float(qmax[-1])
        if max_queue:
            out["queue_saturation"] = float(qmax.max() / max_queue)
    return out


def fill_registry(reg: Registry, stats, *, prefix: str = "repro_slo",
                  process: str = "poisson") -> Registry:
    """Export one run's ServeStats into Prometheus instruments.

    Family names embed the arrival process (one exposition file carries
    every process without duplicate-family TYPE rows); histograms merge
    the streaming count vectors directly — no re-binning.
    """
    p = f"{prefix}_{process}"
    labels = {"process": process}
    reg.counter(f"{p}_completed_total", "rows completed",
                labels).inc(stats.completed)
    reg.counter(f"{p}_dropped_total", "rows dropped by admission control",
                labels).inc(stats.dropped)
    reg.counter(f"{p}_offered_total", "rows offered",
                labels).inc(stats.generated_rows)
    ttfe = stats.time_to_first_exit
    if not math.isnan(ttfe):
        reg.gauge(f"{p}_time_to_first_exit_seconds",
                  "first completion minus first submit", labels).set(ttfe)
    h = reg.histogram(f"{p}_latency_seconds", "end-to-end request latency",
                      labels, spec=stats.hist_spec)
    h.merge_from(stats.latency_counts, sum_=stats.latency_sum)
    for name in SEGMENTS:
        base = name[:-2] if name.endswith("_s") else name
        hs = reg.histogram(f"{p}_segment_{base}_seconds",
                           f"critical-path segment: {base}", labels,
                           spec=stats.hist_spec)
        hs.merge_from(stats.segment_counts[name],
                      sum_=stats.segment_sums[name])
    return reg


def perfetto_counter_events(stats) -> List[Dict]:
    """ServeStats flight-recorder stream → Perfetto counter-track events
    (the serve-side twin of the sim's state counters)."""
    sysbuf = stats.state_records
    stage = stats.stage_state
    if not sysbuf.shape[0]:
        return []
    sdec = decode_state(state=stage if stage.shape[0] else None, sys=sysbuf)
    return state_counter_events(sdec)
