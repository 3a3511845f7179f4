"""Sweep-result aggregation into the paper's performance indices
(DESIGN.md §8.4) and the JSON emitter; port of ``repro/fleet/report.py``.

``point_indices`` turns one point's per-run metric arrays into the summary
the paper reports: mean ± 95 % CI per metric, the run-mean latency
quantiles, Jain fairness and energy per task (J/task).
``write_bench_json`` merges a named section into a JSON file atomically, so
independent producers accumulate into one machine-readable file; the port
writes to the path its caller gives, never to the reference's
``benchmarks/artifacts/BENCH_fleet.json``.

A traced point (``trace_*`` leaves, ``repro_torch.trace``) gains the
reference's traced sections: task-level indices, hop-resolved indices, the
critical-path ``latency_segments`` and the flight recorder's state indices.
"""
from __future__ import annotations

import json
import os
from typing import Dict, Mapping, Optional, Sequence

import numpy as np

from repro_torch.trace import (decode, decode_hops, decode_state,
                               hop_indices, quantile_summary, segment_indices,
                               state_indices, trace_indices)
from repro_torch.trace.aggregate import QS as LATENCY_QS


def ci95(x) -> tuple:
    """(mean, 95 % CI half-width) of a 1-D sample (paper: 50 runs, 95 % CI)."""
    x = np.asarray(x, np.float64)
    m = x.mean()
    half = 1.96 * x.std(ddof=1) / np.sqrt(len(x)) if len(x) > 1 else 0.0
    return m, half


def latency_cdf(lat_s, qs: Sequence[float] = LATENCY_QS) -> Dict[str, float]:
    """Empirical latency quantiles (seconds) of a 1-D latency sample."""
    return quantile_summary(lat_s, qs)


def point_indices(metrics: Mapping[str, np.ndarray],
                  per_task_latency_s=None,
                  tick_s: Optional[float] = None,
                  tx_power_dbm: Optional[float] = None,
                  cfg=None) -> Dict:
    """Paper performance indices for one sweep point's per-run metrics.

    ``metrics["avg_latency_s"]`` holds one *mean* latency per Monte-Carlo
    run, so its quantiles describe the distribution of run means — emitted
    as ``run_mean_latency_quantiles_s`` (Fig. 4a's CDF is per-*task*).
    The true ``task_latency_cdf_s`` comes from the point's TaskRecords when
    it ran traced (``SwarmConfig.trace_capacity > 0``), or from an
    explicit pooled ``per_task_latency_s`` sample (which wins when both
    are present).  A point that also captured the hop stream
    (``trace_hop_capacity > 0``) additionally gains the hop-resolved
    indices (per-hop transfer-time/link-bits quantiles, queue-wait vs
    in-flight decomposition — ``tick_s`` converts stall ticks to wall
    time — and, with ``tx_power_dbm``, the airtime-J energy attribution
    per hop and per link; see ``repro_torch.trace.aggregate.hop_indices``).

    ``cfg`` (the point's ``SwarmConfig``) additionally enables the
    critical-path attribution of a traced point: ``latency_segments`` —
    per-task compute / queue-wait / airtime / stall quantiles and shares
    whose per-task sums reconcile exactly with ``latency_s``
    (``repro_torch.trace.critical``, DESIGN.md §14.4; the compute rate
    estimate is ``task_gflops_total / task_layers`` over
    ``capability_mean``).
    """
    out = {}
    for k, v in metrics.items():
        if k.startswith("_") or k.startswith("trace_"):
            continue     # wall-time / record buffers: not per-run scalars
        mean, half = ci95(v)
        out[k] = {"mean": float(mean), "ci95": float(half)}
    if "avg_latency_s" in metrics:
        out["run_mean_latency_quantiles_s"] = latency_cdf(
            metrics["avg_latency_s"])
    dec = hdec = None
    if "trace_records" in metrics:
        # per-task telemetry captured in the epoch loop: the true
        # task-level indices, pooled over the point's Monte-Carlo runs
        dec = decode(metrics["trace_records"],
                     metrics.get("trace_overflow"))
        out.update(trace_indices(dec))
    if "trace_hops" in metrics:
        hdec = decode_hops(metrics["trace_hops"],
                           metrics.get("trace_hop_overflow"))
        out.update(hop_indices(hdec, tick_s=tick_s,
                               tx_power_dbm=tx_power_dbm))
    if dec is not None and cfg is not None:
        layers = max(int(getattr(cfg, "task_layers", 0)), 1)
        out["latency_segments"] = segment_indices(
            dec, hdec, tick_s=tick_s,
            gflops_per_layer=float(
                getattr(cfg, "task_gflops_total", 0.0)) / layers,
            capability_gflops=getattr(cfg, "capability_mean", None))
    if "trace_state" in metrics or "trace_state_sys" in metrics:
        # the flight recorder (trace_state_every > 0): φ-convergence,
        # queue-depth heatmap, energy-drain and imbalance indices
        out.update(state_indices(decode_state(
            metrics.get("trace_state"), metrics.get("trace_state_sys"),
            metrics.get("trace_state_epochs"))))
    if per_task_latency_s is not None and len(per_task_latency_s):
        out["task_latency_cdf_s"] = latency_cdf(per_task_latency_s)
    for k in ("jain_fairness", "energy_per_task_j"):
        if k in metrics:
            out[k]["min"] = float(np.min(metrics[k]))
            out[k]["max"] = float(np.max(metrics[k]))
    return out


def build_report(results: Mapping[str, Mapping[str, np.ndarray]],
                 meta: Optional[Dict] = None,
                 per_task_latency_s: Optional[Mapping] = None,
                 tick_s=None, tx_power_dbm=None, cfg=None) -> Dict:
    """``{point label: metrics}`` (executor output) → JSON-ready section.

    ``per_task_latency_s`` optionally maps point labels to pooled per-task
    latency samples (for the true Fig. 4a CDF); points without an entry
    just omit ``task_latency_cdf_s``.  ``tick_s`` feeds the hop stream's
    queue-wait/in-flight wall-time decomposition and ``tx_power_dbm`` its
    airtime-J energy attribution: each is either one float for the whole
    sweep or a ``{point label: value}`` mapping (both are ordinary config
    fields, so a sweep axis may vary them per point).  ``cfg`` — one
    ``SwarmConfig`` or a ``{point label: SwarmConfig}`` mapping — enables
    the per-point ``latency_segments`` critical-path attribution of
    traced points (DESIGN.md §14.4).  Output is deterministic in the
    inputs either way.
    """
    lat = per_task_latency_s or {}

    def per_label(v):
        return (v if isinstance(v, Mapping) or v is None
                else {label: v for label in results})

    tick = per_label(tick_s)
    txp = per_label(tx_power_dbm)
    cfgs = (cfg if isinstance(cfg, Mapping) or cfg is None
            else {label: cfg for label in results})
    return {
        "meta": dict(meta or {}),
        "points": {label: point_indices(
            m, lat.get(label), tick_s=(tick or {}).get(label),
            tx_power_dbm=(txp or {}).get(label),
            cfg=(cfgs or {}).get(label))
            for label, m in results.items()},
    }


def load_bench_json(path: str) -> Dict:
    if not os.path.exists(path):
        return {}
    with open(path) as f:
        return json.load(f)


def write_bench_json(path: str, section: str, payload) -> str:
    """Merge ``payload`` under ``doc[section]`` of the JSON file at
    ``path`` and rewrite it atomically.

    Re-running one producer never perturbs the other sections, and the
    output is deterministic in the inputs (no timestamps) — an interrupted-
    then-resumed sweep emits a byte-identical file to an uninterrupted one.
    """
    doc = load_bench_json(path)
    doc[section] = payload
    d = os.path.dirname(path)
    if d:
        os.makedirs(d, exist_ok=True)
    tmp = path + ".tmp"
    with open(tmp, "w") as f:
        json.dump(doc, f, indent=1, sort_keys=True)
    os.replace(tmp, path)
    return path
