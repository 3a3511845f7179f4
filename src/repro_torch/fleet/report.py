"""Sweep-result aggregation into the paper's performance indices
(DESIGN.md §8.4) and the JSON emitter; port of ``repro/fleet/report.py``.

``point_indices`` turns one point's per-run metric arrays into the summary
the paper reports: mean ± 95 % CI per metric, the run-mean latency
quantiles, Jain fairness and energy per task (J/task).
``write_bench_json`` merges a named section into a JSON file atomically, so
independent producers accumulate into one machine-readable file; the port
writes to the path its caller gives, never to the reference's
``benchmarks/artifacts/BENCH_fleet.json``.

The reference's traced sections (task, hop and state-stream indices, the
critical-path attribution) need the ``trace`` slice, which the port does
not have yet; the simulator refuses traced configs, so no such metric
reaches here.
"""
from __future__ import annotations

import json
import os
from typing import Dict, Mapping, Optional, Sequence

import numpy as np

from repro_torch.trace.aggregate import QS as LATENCY_QS
from repro_torch.trace.aggregate import quantile_summary


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
                  per_task_latency_s=None) -> Dict:
    """Paper performance indices for one sweep point's per-run metrics.

    ``metrics["avg_latency_s"]`` holds one *mean* latency per Monte-Carlo
    run, so its quantiles describe the distribution of run means —
    ``run_mean_latency_quantiles_s``.  An explicit pooled
    ``per_task_latency_s`` sample adds ``task_latency_cdf_s``.
    """
    traced = sorted(k for k in metrics if k.startswith("trace_"))
    if traced:
        raise NotImplementedError(
            f"trace leaves {traced}: the trace indices are not ported yet "
            f"(ROADMAP.md)")
    out = {}
    for k, v in metrics.items():
        if k.startswith("_"):
            continue     # wall-time spans: not per-run scalars
        mean, half = ci95(v)
        out[k] = {"mean": float(mean), "ci95": float(half)}
    if "avg_latency_s" in metrics:
        out["run_mean_latency_quantiles_s"] = latency_cdf(
            metrics["avg_latency_s"])
    if per_task_latency_s is not None and len(per_task_latency_s):
        out["task_latency_cdf_s"] = latency_cdf(per_task_latency_s)
    for k in ("jain_fairness", "energy_per_task_j"):
        if k in metrics:
            out[k]["min"] = float(np.min(metrics[k]))
            out[k]["max"] = float(np.max(metrics[k]))
    return out


def build_report(results: Mapping[str, Mapping[str, np.ndarray]],
                 meta: Optional[Dict] = None,
                 per_task_latency_s: Optional[Mapping] = None) -> Dict:
    """``{point label: metrics}`` (executor output) → JSON-ready section.

    ``per_task_latency_s`` optionally maps point labels to pooled per-task
    latency samples; points without an entry omit ``task_latency_cdf_s``.
    Output is deterministic in the inputs.
    """
    lat = per_task_latency_s or {}
    return {
        "meta": dict(meta or {}),
        "points": {label: point_indices(m, lat.get(label))
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
