"""Critical-path attribution (DESIGN.md §14.4), a copy of
``repro/trace/critical.py``: decompose each task's
end-to-end latency into **compute / queue-wait / airtime / fault-stall**
segments from the existing TaskRecord + HopRecord streams, so a latency
regression names the segment that moved instead of just the total.

The decomposition is *exact by construction* — the four segments of every
task sum to its recorded ``latency_s`` bit-for-bit:

  * in-flight time is the TaskRecord's ``tx_time_s`` (clipped into
    ``[0, latency]``), split into **airtime** and **stall** by the hop
    stream's global stall fraction (Σ stall_ticks·tick / Σ transfer time
    — HopRecords carry stalls per hop but re-seq per enqueue, so the
    task join is by fraction, not by row);
  * on-node time (latency − in-flight) is split into **compute** —
    the physics estimate ``layers · gflops_per_layer / capability``,
    clamped to the on-node budget — and **queue-wait**, the remainder.

Without a hop stream the stall segment is 0 (all in-flight time is
airtime); without a compute-rate estimate the compute segment absorbs the
whole on-node budget (queue-wait 0) — both degradations keep the sum
exact and the key set stable.

Kept free of ``repro_torch.fleet`` imports (``fleet.report`` calls in)
and of any executor or simulator imports (the serve engine's ``ServeStats``
imports :data:`SEGMENTS` for its streaming segment histograms).
"""
from __future__ import annotations

from typing import Dict, Mapping, Optional

import numpy as np

from repro_torch.trace.aggregate import quantile_summary

# the four latency segments, in report order; per task they sum exactly
# to latency_s
SEGMENTS = ("compute_s", "queue_wait_s", "airtime_s", "stall_s")


def hop_stall_fraction(hdec: Mapping, tick_s: float) -> float:
    """Fraction of total hop transfer time spent stalled (fault stalls +
    receiver-contention waits), from the decoded hop stream.

    This is the stream-wide ratio — HopRecord seqs are re-assigned at
    every enqueue, so per-task hop joins are not well-defined; the global
    fraction is the unbiased split of each task's ``tx_time_s``.
    """
    t = np.asarray(hdec["transfer_time_s"], np.float64)
    if t.size == 0:
        return 0.0
    stall = np.asarray(hdec["stall_ticks"], np.float64) * float(tick_s)
    denom = float(t.sum())
    if denom <= 0.0:
        return 0.0
    return float(np.clip(stall.sum() / denom, 0.0, 1.0))


def decompose(dec: Mapping, hdec: Optional[Mapping] = None, *,
              tick_s: Optional[float] = None,
              gflops_per_layer: Optional[float] = None,
              capability_gflops: Optional[float] = None
              ) -> Dict[str, np.ndarray]:
    """Decoded TaskRecords → per-task segment arrays (completed tasks
    only), plus the matching ``latency_s`` column.

    Returns ``{"latency_s", "compute_s", "queue_wait_s", "airtime_s",
    "stall_s"}``; every row satisfies ``latency == Σ segments`` exactly
    (the remainders are computed by subtraction, never re-derived).
    """
    done = ~np.asarray(dec["is_dropped"], bool)
    lat = np.asarray(dec["latency_s"], np.float64)[done]
    lat = np.maximum(lat, 0.0)
    tx = np.clip(np.asarray(dec["tx_time_s"], np.float64)[done], 0.0, lat)

    frac = (hop_stall_fraction(hdec, tick_s)
            if hdec is not None and tick_s is not None else 0.0)
    stall = tx * frac
    airtime = tx - stall

    on_node = lat - tx
    if gflops_per_layer is not None and capability_gflops:
        layers = np.asarray(dec["layers"], np.float64)[done]
        est = layers * float(gflops_per_layer) / float(capability_gflops)
        compute = np.minimum(est, on_node)
    else:
        compute = on_node
    queue_wait = on_node - compute

    return {"latency_s": lat, "compute_s": compute,
            "queue_wait_s": queue_wait, "airtime_s": airtime,
            "stall_s": stall}


def segment_indices(dec: Mapping, hdec: Optional[Mapping] = None, *,
                    tick_s: Optional[float] = None,
                    gflops_per_layer: Optional[float] = None,
                    capability_gflops: Optional[float] = None) -> Dict:
    """Per-segment quantile summaries + mean shares, JSON-ready.

    Stable key set: an all-drop trace emits the same keys with ``None``
    quantiles and zero shares.  ``reconcile_max_err_s`` is the largest
    per-task |latency − Σ segments| — 0.0 up to float rounding, the
    acceptance invariant BENCH carries explicitly.
    """
    seg = decompose(dec, hdec, tick_s=tick_s,
                    gflops_per_layer=gflops_per_layer,
                    capability_gflops=capability_gflops)
    lat = seg["latency_s"]
    total = float(lat.sum())
    out: Dict = {"task_count": int(lat.size)}
    resid = lat.copy()
    for name in SEGMENTS:
        x = seg[name]
        resid = resid - x
        out[f"{name}_quantiles"] = quantile_summary(x)
        out[f"{name}_share"] = (float(x.sum() / total) if total > 0.0
                                else 0.0)
    out["reconcile_max_err_s"] = (float(np.abs(resid).max())
                                  if lat.size else 0.0)
    return out


def attribute(baseline: Mapping, current: Mapping,
              quantile: str = "p50") -> Optional[Dict]:
    """Name the segment that moved between two :func:`segment_indices`
    payloads — the perf-gate attribution step (DESIGN.md §14.5).

    Compares each segment's ``quantile`` entry and returns the largest
    absolute increase as ``{"segment", "baseline_s", "current_s",
    "delta_s", "ratio"}`` (``ratio`` None when the baseline is 0), or
    ``None`` when no segment is comparable or none regressed.
    """
    worst = None
    for name in SEGMENTS:
        b = (baseline.get(f"{name}_quantiles") or {}).get(quantile)
        c = (current.get(f"{name}_quantiles") or {}).get(quantile)
        if b is None or c is None:
            continue
        delta = float(c) - float(b)
        if worst is None or delta > worst["delta_s"]:
            worst = {"segment": name, "baseline_s": float(b),
                     "current_s": float(c), "delta_s": delta,
                     "ratio": (float(c) / float(b) if b > 0.0 else None)}
    if worst is None or worst["delta_s"] <= 0.0:
        return None
    return worst
