"""Task-, hop- and state-level aggregates (DESIGN.md §10.3, §10.5, §12),
a copy of ``repro/trace/aggregate.py`` (numpy only; the reference's
package imports jax): the paper's evaluation currency from decoded records
rather than run means.  Per-task latency distributions, Jain fairness over
task latencies, hop and exit histograms, energy per task, the
hop-resolved transfer decomposition (per-hop transfer time, per-link bits
and airtime joules, queue-wait against in-flight), and the flight
recorder's φ-convergence, queue-depth and energy-drain indices.

Every index builder emits a *stable key set*: an all-drop (or hop-free)
trace gives the same JSON keys as a populated one, with empty histograms
and ``None`` quantiles.  Free of ``repro_torch.fleet`` imports so
``fleet.report`` can call in without a cycle.
"""
from __future__ import annotations

from typing import Dict, Mapping, Optional, Sequence

import numpy as np

QS = (0.05, 0.25, 0.5, 0.75, 0.9, 0.95, 0.99)

# φ-convergence threshold: epochs_to_eps is the first sampled epoch where
# the run-mean relative residual RMS(φ_t − φ_final)/RMS(φ_final) ≤ this
PHI_EPS = 0.05
# queue-depth heatmaps are downsampled to at most this many epoch rows
# before landing in BENCH (indent=1 JSON puts every number on its own
# line); the kept epochs are reported explicitly, never silently
HEATMAP_MAX_EPOCHS = 128


def quantile_summary(x, qs: Sequence[float] = QS) -> Optional[Dict[str, float]]:
    """``{"p05": ..., "p50": ..., ...}`` of a 1-D sample; ``None`` when the
    sample is empty (a stable null beats a key that comes and goes)."""
    x = np.asarray(x, np.float64)
    if x.size == 0:
        return None
    return {f"p{int(q * 100):02d}": float(np.quantile(x, q)) for q in qs}


def jain_fairness(x) -> float:
    """Jain index (Σx)² / (n Σx²) of a 1-D sample."""
    x = np.asarray(x, np.float64)
    if x.size == 0:
        return 0.0
    return float(x.sum() ** 2 / (x.size * np.square(x).sum() + 1e-12))


def int_histogram(col) -> Dict[str, int]:
    """Value → count histogram of an integral column, string-keyed for
    JSON (the one histogram implementation every surface shares)."""
    vals, counts = np.unique(np.asarray(col, np.int64), return_counts=True)
    return {str(int(v)): int(c) for v, c in zip(vals, counts, strict=True)}


def hop_histogram(dec: Mapping) -> Dict[str, int]:
    """Completed-task counts by number of forwarding hops."""
    return int_histogram(dec["hops"][~dec["is_dropped"]])


def exit_label_histogram(dec: Mapping) -> Dict[str, int]:
    """Task counts by exit label (0 full / 1 med / 2 high / 3 dropped)."""
    return int_histogram(dec["exit_label"])


def trace_indices(dec: Mapping) -> Dict:
    """Decoded TaskRecords → the JSON-ready task-level report section.

    Deterministic in the records, with a *stable schema*: an all-drop
    trace emits the same keys as a populated one (empty histograms, null
    quantiles), so the key set never varies across sweep points.
    """
    done = ~dec["is_dropped"]
    lat = dec["latency_s"][done]
    return {
        "task_count": int(done.sum()),
        "dropped_count": int(dec["is_dropped"].sum()),
        "trace_overflow": int(dec["overflow"]),
        "exit_label_histogram": exit_label_histogram(dec),
        "hop_histogram": hop_histogram(dec),
        "task_latency_cdf_s": quantile_summary(lat),
        "task_latency_jain": jain_fairness(lat) if lat.size else None,
        "energy_per_task_j_quantiles": quantile_summary(
            dec["energy_j"][done]),
        "tx_time_s_mean": (float(dec["tx_time_s"][done].mean())
                           if lat.size else None),
    }


def _round_list(x, nd: int = 6):
    return [round(float(v), nd) for v in np.asarray(x, np.float64).ravel()]


def state_indices(sdec: Mapping) -> Dict:
    """Decoded state stream → the JSON-ready flight-recorder section.

    Stable key set, like the task/hop builders: node-gauge indices are
    ``None`` when the decode lacks per-node buffers, system indices are
    ``None`` when it lacks sys columns (the serve engine emits either
    subset), and a fully-populated simulated point fills everything —
    φ-convergence curve + epochs-to-ε, queue-depth heatmap (run mean,
    ≤ :data:`HEATMAP_MAX_EPOCHS` epoch rows, kept epochs listed
    explicitly), energy-drain trajectory, and the peak/steady-state
    Jain imbalance of instantaneous queue depths.
    """
    epochs = np.asarray(sdec["epoch"], np.int64)
    S = int(epochs.size)
    out: Dict = {
        "state_sample_count": S,
        "state_runs": int(sdec.get("num_runs", 1)),
        "state_epochs": [int(e) for e in epochs],
        "state_nodes": None,
        "phi_eps": PHI_EPS,
        "phi_residual_curve": None,
        "phi_epochs_to_eps": None,
        "phi_spread_final": None,
        "queue_depth_heatmap": None,
        "queue_depth_heatmap_epochs": None,
        "queue_depth_mean_curve": None,
        "queue_depth_max_curve": None,
        "queue_jain_curve": None,
        "queue_jain_min": None,
        "queue_jain_final": None,
        "energy_drain_j_curve": None,
        "tasks_in_flight_curve": None,
        "completion_rate_final": None,
    }
    if "phi" in sdec and S:
        phi = np.asarray(sdec["phi"], np.float64)          # [R, S, M]
        out["state_nodes"] = int(phi.shape[2])
        # ‖φ_t − φ_∞‖: RMS over nodes of the residual vs the final sample,
        # averaged over runs (φ_∞ ≈ the last recorded sample of each run)
        resid = np.sqrt(np.mean((phi - phi[:, -1:, :]) ** 2, axis=2))
        curve = resid.mean(axis=0)                         # [S]
        out["phi_residual_curve"] = _round_list(curve)
        denom = np.sqrt(np.mean(phi[:, -1:, :] ** 2, axis=2)) + 1e-12
        rel = (resid / denom).mean(axis=0)
        hit = np.nonzero(rel <= PHI_EPS)[0]
        out["phi_epochs_to_eps"] = (int(epochs[hit[0]]) if hit.size
                                    else None)
        depth = np.asarray(sdec["queue_depth"], np.float64)  # [R, S, M]
        heat = depth.mean(axis=0)                            # [S, M]
        keep = np.unique(np.linspace(0, S - 1,
                                     min(S, HEATMAP_MAX_EPOCHS)).astype(int))
        out["queue_depth_heatmap"] = [_round_list(heat[i], 3) for i in keep]
        out["queue_depth_heatmap_epochs"] = [int(epochs[i]) for i in keep]
    if "queue_depth_mean" in sdec and S:
        qmean = np.asarray(sdec["queue_depth_mean"], np.float64)
        qmax = np.asarray(sdec["queue_depth_max"], np.float64)
        jain = np.asarray(sdec["queue_jain"], np.float64)
        out["queue_depth_mean_curve"] = _round_list(qmean.mean(axis=0), 3)
        out["queue_depth_max_curve"] = _round_list(qmax.mean(axis=0), 3)
        out["queue_jain_curve"] = _round_list(jain.mean(axis=0))
        out["queue_jain_min"] = round(float(jain.mean(axis=0).min()), 6)
        out["queue_jain_final"] = round(float(jain[:, -1].mean()), 6)
        out["energy_drain_j_curve"] = _round_list(
            np.asarray(sdec["energy_j"], np.float64).mean(axis=0))
        out["tasks_in_flight_curve"] = _round_list(
            np.asarray(sdec["tasks_in_flight"], np.float64).mean(axis=0), 3)
        done = np.asarray(sdec["completed"], np.float64)[:, -1]
        gen = np.asarray(sdec["generated"], np.float64)[:, -1]
        out["completion_rate_final"] = round(
            float((done / np.maximum(gen, 1.0)).mean()), 6)
        out["phi_spread_final"] = round(float(
            (np.asarray(sdec["phi_max"], np.float64)[:, -1]
             - np.asarray(sdec["phi_min"], np.float64)[:, -1]).mean()), 6)
    elif "phi" in sdec and S:
        phi = np.asarray(sdec["phi"], np.float64)
        out["phi_spread_final"] = round(float(
            (phi[:, -1, :].max(axis=1) - phi[:, -1, :].min(axis=1)).mean()),
            6)
    return out


def _link_sums(hdec: Mapping, weights) -> Dict[str, float]:
    """Sum ``weights`` per directed link, keyed ``"src->dst"``.

    Vectorized (a pooled point can hold millions of hop rows): groupby on
    the combined (src, dst) key via ``np.unique`` + weighted bincount.
    """
    src = np.asarray(hdec["src"], np.int64)
    dst = np.asarray(hdec["dst"], np.int64)
    if src.size == 0:
        return {}
    n = int(max(src.max(), dst.max())) + 1
    uniq, inv = np.unique(src * n + dst, return_inverse=True)
    sums = np.bincount(inv, weights=np.asarray(weights, np.float64))
    return {f"{int(k // n)}->{int(k % n)}": float(s)
            for k, s in zip(uniq, sums, strict=True)}


def link_bits(hdec: Mapping) -> Dict[str, float]:
    """Total bits shipped per directed link, keyed ``"src->dst"``."""
    return _link_sums(hdec, hdec["bits"])


def hop_airtime_s(hdec: Mapping, tick_s: float) -> np.ndarray:
    """Per-hop radio airtime: wall transfer time minus the stalled ticks
    (fault stalls + post-arrival contention waits), i.e. the ticks the
    sender's radio actually transmitted."""
    return (np.asarray(hdec["transfer_time_s"], np.float64)
            - np.asarray(hdec["stall_ticks"], np.float64) * float(tick_s))


def hop_energy_j(hdec: Mapping, tick_s: float,
                 tx_power_dbm: float) -> np.ndarray:
    """Per-hop transmit energy: airtime × linear transmit power.

    This is the HopRecord-side attribution of the simulator's ``e_tx``
    accumulator (which adds ``tx_w · tick`` per flying tick): when every
    transfer delivers before sim end, the sum over hops equals ``e_tx``
    exactly — the join the per-hop energy test pins.
    """
    tx_w = 10.0 ** (float(tx_power_dbm) / 10.0) * 1e-3
    return hop_airtime_s(hdec, tick_s) * tx_w


def link_energy_j(hdec: Mapping, tick_s: float,
                  tx_power_dbm: float) -> Dict[str, float]:
    """Total transmit joules per directed link, keyed ``"src->dst"`` —
    the airtime-J-per-link map the energy-budget analyses consume."""
    return _link_sums(hdec, hop_energy_j(hdec, tick_s, tx_power_dbm))


def hop_indices(hdec: Mapping, tick_s: Optional[float] = None,
                tx_power_dbm: Optional[float] = None) -> Dict:
    """Decoded HopRecords → the JSON-ready hop-resolved report section.

    ``tick_s`` converts ``stall_ticks`` into the queue-wait vs in-flight
    wall-time decomposition; ``tx_power_dbm`` additionally joins the hop
    stream with the transmit power into the per-hop / per-link airtime
    energy attribution (hop energy = (transfer time − stall ticks·tick) ×
    linear tx power).  Without them the corresponding entries are ``None``
    (keys stable either way).  ``hop_count`` counts *delivered* hops —
    transfers still in flight at sim end never wrote a record and are not
    overflow.
    """
    t = hdec["transfer_time_s"]
    stall = hdec["stall_ticks"]
    lb = link_bits(hdec)
    out: Dict = {
        "hop_count": int(t.size),
        "hop_overflow": int(hdec["overflow"]),
        "hop_transfer_time_s_quantiles": quantile_summary(t),
        "hop_bits_quantiles": quantile_summary(hdec["bits"]),
        "link_count": len(lb),
        "link_bits_quantiles": quantile_summary(list(lb.values())),
        "hop_stall_ticks_quantiles": quantile_summary(stall),
        "stalled_hop_count": int((stall > 0).sum()),
        "hop_boundary_layer_histogram": int_histogram(
            hdec["boundary_layer"]),
        "hop_queue_wait_s_quantiles": None,
        "hop_in_flight_s_quantiles": None,
        "hop_energy_j_quantiles": None,
        "link_energy_j_quantiles": None,
        "tx_airtime_total_s": None,
        "tx_energy_total_j": None,
    }
    if tick_s is not None and t.size:
        wait = stall.astype(np.float64) * float(tick_s)
        out["hop_queue_wait_s_quantiles"] = quantile_summary(wait)
        out["hop_in_flight_s_quantiles"] = quantile_summary(t - wait)
        out["tx_airtime_total_s"] = float(hop_airtime_s(hdec, tick_s).sum())
        if tx_power_dbm is not None:
            e = hop_energy_j(hdec, tick_s, tx_power_dbm)
            le = link_energy_j(hdec, tick_s, tx_power_dbm)
            out["hop_energy_j_quantiles"] = quantile_summary(e)
            out["link_energy_j_quantiles"] = quantile_summary(
                list(le.values()))
            out["tx_energy_total_j"] = float(e.sum())
    return out
