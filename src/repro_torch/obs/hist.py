"""Fixed-width, log-bucketed, mergeable latency histograms: the numpy half
of ``repro/obs/hist.py`` (DESIGN.md §14.1), a copy, since that module
imports jax.

A histogram is a ``[buckets + 2]`` integer count vector over a static
log-spaced edge grid (:class:`HistSpec`): slot 0 is the underflow bin
(``x < lo``, zeros included), slots ``1..buckets`` the finite log buckets,
and the last slot the overflow bin (``x >= hi``).  ``fill_np`` uses the
float32 edge grid of the reference, so the two packages put a value in the
same bucket.  Quantiles are the *upper edge* of the bucket where the
cumulative count crosses the rank.
"""
from __future__ import annotations

import math
from dataclasses import dataclass
from functools import lru_cache
from typing import Dict, Optional, Sequence

import numpy as np

# p50 / p99 / p999 — the SLO grid; summary() labels 0.999 "p999"
SLO_QS = (0.5, 0.99, 0.999)


@dataclass(frozen=True)
class HistSpec:
    """Static histogram geometry: ``buckets`` log-spaced bins over
    ``[lo, hi)`` plus an underflow and an overflow bin."""
    lo: float = 1e-4
    hi: float = 1e4
    buckets: int = 384

    @property
    def num_bins(self) -> int:
        return self.buckets + 2


# the default spec all latency surfaces share: 0.1 ms .. 10 000 s
DEFAULT_LATENCY_HIST = HistSpec()


@lru_cache(maxsize=None)
def edges(spec: HistSpec) -> np.ndarray:
    """``[buckets + 1]`` float32 bin edges."""
    e = np.geomspace(spec.lo, spec.hi, spec.buckets + 1)
    return e.astype(np.float32)


@lru_cache(maxsize=None)
def upper_edges(spec: HistSpec) -> np.ndarray:
    """Per-bin conservative upper bound (float64; overflow bin = +inf)."""
    e = edges(spec).astype(np.float64)
    return np.concatenate([e[:1], e[1:], [np.inf]])


def empty_np(spec: HistSpec) -> np.ndarray:
    """Host-side zero counts (int64: a long-lived accumulator)."""
    return np.zeros((spec.num_bins,), np.int64)


def fill_np(spec: HistSpec, counts: np.ndarray, values,
            weights=None) -> np.ndarray:
    """In-place host fill over the float32 edge grid."""
    x = np.asarray(values, np.float32).ravel()
    idx = np.searchsorted(edges(spec), x, side="right")
    if weights is None:
        np.add.at(counts, idx, 1)
    else:
        w = np.broadcast_to(np.asarray(weights, counts.dtype).ravel(),
                            idx.shape)
        np.add.at(counts, idx, w)
    return counts


def quantile(spec: HistSpec, counts, q: float) -> Optional[float]:
    """Conservative quantile: the upper edge of the bucket where the CDF
    crosses ``q`` (``+inf`` in the overflow bin, ``None`` when empty)."""
    c = np.asarray(counts, np.int64)
    n = c.sum()
    if n == 0:
        return None
    k = int(np.searchsorted(np.cumsum(c), q * n, side="left"))
    return float(upper_edges(spec)[k])


def q_label(q: float) -> str:
    """0.5 → "p50", 0.99 → "p99", 0.999 → "p999"."""
    return "p" + format(q * 100, "g").replace(".", "")


def summary(spec: HistSpec, counts, qs: Sequence[float] = SLO_QS
            ) -> Dict[str, Optional[float]]:
    """JSON-ready quantile summary of one count vector (a quantile in the
    overflow bin comes back ``None``; the overflow count is reported)."""
    c = np.asarray(counts, np.int64)
    out: Dict[str, Optional[float]] = {
        "count": int(c.sum()),
        "underflow": int(c[0]),
        "overflow": int(c[-1]),
    }
    for q in qs:
        v = quantile(spec, c, q)
        out[q_label(q)] = (None if v is None or math.isinf(v) else v)
    return out
