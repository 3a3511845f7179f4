"""Fixed-width, log-bucketed, mergeable latency histograms (DESIGN.md
§14.1); port of ``repro/obs/hist.py``.

A histogram is a ``[buckets + 2]`` integer count vector over a static
log-spaced edge grid (:class:`HistSpec`): slot 0 is the underflow bin
(``x < lo``, zeros included), slots ``1..buckets`` the finite log buckets,
and the last slot the overflow bin (``x >= hi``).  Every fill uses the
reference's float32 edge grid and ``searchsorted(side="right")``: the
torch ``fill`` (any device) and the host ``fill_np`` put a value in the
same bucket as each other and as the reference.  The counts are integers,
so a fill's scatter-add is exact in any order (no float atomics) and
``merge`` of shards equals one whole-stream fill bit for bit.  Quantiles
are the *upper edge* of the bucket where the cumulative count crosses the
rank, within one bucket of the exact sample quantile.
"""
from __future__ import annotations

import math
from dataclasses import dataclass
from functools import lru_cache
from typing import Dict, Optional, Sequence

import numpy as np
import torch

from repro_torch.device import resolve_device

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

    @property
    def growth(self) -> float:
        """Multiplicative bucket width (relative quantile resolution)."""
        return (self.hi / self.lo) ** (1.0 / self.buckets)


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


@lru_cache(maxsize=None)
def lower_edges(spec: HistSpec) -> np.ndarray:
    """Per-bin lower bound (underflow bin = 0)."""
    e = edges(spec).astype(np.float64)
    return np.concatenate([[0.0], e[:-1], [e[-1]]])


def empty(spec: HistSpec, device=None) -> torch.Tensor:
    """Device-side zero counts (int32, as the reference's in-scan carries),
    on the card unless ``device`` says otherwise."""
    return torch.zeros((spec.num_bins,), dtype=torch.int32,
                       device=resolve_device(device))


def empty_np(spec: HistSpec) -> np.ndarray:
    """Host-side zero counts (int64: a long-lived accumulator)."""
    return np.zeros((spec.num_bins,), np.int64)


def bucket_of(spec: HistSpec, values: torch.Tensor) -> torch.Tensor:
    """Bin index (int64) of each value, on the values' device: the float32
    grid, ``searchsorted(side="right")``."""
    x = values.to(torch.float32).reshape(-1)
    e = torch.from_numpy(edges(spec)).to(x.device)
    return torch.searchsorted(e, x, right=True)


def fill(spec: HistSpec, counts: torch.Tensor, values: torch.Tensor,
         weights=None) -> torch.Tensor:
    """Add ``values`` (optionally ``weights``-weighted) into ``counts``;
    returns the new counts (``counts`` itself is not written).  An integer
    scatter-add: the same counts whatever order the device adds in."""
    idx = bucket_of(spec, values)
    if weights is None:
        w = torch.ones(idx.shape, dtype=counts.dtype, device=idx.device)
    else:
        w = torch.as_tensor(weights, device=idx.device).to(
            counts.dtype).reshape(-1).expand(idx.shape)
    return counts.index_add(0, idx, w)


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


def _np(counts) -> np.ndarray:
    if torch.is_tensor(counts):
        counts = counts.detach().cpu().numpy()
    return np.asarray(counts, np.int64)


def merge(*counts) -> np.ndarray:
    """Sum count vectors (int64): integer addition, so any shard, chunk or
    resume order gives the histogram of one whole-stream fill."""
    out = np.zeros_like(_np(counts[0]))
    for c in counts:
        out = out + _np(c)
    return out


def total(counts) -> int:
    return int(np.sum(_np(counts)))


def quantile(spec: HistSpec, counts, q: float) -> Optional[float]:
    """Conservative quantile: the upper edge of the bucket where the CDF
    crosses ``q`` (``+inf`` in the overflow bin, ``None`` when empty)."""
    c = _np(counts)
    n = c.sum()
    if n == 0:
        return None
    k = int(np.searchsorted(np.cumsum(c), q * n, side="left"))
    return float(upper_edges(spec)[k])


def quantile_bucket(spec: HistSpec, counts, q: float) -> Optional[int]:
    """Bin index the quantile falls in (for one-bucket-accuracy checks)."""
    c = _np(counts)
    n = c.sum()
    if n == 0:
        return None
    return int(np.searchsorted(np.cumsum(c), q * n, side="left"))


def q_label(q: float) -> str:
    """0.5 → "p50", 0.99 → "p99", 0.999 → "p999"."""
    return "p" + format(q * 100, "g").replace(".", "")


def summary(spec: HistSpec, counts, qs: Sequence[float] = SLO_QS
            ) -> Dict[str, Optional[float]]:
    """JSON-ready quantile summary of one count vector (a quantile in the
    overflow bin comes back ``None``; the overflow count is reported)."""
    c = _np(counts)
    out: Dict[str, Optional[float]] = {
        "count": int(c.sum()),
        "underflow": int(c[0]),
        "overflow": int(c[-1]),
    }
    for q in qs:
        v = quantile(spec, c, q)
        out[q_label(q)] = (None if v is None or math.isinf(v) else v)
    return out
