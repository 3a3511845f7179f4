"""`repro_torch.obs` — the SLO observatory (DESIGN.md §14); port of
``repro.obs``.

The metrics core of the serve path: fixed-width, log-bucketed,
**mergeable** latency histograms (:mod:`~repro_torch.obs.hist` — integer
fills on any device, exact shard merges), host-side counter/gauge/histogram
registries (:mod:`~repro_torch.obs.registry`), Prometheus text
exposition with a strict round-trip parser (:mod:`~repro_torch.obs.prom`),
and the timing spans and device counters the port's layers open while
tracing is on (:mod:`~repro_torch.obs.spans`, off by default).

The open-loop load generator lives in :mod:`repro_torch.obs.loadgen` and
the SLO report builder in :mod:`repro_torch.obs.slo`; both import the
serve engine, which itself imports this package's leaf modules — so
neither is imported here (import them explicitly; keeping the package
root a leaf breaks the cycle).
"""
from __future__ import annotations

import os
import platform

from repro_torch.obs.hist import (DEFAULT_LATENCY_HIST, SLO_QS, HistSpec,
                                  edges, empty, empty_np, fill, fill_np,
                                  merge, q_label, quantile, summary)
from repro_torch.obs.registry import Counter, Gauge, Histogram, Registry
from repro_torch.obs import spans

__all__ = ["HistSpec", "DEFAULT_LATENCY_HIST", "SLO_QS", "edges", "empty",
           "empty_np", "fill", "fill_np", "merge", "quantile", "summary",
           "q_label", "Counter", "Gauge", "Histogram", "Registry",
           "host_class", "spans"]


def host_class() -> str:
    """Coarse machine-class identifier for perf-profile comparability
    (DESIGN.md §14.5): OS, ISA, and logical core count.  Override with
    ``REPRO_HOST_CLASS`` for fleets whose hardware labels don't reduce to
    these fields.
    """
    override = os.environ.get("REPRO_HOST_CLASS")
    if override:
        return override
    cores = os.cpu_count() or 0
    return (f"{platform.system().lower()}-{platform.machine().lower()}"
            f"-c{cores}")
