"""Counter / gauge / histogram registry (DESIGN.md §14.1); a copy of
``repro/obs/registry.py`` over the port's ``hist``.

A :class:`Registry` is an ordered, name-keyed collection of metric
instruments that the load generator and serve path fill as they run and
the exporters read when they report — the host-side complement of the
count vectors in :mod:`repro_torch.obs.hist`:

  * :class:`Counter` — monotone float total (completions, drops, bytes);
  * :class:`Gauge`   — last-write-wins level (queue depth, in-flight);
  * :class:`Histogram` — a :class:`~repro_torch.obs.hist.HistSpec` count vector
    plus a running sum, filled via ``observe`` / ``observe_many`` and
    mergeable across shards with ``merge_from``.

``get-or-create`` semantics (``registry.counter(name)`` twice returns the
same instrument) keep call sites free of plumbing; re-registering a name
as a different kind is an error, not a silent shadow.  Rendering to
Prometheus exposition text lives in :mod:`repro_torch.obs.prom`.
"""
from __future__ import annotations

from typing import Dict, Iterable, Mapping, Optional, Sequence

import numpy as np

from repro_torch.obs import hist as _hist


class Metric:
    kind = "untyped"

    def __init__(self, name: str, help: str = "",
                 labels: Optional[Mapping[str, str]] = None):
        self.name = name
        self.help = help
        self.labels: Dict[str, str] = dict(labels or {})


class Counter(Metric):
    kind = "counter"

    def __init__(self, name: str, help: str = "", labels=None):
        super().__init__(name, help, labels)
        self.value = 0.0

    def inc(self, amount: float = 1.0) -> None:
        if amount < 0:
            raise ValueError(f"counter {self.name}: negative inc {amount}")
        self.value += float(amount)


class Gauge(Metric):
    kind = "gauge"

    def __init__(self, name: str, help: str = "", labels=None):
        super().__init__(name, help, labels)
        self.value = 0.0

    def set(self, value: float) -> None:
        self.value = float(value)

    def inc(self, amount: float = 1.0) -> None:
        self.value += float(amount)

    def dec(self, amount: float = 1.0) -> None:
        self.value -= float(amount)


class Histogram(Metric):
    kind = "histogram"

    def __init__(self, name: str, help: str = "", labels=None,
                 spec: _hist.HistSpec = _hist.DEFAULT_LATENCY_HIST):
        super().__init__(name, help, labels)
        self.spec = spec
        self.counts = _hist.empty_np(spec)
        self.sum = 0.0

    def observe(self, value: float, weight: int = 1) -> None:
        _hist.fill_np(self.spec, self.counts, [value], [weight])
        self.sum += float(value) * int(weight)

    def observe_many(self, values, weights=None) -> None:
        x = np.asarray(values, np.float64).ravel()
        if weights is None:
            _hist.fill_np(self.spec, self.counts, x)
            self.sum += float(x.sum())
        else:
            w = np.broadcast_to(np.asarray(weights, np.int64).ravel(),
                                x.shape)
            _hist.fill_np(self.spec, self.counts, x, w)
            self.sum += float((x * w).sum())

    def merge_from(self, counts, sum_: float = 0.0) -> None:
        """Fold a shard's count vector (e.g. an in-scan fill) in."""
        self.counts = _hist.merge(self.counts, counts)
        self.sum += float(sum_)

    @property
    def count(self) -> int:
        return _hist.total(self.counts)

    def quantile(self, q: float) -> Optional[float]:
        return _hist.quantile(self.spec, self.counts, q)

    def summary(self, qs: Sequence[float] = _hist.SLO_QS) -> Dict:
        return _hist.summary(self.spec, self.counts, qs)


class Registry:
    """Ordered name → instrument map with get-or-create accessors."""

    def __init__(self):
        self._metrics: Dict[str, Metric] = {}

    def _get_or_create(self, cls, name: str, help: str, labels, **kw):
        m = self._metrics.get(name)
        if m is not None:
            if not isinstance(m, cls):
                raise TypeError(f"metric {name!r} already registered as "
                                f"{m.kind}, requested {cls.kind}")
            return m
        m = cls(name, help, labels, **kw)
        self._metrics[name] = m
        return m

    def counter(self, name: str, help: str = "", labels=None) -> Counter:
        return self._get_or_create(Counter, name, help, labels)

    def gauge(self, name: str, help: str = "", labels=None) -> Gauge:
        return self._get_or_create(Gauge, name, help, labels)

    def histogram(self, name: str, help: str = "", labels=None,
                  spec: _hist.HistSpec = _hist.DEFAULT_LATENCY_HIST
                  ) -> Histogram:
        return self._get_or_create(Histogram, name, help, labels, spec=spec)

    def collect(self) -> Iterable[Metric]:
        return list(self._metrics.values())

    def __contains__(self, name: str) -> bool:
        return name in self._metrics

    def __getitem__(self, name: str) -> Metric:
        return self._metrics[name]

    def to_prometheus(self) -> str:
        from repro_torch.obs import prom
        return prom.render(self)
