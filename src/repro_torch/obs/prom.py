"""Prometheus text exposition (DESIGN.md §14.3); a copy of
``repro/obs/prom.py``: render a :class:`repro_torch.obs.registry.Registry`
to the v0.0.4 text format, plus a strict parser that proves the
exposition round-trips.

Histograms render the standard cumulative form — ``<name>_bucket`` rows
with ``le`` upper-edge labels (finite edges from the
:class:`~repro_torch.obs.hist.HistSpec` grid, then ``le="+Inf"``), followed by
``<name>_sum`` and ``<name>_count`` — so any Prometheus scraper computes
the same quantiles the BENCH report does.
"""
from __future__ import annotations

import re
from typing import Dict, List, Tuple

import numpy as np

from repro_torch.obs import hist as _hist


def _fmt_labels(labels: Dict[str, str], extra: Tuple[str, str] = None) -> str:
    items = list(labels.items()) + ([extra] if extra else [])
    if not items:
        return ""
    body = ",".join(f'{k}="{_escape(v)}"' for k, v in items)
    return "{" + body + "}"


def _escape(v) -> str:
    return str(v).replace("\\", r"\\").replace('"', r'\"').replace(
        "\n", r"\n")


def _fmt_num(x: float) -> str:
    if np.isposinf(x):
        return "+Inf"
    return repr(float(x))


def render(registry) -> str:
    """Registry → Prometheus text exposition (ends with a newline)."""
    lines: List[str] = []
    for m in registry.collect():
        if m.help:
            lines.append(f"# HELP {m.name} {_escape(m.help)}")
        lines.append(f"# TYPE {m.name} {m.kind}")
        if m.kind in ("counter", "gauge"):
            lines.append(f"{m.name}{_fmt_labels(m.labels)} "
                         f"{_fmt_num(m.value)}")
        elif m.kind == "histogram":
            uppers = _hist.upper_edges(m.spec)
            cum = np.cumsum(np.asarray(m.counts, np.int64))
            # fold the underflow bin into the first finite bucket (its
            # upper edge is the grid's lo, a legal le value), keep the
            # rest of the grid, end on +Inf
            for k in range(1, m.spec.num_bins):
                le = _fmt_num(uppers[k])
                lines.append(
                    f"{m.name}_bucket"
                    f"{_fmt_labels(m.labels, ('le', le))} {int(cum[k])}")
            lines.append(f"{m.name}_sum{_fmt_labels(m.labels)} "
                         f"{_fmt_num(m.sum)}")
            lines.append(f"{m.name}_count{_fmt_labels(m.labels)} "
                         f"{int(cum[-1])}")
        else:
            raise ValueError(f"unknown metric kind {m.kind!r}")
    return "\n".join(lines) + "\n"


_SAMPLE = re.compile(
    r"^(?P<name>[a-zA-Z_:][a-zA-Z0-9_:]*)"
    r"(?P<labels>\{[^}]*\})?\s+(?P<value>\S+)$")
_LABEL = re.compile(r'([a-zA-Z_][a-zA-Z0-9_]*)="((?:[^"\\]|\\.)*)"')


def parse(text: str) -> Dict:
    """Strict parse of an exposition: ``{"types": {family: kind},
    "samples": [(name, labels, value)]}``.  Raises ``ValueError`` on any
    malformed line, and checks histogram invariants (bucket rows
    cumulative, ``+Inf`` bucket == ``_count``) — the CI validity check.
    """
    types: Dict[str, str] = {}
    samples: List[Tuple[str, Dict[str, str], float]] = []
    for lineno, line in enumerate(text.splitlines(), 1):
        if not line.strip():
            continue
        if line.startswith("# TYPE "):
            parts = line.split()
            if len(parts) != 4:
                raise ValueError(f"line {lineno}: malformed TYPE: {line!r}")
            types[parts[2]] = parts[3]
            continue
        if line.startswith("#"):
            continue
        m = _SAMPLE.match(line)
        if not m:
            raise ValueError(f"line {lineno}: malformed sample: {line!r}")
        labels = dict(_LABEL.findall(m.group("labels") or ""))
        raw = m.group("value")
        value = float("inf") if raw == "+Inf" else float(raw)
        samples.append((m.group("name"), labels, value))
    # histogram invariants
    for fam, kind in types.items():
        if kind != "histogram":
            continue
        buckets = [(float("inf") if s[1].get("le") == "+Inf"
                    else float(s[1]["le"]), s[2])
                   for s in samples if s[0] == f"{fam}_bucket"]
        if not buckets:
            raise ValueError(f"histogram {fam}: no bucket rows")
        buckets.sort(key=lambda t: t[0])
        counts = [c for _, c in buckets]
        if counts != sorted(counts):
            raise ValueError(f"histogram {fam}: buckets not cumulative")
        count_rows = [s[2] for s in samples if s[0] == f"{fam}_count"]
        if not count_rows or buckets[-1][1] != count_rows[0]:
            raise ValueError(f"histogram {fam}: +Inf bucket != _count")
    return {"types": types, "samples": samples}
