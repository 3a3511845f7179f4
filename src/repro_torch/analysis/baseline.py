"""Baseline / exemption file of the port's swarmlint
(``analysis_baseline_torch.toml``; a copy of ``repro/analysis/baseline.py``
with its own file name: the reference's ``analysis_baseline.toml`` names
``src/repro/`` sites and stays the reference's).

Two table arrays:

``[[allow]]`` — one deliberate finding, matched by (rule, file, symbol)::

    [[allow]]
    rule = "R001"
    file = "src/repro_torch/swarm/simulator.py"
    symbol = "_epoch:k_ch"
    reason = "sparse tick link rates redraw the decision stage's channel"

Line numbers are deliberately *not* part of the match, so baselines
survive unrelated edits; ``symbol`` is the rule's stable anchor (function-
qualified variable for R001, function qualname for R003, …).  Every entry
must carry a non-empty ``reason`` — entries without one are rejected at
load time, which is the enforcement half of the "baseline with
justification" workflow (DESIGN.md §13).

``[[digest_exempt]]`` — R002's table of deliberately digest-excluded
fields, ``field = "Class.field"`` (or ``"function.param"``) plus
``reason``.  R002 validates each entry against the live dataclass/function
and flags stale or shadowed entries, so the table cannot rot.

Parsing: ``tomllib`` when available (Python ≥ 3.11), else a strict
fallback reader for exactly this shape (table arrays of ``key = "string"``
pairs) — the file format is kept to that subset on purpose so the suite
has zero dependencies beyond the repo's own requirements.
"""
from __future__ import annotations

import dataclasses
import os
import re
from typing import Dict, List, Optional

from repro_torch.analysis.astutil import Finding

BASELINE_NAME = "analysis_baseline_torch.toml"

try:
    import tomllib as _toml
except ImportError:                                    # Python < 3.11
    _toml = None

_KV = re.compile(r'^([A-Za-z_][A-Za-z0-9_]*)\s*=\s*"((?:[^"\\]|\\.)*)"\s*$')


def _parse_subset(text: str) -> Dict[str, List[Dict[str, str]]]:
    """Fallback parser for the table-array-of-string-pairs TOML subset."""
    doc: Dict[str, List[Dict[str, str]]] = {}
    current: Optional[Dict[str, str]] = None
    for lineno, raw in enumerate(text.splitlines(), 1):
        line = raw.strip()
        if not line or line.startswith("#"):
            continue
        if line.startswith("[[") and line.endswith("]]"):
            name = line[2:-2].strip()
            current = {}
            doc.setdefault(name, []).append(current)
            continue
        m = _KV.match(line)
        if m and current is not None:
            current[m.group(1)] = (m.group(2)
                                   .replace('\\"', '"').replace("\\\\", "\\"))
            continue
        raise ValueError(
            f"{BASELINE_NAME}:{lineno}: unsupported syntax {line!r} "
            "(the baseline sticks to [[table]] arrays of key = \"string\")")
    return doc


@dataclasses.dataclass(frozen=True)
class Baseline:
    allows_: tuple     # of (rule, file, symbol)
    digest_exempt: Dict[str, str]      # field -> reason
    path: Optional[str] = None

    def allows(self, f: Finding) -> bool:
        return (f.rule, f.file, f.symbol) in self.allows_

    @property
    def count(self) -> int:
        return len(self.allows_)


def parse_baseline(text: str, path: Optional[str] = None) -> Baseline:
    doc = (_toml.loads(text) if _toml is not None else _parse_subset(text))
    allows = []
    for i, entry in enumerate(doc.get("allow", [])):
        missing = {"rule", "file", "symbol", "reason"} - set(entry)
        if missing:
            raise ValueError(
                f"[[allow]] entry {i} is missing {sorted(missing)}")
        if not str(entry["reason"]).strip():
            raise ValueError(
                f"[[allow]] entry {i} ({entry['rule']} {entry['symbol']}) "
                "has an empty reason — baselines must be justified")
        allows.append((entry["rule"], entry["file"], entry["symbol"]))
    exempt: Dict[str, str] = {}
    for i, entry in enumerate(doc.get("digest_exempt", [])):
        missing = {"field", "reason"} - set(entry)
        if missing:
            raise ValueError(
                f"[[digest_exempt]] entry {i} is missing {sorted(missing)}")
        if not str(entry["reason"]).strip():
            raise ValueError(
                f"[[digest_exempt]] entry {i} ({entry['field']}) has an "
                "empty reason — exemptions must be justified")
        exempt[entry["field"]] = entry["reason"]
    return Baseline(tuple(allows), exempt, path)


def load_baseline(root: str) -> Optional[Baseline]:
    path = os.path.join(root, BASELINE_NAME)
    if not os.path.isfile(path):
        return None
    with open(path, encoding="utf-8") as f:
        return parse_baseline(f.read(), path)


# ---------------------------------------------------------------------------
# pruning (``--prune-baseline``): dead [[allow]] entries mask regressions
# ---------------------------------------------------------------------------


def prune_baseline_text(text: str, live, rules_run) -> tuple:
    """Drop every ``[[allow]]`` block whose (rule, file, symbol) matches
    no live finding.  Returns ``(new_text, dropped)`` where ``dropped``
    is the list of removed triples.

    Only entries whose rule is in ``rules_run`` are candidates — an entry
    for a rule that did not execute this invocation (e.g. a J rule under
    ``--tier ast``) cannot be proven dead and is kept.  The rewrite is
    textual and scoped to the dropped blocks (first ``[[allow]]`` line
    through the last key line before the next table header), so comments
    and ``[[digest_exempt]]`` entries survive byte-for-byte.
    """
    lines = text.splitlines(keepends=True)
    # block spans: (start, end, triple) — end exclusive
    spans = []
    i = 0
    while i < len(lines):
        if lines[i].strip() == "[[allow]]":
            start = i
            entry = {}
            i += 1
            while i < len(lines):
                s = lines[i].strip()
                if s.startswith("[["):
                    break
                m = _KV.match(s)
                if m:
                    entry[m.group(1)] = m.group(2)
                i += 1
            # trim trailing blank/comment lines back out of the block so
            # the next block's leading comments aren't swallowed
            end = i
            while end > start + 1 and not _KV.match(lines[end - 1].strip()):
                end -= 1
            spans.append((start, end,
                          (entry.get("rule", ""), entry.get("file", ""),
                           entry.get("symbol", ""))))
        else:
            i += 1
    live = set(live)
    dropped = [t for _, _, t in spans
               if t not in live and t[0] in set(rules_run)]
    keep_mask = [True] * len(lines)
    for start, end, t in spans:
        if t in dropped:
            for j in range(start, end):
                keep_mask[j] = False
            # also absorb one trailing blank line left behind
            if end < len(lines) and not lines[end].strip():
                keep_mask[end] = False
    new_text = "".join(ln for ln, keep in zip(lines, keep_mask, strict=True) if keep)
    return new_text, dropped


def prune_baseline(root: str, live, rules_run) -> list:
    """Rewrite ``analysis_baseline_torch.toml`` in place, dropping dead
    ``[[allow]]`` entries; returns the dropped (rule, file, symbol)
    triples (empty when the file is absent or already minimal)."""
    path = os.path.join(root, BASELINE_NAME)
    if not os.path.isfile(path):
        return []
    with open(path, encoding="utf-8") as f:
        text = f.read()
    new_text, dropped = prune_baseline_text(text, live, rules_run)
    if dropped:
        parse_baseline(new_text, path)     # never write an unloadable file
        with open(path, "w", encoding="utf-8") as f:
            f.write(new_text)
    return dropped
