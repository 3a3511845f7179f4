"""R004 — registry/doc consistency (the port of
``repro/analysis/consistency.py``).

Two invariants about the string-keyed extension surfaces:

  * **registry keys are load-bearing API** — every key of the port's
    mobility/channel/fault registries (the dict literals of
    ``swarm/scenario.py``, or ``register_*`` call sites) and every
    strategy name in ``STRATEGY_NAMES`` must be referenced by at least one
    of the port's tests (``tests/test_torch_*.py``, or ``chip_smoke.py``)
    and mentioned in DESIGN.md or the README's port section.  An
    unreferenced key is a scenario nobody can discover and nothing would
    catch regressing.
  * **§-citations resolve** — a docstring of the port citing ``DESIGN.md
    §N`` (or ``§N.M``) must point at a real ``## §N`` / ``### §N.M``
    heading.
"""
from __future__ import annotations

import ast
import re
from typing import List, Tuple

from repro_torch.analysis.astutil import (Finding, Tree, docstrings,
                                          registry_entries)

RULE = "R004"
_CITE = re.compile(r"DESIGN\.md\s*§\s*(\d+)(?:\.(\d+))?")


def _registry_keys(tree: Tree) -> List[Tuple[str, str, str, int]]:
    """(kind, key, file, line) for every registered string key."""
    out = []
    for mod in tree.src_modules():
        for kind, key, line, _fns in registry_entries(mod.tree):
            out.append((kind, key, mod.path, line))
        for node in ast.walk(mod.tree):
            if isinstance(node, ast.Assign):
                targets = [t.id for t in node.targets
                           if isinstance(t, ast.Name)]
                if "STRATEGY_NAMES" in targets and isinstance(
                        node.value, (ast.Tuple, ast.List)):
                    for el in node.value.elts:
                        if isinstance(el, ast.Constant) and isinstance(
                                el.value, str):
                            out.append(("strategy", el.value, mod.path,
                                        el.lineno))
    return out


def check(tree: Tree, baseline=None) -> List[Finding]:
    del baseline
    findings: List[Finding] = []
    design = tree.text("DESIGN.md") or ""
    docs = tree.docs()
    tests = tree.test_sources()

    for kind, key, path, line in _registry_keys(tree):
        word = re.compile(rf"\b{re.escape(key)}\b")
        if not word.search(tests):
            findings.append(Finding(
                RULE, path, line, f"{kind}:{key}",
                f"{kind} registry key {key!r} is referenced by no test of "
                "the port — nothing would catch it regressing"))
        if not word.search(docs):
            findings.append(Finding(
                RULE, path, line, f"{kind}:{key}",
                f"{kind} registry key {key!r} is not mentioned in "
                "DESIGN.md or the README's port section — undiscoverable "
                "scenario surface"))

    for mod in tree.src_modules():
        for line, doc in docstrings(mod.tree):
            for m in _CITE.finditer(doc):
                major, minor = m.group(1), m.group(2)
                sec = f"§{major}.{minor}" if minor else f"§{major}"
                pat = (rf"^###\s*§{major}\.{minor}\b" if minor
                       else rf"^##\s*§{major}\b")
                if not re.search(pat, design, re.MULTILINE):
                    findings.append(Finding(
                        RULE, mod.path, line, f"cite:{sec}",
                        f"dangling citation: DESIGN.md {sec} has no "
                        "matching heading"))
    return findings
