"""SARIF 2.1.0 emission for the port's swarmlint findings (``--format
sarif``; the same document as ``repro/analysis/sarif.py``'s).

SARIF (Static Analysis Results Interchange Format, OASIS) is the
ingestion format of GitHub code scanning and most CI annotation tooling:
one ``run`` with a tool descriptor + rule metadata, one ``result`` per
finding anchored to a repo-relative artifact location.  Keeping the
emitter tiny and dependency-free matters more here than covering the
spec — only the fields code-scanning actually renders are produced.

Both tiers emit through this module: tier-1 rows anchor to real source
lines; ops-tier rows whose finding is program-level (J002/J004/J005 attach
to a target or sweep, not a line) use line 1 per the SARIF minimum and
carry the symbol in the message.
"""
from __future__ import annotations

from typing import Any, Dict, List, Sequence

from repro_torch.analysis.astutil import Finding

SARIF_SCHEMA = ("https://raw.githubusercontent.com/oasis-tcs/sarif-spec/"
                "master/Schemata/sarif-schema-2.1.0.json")
SARIF_VERSION = "2.1.0"
TOOL_NAME = "swarmlint"


def to_sarif(findings: Sequence[Finding], rule_docs: Dict[str, str],
             root: str) -> Dict[str, Any]:
    """One SARIF document for the run: every known rule is declared (so
    code scanning shows a stable rule inventory even on clean runs) and
    every finding becomes an ``error``-level result."""
    rules: List[Dict[str, Any]] = [
        {
            "id": rid,
            "name": rid,
            "shortDescription": {"text": doc},
            "defaultConfiguration": {"level": "error"},
        }
        for rid, doc in sorted(rule_docs.items())
    ]
    results: List[Dict[str, Any]] = []
    for f in findings:
        results.append({
            "ruleId": f.rule,
            "level": "error",
            "message": {"text": f"[{f.symbol}] {f.message}"},
            "locations": [{
                "physicalLocation": {
                    "artifactLocation": {
                        "uri": f.file.replace("\\", "/"),
                        "uriBaseId": "SRCROOT",
                    },
                    # SARIF lines are 1-based; program-level findings
                    # (no source anchor) pin to line 1
                    "region": {"startLine": max(1, f.line)},
                },
            }],
        })
    return {
        "$schema": SARIF_SCHEMA,
        "version": SARIF_VERSION,
        "runs": [{
            "tool": {"driver": {
                "name": TOOL_NAME,
                "informationUri": "https://example.invalid/swarmlint",
                "rules": rules,
            }},
            "originalUriBaseIds": {"SRCROOT": {"uri": f"file://{root}/"}},
            "results": results,
        }],
    }
