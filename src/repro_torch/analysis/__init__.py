"""swarmlint for the port — repo-native static analysis of ``repro_torch``
(DESIGN.md §13, §15), the port of ``repro.analysis``.

The port's correctness story rests on the reference's invariants, which
ordinary linters cannot see: bit-identical backends require strict PRNG
key hygiene, content-addressed caching requires every numerics-affecting
config field to enter the store digest, and the simulator loop must stay
free of host-side impurity.  This package checks them over
``src/repro_torch/`` with the reference's rule ids, its ``Finding`` type
and its CLI surface, and a baseline of its own
(``analysis_baseline_torch.toml``).

Rules, **ast** tier (pure AST: fast, dependency-free):

  * **R001 key-discipline** (``keys.py``) — a ``repro_torch.rng`` key
    consumed by two independent sinks inside one function body.
  * **R002 digest-completeness** (``digest.py``) — every ``SwarmConfig`` /
    ``SweepSpec`` field reaches ``fleet/store.point_digest`` or is listed
    in the exemption table with a reason.
  * **R003 loop purity** (``purity.py``) — no host-side effects, and no
    host reads of device values, in the call graph reachable from
    ``run_sim`` / ``_epoch`` / ``_tick`` / the serve engines and the
    scenario-registry callables.
  * **R004 registry/doc consistency** (``consistency.py``) — every
    registry key is referenced by a port test and documented;
    ``DESIGN.md §N[.M]`` docstring citations must resolve.

The **ops** tier (``repro_torch.analysis.ops``) adds J001–J005 over the
*recorded op streams* of the real programs — eager torch's counterpart of
a jaxpr (in-loop cross-node float reductions, default-dtype drift,
unannotated clamp/redirect indexing, host-data bloat, op-stream
fingerprint stability) — selected with ``--tier ast|ops|all``.  It runs
the programs on ``device``: the card unless the caller asks for the CPU.

Entry points: ``python -m repro_torch.analysis`` (CLI, nonzero exit on
unbaselined findings) and :func:`run`.  Deliberate violations are
allowlisted per (rule, file, symbol) in ``analysis_baseline_torch.toml``
at the repo root — every entry carries a ``reason`` string.
"""
from __future__ import annotations

from typing import Dict, List, Optional, Sequence

from repro_torch.analysis import consistency, digest, keys, purity
from repro_torch.analysis.astutil import Finding, Tree
from repro_torch.analysis.baseline import Baseline, load_baseline

RULES = {
    "R001": keys.check,
    "R002": digest.check,
    "R003": purity.check,
    "R004": consistency.check,
}

#: ops-tier rule ids, known here so the CLI can validate ``--rules`` and
#: ``--list-rules`` without running a program (the implementations live in
#: ``repro_torch.analysis.ops`` and are imported when the tier runs)
OPS_RULE_IDS = ("J001", "J002", "J003", "J004", "J005")

RULE_DOCS = {
    "R001": "PRNG key consumed by two independent sinks (def-use)",
    "R002": "config field missing from the store digest (no exemption)",
    "R003": "host-side impurity or host read reachable from the loop",
    "R004": "registry key untested/undocumented, or dangling §-citation",
    "J001": "in-loop cross-node float reduction (backend parity hazard)",
    "J002": "dtype drift between float32 and float64 default dtypes",
    "J003": "unannotated clamp/where-made index of a gather/scatter",
    "J004": "oversized host data copied into a recorded program",
    "J005": "data-only sweep points recording distinct op streams",
}

#: every rule id across both tiers (CLI validation surface)
ALL_RULE_IDS = tuple(sorted(RULES)) + OPS_RULE_IDS

TIERS = ("ast", "ops", "all")


def run(root: str, rules: Optional[Sequence[str]] = None,
        baseline: Optional[Baseline] = None,
        use_baseline: bool = True, tier: str = "ast",
        device=None, report: Optional[Dict] = None) -> List[Finding]:
    """Run ``rules`` (default: all of the selected tier) over the tree at
    ``root``; returns the findings that survive the baseline (i.e. the
    ones that should fail).  ``tier`` picks the AST rules (default — the
    fast path that needs no device), the ops rules, or both; explicit
    ``rules`` are routed to their tier automatically.  ``device`` is where
    the ops tier runs the programs: CUDA unless the caller asks for
    another device (it raises where CUDA is absent); ``report`` receives
    what it recorded (``repro_torch.analysis.ops.run_ops``)."""
    if tier not in TIERS:
        raise ValueError(f"unknown tier {tier!r} (known: {TIERS})")
    if baseline is None and use_baseline:
        baseline = load_baseline(root)
    ast_ids = [r for r in rules if r in RULES] if rules is not None else None
    ops_ids = ([r for r in rules if r in OPS_RULE_IDS]
               if rules is not None else None)
    findings: List[Finding] = []
    if tier in ("ast", "all") and (ast_ids is None or ast_ids):
        tree = Tree.load(root)
        for rid in ast_ids if ast_ids is not None else sorted(RULES):
            findings.extend(RULES[rid](tree, baseline))
    if tier in ("ops", "all") and (ops_ids is None or ops_ids):
        from repro_torch.analysis.ops import run_ops   # imports the port
        findings.extend(run_ops(root, ops_ids, device=device,
                                report=report))
    if baseline is not None:
        findings = [f for f in findings if not baseline.allows(f)]
    return sorted(findings, key=lambda f: (f.file, f.line, f.rule))
