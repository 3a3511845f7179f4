"""``python -m repro_torch.analysis`` — run the port's swarmlint over a
repo tree (the port of ``python -m repro.analysis``).

Exit status 0 when the tree is clean (after the baseline), 1 when any
finding survives, 2 on usage/configuration errors (a malformed baseline,
or the ops tier asked to run on CUDA where there is none).  ``--tier``
selects the AST rules (R…, default — fast, no device), the ops rules (J…,
record the real programs' op streams on ``--device``, the card unless
``--device cpu``), or both.  ``--format json``
emits one machine-readable document (findings + counts) for CI tooling;
``--format sarif`` emits SARIF 2.1.0 for code-scanning upload; the
default text format is one ``file:line: RULE symbol message`` row per
finding, grep- and editor-friendly.  ``--prune-baseline`` rewrites
``analysis_baseline_torch.toml`` in place, dropping ``[[allow]]`` entries whose
finding no longer fires (dead entries would mask a future regression at
the same site).
"""
from __future__ import annotations

import argparse
import json
import os
import sys

from repro_torch.analysis import (ALL_RULE_IDS, OPS_RULE_IDS, RULE_DOCS,
                                  RULES, TIERS, run)
from repro_torch.analysis.baseline import (BASELINE_NAME, load_baseline,
                                           prune_baseline)


def _detect_root(start: str) -> str:
    """Walk up from ``start`` to the nearest directory that looks like the
    repo root (has ``src/`` and ``DESIGN.md`` or the baseline file)."""
    cur = os.path.abspath(start)
    while True:
        if os.path.isdir(os.path.join(cur, "src")) and (
                os.path.isfile(os.path.join(cur, "DESIGN.md"))
                or os.path.isfile(os.path.join(cur, BASELINE_NAME))):
            return cur
        parent = os.path.dirname(cur)
        if parent == cur:
            return os.path.abspath(start)
        cur = parent


def _tier_rule_ids(tier: str):
    ids = []
    if tier in ("ast", "all"):
        ids.extend(sorted(RULES))
    if tier in ("ops", "all"):
        ids.extend(OPS_RULE_IDS)
    return ids


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(
        prog="python -m repro_torch.analysis",
        description="swarmlint for the port: repo-native static analysis "
                    "of repro_torch (DESIGN.md §13, §15)")
    ap.add_argument("--root", default=None,
                    help="repo root to scan (default: auto-detect upward "
                         "from the working directory)")
    ap.add_argument("--tier", choices=TIERS, default=None,
                    help="rule tier: 'ast' (R rules, no device needed), "
                         "'ops' (J rules, records the real programs' op "
                         "streams on --device), or 'all' (default: "
                         "inferred from --rules, else ast)")
    ap.add_argument("--device", default=None,
                    help="where the ops tier runs the programs (default: "
                         "CUDA, an error where there is none; 'cpu' to "
                         "run on the CPU)")
    ap.add_argument("--format", choices=("text", "json", "sarif"),
                    default="text")
    ap.add_argument("--rules", default=None,
                    help="comma-separated rule ids (default: all of the "
                         "selected tier)")
    ap.add_argument("--no-baseline", action="store_true",
                    help=f"ignore {BASELINE_NAME} and report everything")
    ap.add_argument("--prune-baseline", action="store_true",
                    help=f"rewrite {BASELINE_NAME}, dropping [[allow]] "
                         "entries whose finding no longer fires (only "
                         "entries of rules run this invocation)")
    ap.add_argument("--report", default=None, metavar="PATH",
                    help="write what the ops tier recorded (ops and kernel "
                         "launches per target, the stand-in sweeps' "
                         "fingerprint tables, seconds) to PATH as JSON")
    ap.add_argument("--list-rules", action="store_true")
    args = ap.parse_args(argv)

    if args.list_rules:
        for rid in ALL_RULE_IDS:
            tier = "ast" if rid in RULES else "ops"
            print(f"{rid}  [{tier}]  {RULE_DOCS[rid]}")
        return 0

    root = os.path.abspath(args.root) if args.root else _detect_root(".")
    rules = None
    if args.rules:
        rules = [r.strip().upper() for r in args.rules.split(",") if r.strip()]
        unknown = set(rules) - set(ALL_RULE_IDS)
        if unknown:
            print(f"unknown rules: {sorted(unknown)} "
                  f"(known: {list(ALL_RULE_IDS)})", file=sys.stderr)
            return 2

    tier = args.tier
    if tier is None:
        # infer: explicit rules pick their tiers; default stays ast (the
        # cheap path — the ops tier reruns every registered program)
        if rules is not None:
            has_ast = any(r in RULES for r in rules)
            has_ops = any(r in OPS_RULE_IDS for r in rules)
            tier = ("all" if has_ast and has_ops
                    else "ops" if has_ops else "ast")
        else:
            tier = "ast"
    elif rules is not None:
        routed = [r for r in rules if r in _tier_rule_ids(tier)]
        if not routed:
            print(f"none of {rules} belong to tier {tier!r}; pass --tier "
                  "all (or drop --tier to infer it)", file=sys.stderr)
            return 2

    if tier in ("ops", "all"):
        from repro_torch.device import resolve_device
        try:
            resolve_device(args.device)
        except RuntimeError as e:     # the ops tier asked for a missing card
            print(f"error: {e}", file=sys.stderr)
            return 2

    try:
        baseline = None if args.no_baseline else load_baseline(root)
        report = {} if args.report else None
        findings = run(root, rules=rules, baseline=baseline,
                       use_baseline=not args.no_baseline, tier=tier,
                       device=args.device, report=report)
        if args.report:
            with open(args.report, "w", encoding="utf-8") as f:
                json.dump(report, f, indent=1, sort_keys=True)
        if args.prune_baseline:
            raw = run(root, rules=rules, use_baseline=False, tier=tier,
                      device=args.device)
            live = {(f.rule, f.file, f.symbol) for f in raw}
            ran = rules if rules is not None else _tier_rule_ids(tier)
            dropped = prune_baseline(root, live, ran)
            for rule, fname, symbol in dropped:
                print(f"pruned dead baseline entry: {rule} {fname} "
                      f"[{symbol}]")
            if not dropped:
                print("baseline already minimal: nothing to prune")
    except ValueError as e:       # malformed baseline is a hard error
        print(f"error: {e}", file=sys.stderr)
        return 2

    baselined = baseline.count if baseline else 0
    if args.format == "json":
        print(json.dumps({
            "root": root,
            "tier": tier,
            "rules": rules or _tier_rule_ids(tier),
            "baselined": baselined,
            "findings": [f.to_dict() for f in findings],
        }, indent=2, sort_keys=True))
    elif args.format == "sarif":
        from repro_torch.analysis.sarif import to_sarif
        docs = {rid: RULE_DOCS[rid] for rid in
                (rules or _tier_rule_ids(tier))}
        print(json.dumps(to_sarif(findings, docs, root),
                         indent=2, sort_keys=True))
    else:
        for f in findings:
            print(f"{f.file}:{f.line}: {f.rule} [{f.symbol}] {f.message}")
        tag = f" ({baselined} baselined)" if baselined else ""
        print(f"swarmlint[{tier}]: {len(findings)} finding(s){tag} "
              f"in {root}")
    return 1 if findings else 0


if __name__ == "__main__":
    sys.exit(main())
