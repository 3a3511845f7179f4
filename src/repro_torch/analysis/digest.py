"""R002 — store-digest completeness of the port's store (the port of
``repro/analysis/digest.py``).

The content-addressed store (``fleet/store.py``) addresses a sweep point
by the SHA-256 of everything that determines its numbers.  A config field
that affects the computed metrics but does not reach
:func:`point_digest` aliases distinct results onto one cache key — the
reference hit exactly this when ``trace_capacity`` first landed outside
the digest and traced/untraced runs collided.

The rule checks, per tree:

  * every ``SwarmConfig`` field is digest-covered.  Coverage is either
    *wholesale* (``dataclasses.asdict(point.cfg)`` anywhere in
    ``point_digest`` — the shipped design, which makes new fields covered
    by construction) or *explicit* (``point.cfg.<field>`` accesses, for
    trees that enumerate fields by hand);
  * every ``SweepSpec`` field maps into the digest payload: ``base`` via
    the cfg blob, ``strategies`` via the per-point ``strategy`` entry,
    the rest by payload key name;
  * fields that are deliberately excluded appear in the
    ``[[digest_exempt]]`` table of ``analysis_baseline_torch.toml`` with a
    reason.  Exemptions are validated live: an entry naming a field that
    no longer exists, a ``function.param`` that is gone, or a field that
    is in fact covered (shadowed exemption) is itself a finding — the
    table cannot rot.
"""
from __future__ import annotations

import ast
from typing import Dict, List, Set, Tuple

from repro_torch.analysis.astutil import Finding, Tree, dotted_name
from repro_torch.analysis.baseline import BASELINE_NAME

RULE = "R002"
# SweepSpec fields that enter the digest under a different payload name
_SWEEP_ALIASES = {"base": "cfg", "strategies": "strategy"}


def _dataclass_fields(cls: ast.ClassDef) -> List[Tuple[str, int]]:
    return [(st.target.id, st.lineno) for st in cls.body
            if isinstance(st, ast.AnnAssign)
            and isinstance(st.target, ast.Name)]


def _find_class(tree: Tree, name: str):
    for mod in tree.src_modules():
        for node in mod.tree.body:
            if isinstance(node, ast.ClassDef) and node.name == name:
                return mod, node
    return None, None


def _find_function(tree: Tree, name: str):
    for mod in tree.src_modules():
        for node in ast.walk(mod.tree):
            if isinstance(node, (ast.FunctionDef, ast.AsyncFunctionDef)) \
                    and node.name == name:
                return mod, node
    return None, None


def _digest_coverage(fn: ast.AST) -> Tuple[bool, Set[str], Set[str]]:
    """(wholesale-cfg-coverage?, explicit cfg fields, payload keys)."""
    wholesale = False
    explicit: Set[str] = set()
    payload: Set[str] = set()
    for node in ast.walk(fn):
        if isinstance(node, ast.Call):
            name = dotted_name(node.func) or ""
            if name.split(".")[-1] == "asdict":
                for a in node.args:
                    if (dotted_name(a) or "").endswith(".cfg"):
                        wholesale = True
        if isinstance(node, ast.Attribute):
            chain = dotted_name(node)
            if chain and ".cfg." in f".{chain}.":
                tail = chain.split(".cfg.", 1)
                if len(tail) == 2 and tail[1] and "." not in tail[1]:
                    explicit.add(tail[1])
        if isinstance(node, ast.Dict):
            for k in node.keys:
                if isinstance(k, ast.Constant) and isinstance(k.value, str):
                    payload.add(k.value)
    return wholesale, explicit, payload


def check(tree: Tree, baseline=None) -> List[Finding]:
    findings: List[Finding] = []
    exempt: Dict[str, str] = dict(baseline.digest_exempt) if baseline else {}

    cfg_mod, cfg_cls = _find_class(tree, "SwarmConfig")
    spec_mod, spec_cls = _find_class(tree, "SweepSpec")
    dig_mod, dig_fn = _find_function(tree, "point_digest")
    if cfg_cls is None or dig_fn is None:
        return findings     # not a tree that carries the store contract

    wholesale, explicit, payload = _digest_coverage(dig_fn)
    seen_exempt: Set[str] = set()

    def covered_cfg(field: str) -> bool:
        return wholesale or field in explicit

    for field, line in _dataclass_fields(cfg_cls):
        tag = f"SwarmConfig.{field}"
        if covered_cfg(field):
            if tag in exempt:
                findings.append(Finding(
                    RULE, cfg_mod.path, line, tag,
                    f"shadowed exemption: {tag} is exempted in the "
                    "baseline but actually reaches point_digest — drop "
                    "the stale entry"))
                seen_exempt.add(tag)
            continue
        if tag in exempt:
            seen_exempt.add(tag)
            continue
        findings.append(Finding(
            RULE, cfg_mod.path, line, tag,
            f"SwarmConfig.{field} never reaches point_digest and has no "
            "[[digest_exempt]] entry — distinct configs would alias onto "
            "one cache key (the trace_capacity aliasing bug class)"))

    if spec_cls is not None:
        for field, line in _dataclass_fields(spec_cls):
            tag = f"SweepSpec.{field}"
            key = _SWEEP_ALIASES.get(field, field)
            cov = (key in payload or (field == "base" and wholesale))
            if cov:
                if tag in exempt:
                    findings.append(Finding(
                        RULE, spec_mod.path, line, tag,
                        f"shadowed exemption: {tag} reaches the digest "
                        "payload — drop the stale entry"))
                    seen_exempt.add(tag)
                continue
            if tag in exempt:
                seen_exempt.add(tag)
                continue
            findings.append(Finding(
                RULE, spec_mod.path, line, tag,
                f"SweepSpec.{field} is not digest-covered (no payload key "
                f"{key!r}) and has no [[digest_exempt]] entry"))

    # validate the remaining exemptions: each must name a live field or a
    # live function parameter ("run_batch.backend")
    for tag in sorted(set(exempt) - seen_exempt):
        head, _, attr = tag.partition(".")
        if head in ("SwarmConfig", "SweepSpec"):
            anchor = cfg_mod if head == "SwarmConfig" else spec_mod
            findings.append(Finding(
                RULE, anchor.path if anchor else BASELINE_NAME,
                1, tag,
                f"stale exemption: {tag} names no current {head} field"))
            continue
        fmod, ffn = _find_function(tree, head)
        params = ({a.arg for a in ffn.args.args} | {a.arg for a in
                  ffn.args.kwonlyargs}) if ffn is not None else set()
        if ffn is None or attr not in params:
            findings.append(Finding(
                RULE, BASELINE_NAME, 1, tag,
                f"stale exemption: {tag} matches neither a config field "
                "nor a live function parameter"))
    return findings
