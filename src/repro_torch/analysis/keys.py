"""R001 — PRNG key discipline over ``repro_torch.rng`` (def-use over
function bodies); the port of ``repro/analysis/keys.py``.

The invariant: a key is consumed **once**.  Handing the same key to two
independent sinks — two samplers, a sampler and ``split``, or a sampler
and ``fold_in`` — produces threefry-counter-correlated streams: the bug
class where the Random/RandomAcyclic offload coin reused the gumbel
target-draw key.  ``repro_torch.rng`` is bit-exact with ``jax.random``, so
the port inherits the hazard with the streams.

Analysis (per function body, nested defs included — a closure that
captures an outer key consumes it on the outer function's behalf):

  * **key variables** are parameters named ``key`` / ``keys`` / ``rng`` /
    ``*_key`` / ``*_keys``, any variable assigned (or tuple-unpacked) from
    ``rng.split`` / ``fold_in`` / ``fold_in_each`` / ``PRNGKey``, and any
    variable bound to a constant subscript of a key variable: the port
    splits into one ``[..., n, 2]`` tensor and takes its rows, ``k =
    rng.split(key, 3); k1, k2, k3 = k[..., 0, :], k[..., 1, :], k[..., 2,
    :]``, so each row is a key def of its own and taking several rows of
    ``k`` is not a consumption of ``k``;
  * a **consumption** is any use of a key variable, or of a constant
    subscript of one, as a call argument — sampler, ``split``,
    ``fold_in``, or an opaque callee (which must be assumed to consume
    it);
  * rebinding (``key = rng.fold_in(key, 1)``) starts a fresh def with its
    own use count; ``if``/``else`` arms count as alternatives (max), not
    as a sequence (sum), so branch-exclusive uses don't false-positive.

A variable with ≥ 2 consumptions is a finding anchored at
``func:variable`` (a row used in place is named by its subscript,
``func:k[..., 0, :]``).  Scope: ``swarm/``, ``core/``, ``trace/``,
``obs/``, ``splitcompute/`` under ``src/repro_torch/`` — the modules
whose streams the bit-identity contracts cover.
"""
from __future__ import annotations

import ast
from typing import Dict, List, Optional, Tuple

from repro_torch.analysis.astutil import (Finding, Module, Tree, dotted_name,
                                          import_table)

RULE = "R001"
SCOPES = ("/swarm/", "/core/", "/trace/", "/obs/", "/splitcompute/")
RNG_MODULE = "repro_torch.rng"
# rng functions whose *result* is a key (tracked as new defs)
KEY_MAKERS = {"split", "fold_in", "fold_in_each", "PRNGKey"}
_PARAM_KEY = ("key", "keys", "rng")


def _is_key_param(name: str) -> bool:
    return name in _PARAM_KEY or name.endswith(("_key", "_keys"))


class _RandomNS:
    """Recognizes ``repro_torch.rng.<fn>`` under the module's aliases."""

    def __init__(self, mod: Module):
        self.imports = import_table(mod.tree)

    def maker_call(self, node: ast.AST) -> Optional[str]:
        """'split' / 'fold_in' / ... if node is such a call."""
        if not isinstance(node, ast.Call):
            return None
        name = dotted_name(node.func)
        if name is None:
            return None
        head, _, rest = name.partition(".")
        full = name
        if head in self.imports:
            origin = self.imports[head]
            full = f"{origin}.{rest}" if rest else origin
        fn = full.rsplit(".", 1)[-1]
        if full.startswith(RNG_MODULE + ".") and fn in KEY_MAKERS:
            return fn
        return None


def _constant_index(node: ast.AST) -> bool:
    """A subscript index made of constants, ``...`` and constant slices
    (``[..., 0, :]``) — a fixed row of a split, not a data-dependent one."""
    if isinstance(node, ast.Constant):
        return True
    if isinstance(node, ast.UnaryOp) and isinstance(node.operand,
                                                    ast.Constant):
        return True
    if isinstance(node, ast.Slice):
        return all(p is None or _constant_index(p)
                   for p in (node.lower, node.upper, node.step))
    if isinstance(node, ast.Tuple):
        return all(_constant_index(e) for e in node.elts)
    return False


class _Counts:
    """Per-def consumption counts: def id -> (var, line-of-def, [uses])."""

    def __init__(self):
        self.defs: Dict[int, Tuple[str, int, List[int]]] = {}
        self.env: Dict[str, int] = {}      # var name -> live def id
        # (def id of the split, row name) -> def id of the row: a row
        # lives as long as its split's def, across branches
        self.rows: Dict[Tuple[int, str], int] = {}
        self._next = 0

    def bind(self, var: str, line: int) -> None:
        self.defs[self._next] = (var, line, [])
        self.env[var] = self._next
        self._next += 1

    def use(self, var: str, line: int) -> None:
        if var in self.env:
            self.defs[self.env[var]][2].append(line)

    def use_row(self, node: ast.AST, line: int) -> None:
        """Count a use of ``node`` where it is a constant-subscript row of
        a live key variable (``k[..., 0, :]``, a def of its own from the
        split's line)."""
        if not (isinstance(node, ast.Subscript)
                and isinstance(node.value, ast.Name)
                and node.value.id in self.env
                and _constant_index(node.slice)):
            return
        base = self.env[node.value.id]
        key = (base, ast.unparse(node))
        if key not in self.rows:
            self.defs[self._next] = (key[1], self.defs[base][1], [])
            self.rows[key] = self._next
            self._next += 1
        self.defs[self.rows[key]][2].append(line)


def _scan_function(fn: ast.AST, ns: _RandomNS, mod: Module,
                   findings: List[Finding]) -> None:
    counts = _Counts()
    for arg in ([*fn.args.posonlyargs, *fn.args.args, *fn.args.kwonlyargs]
                if isinstance(fn, (ast.FunctionDef, ast.AsyncFunctionDef))
                else []):
        if _is_key_param(arg.arg):
            counts.bind(arg.arg, fn.lineno)

    def use_arg(a: ast.AST, skip=frozenset()) -> None:
        if isinstance(a, ast.Name) and a.id not in skip:
            counts.use(a.id, a.lineno)
        elif not (isinstance(a, ast.Subscript)
                  and isinstance(a.value, ast.Name) and a.value.id in skip):
            counts.use_row(a, a.lineno)

    def scan_expr(node: ast.AST) -> None:
        """Count key uses inside one expression (call args only)."""
        for call in [n for n in ast.walk(node) if isinstance(n, ast.Call)]:
            for a in list(call.args) + [kw.value for kw in call.keywords]:
                use_arg(a)

    def is_key_value(value: ast.AST) -> bool:
        return (ns.maker_call(value) is not None
                or (isinstance(value, ast.Subscript)
                    and isinstance(value.value, ast.Name)
                    and value.value.id in counts.env
                    and _constant_index(value.slice)))

    def bind_targets(target: ast.AST, value: ast.AST) -> None:
        """Track key defs created by an assignment."""
        if (isinstance(target, (ast.Tuple, ast.List))
                and isinstance(value, (ast.Tuple, ast.List))
                and len(target.elts) == len(value.elts)):
            for t, v in zip(target.elts, value.elts, strict=True):
                bind_targets(t, v)
            return
        if not is_key_value(value):
            return
        names = []
        if isinstance(target, ast.Name):
            names = [target]
        elif isinstance(target, (ast.Tuple, ast.List)):
            names = [e for e in target.elts if isinstance(e, ast.Name)]
        for name in names:
            counts.bind(name.id, name.lineno)

    def scan_block(stmts) -> None:
        for stmt in stmts:
            if isinstance(stmt, ast.Assign):
                scan_expr(stmt.value)
                for t in stmt.targets:
                    bind_targets(t, stmt.value)
            elif isinstance(stmt, (ast.AnnAssign, ast.AugAssign)):
                if stmt.value is not None:
                    scan_expr(stmt.value)
                if isinstance(stmt, ast.AnnAssign) and stmt.value is not None:
                    bind_targets(stmt.target, stmt.value)
            elif isinstance(stmt, ast.If):
                scan_expr(stmt.test)
                _scan_branches([stmt.body, stmt.orelse])
            elif isinstance(stmt, (ast.For, ast.AsyncFor)):
                scan_expr(stmt.iter)
                _scan_branches([stmt.body + stmt.orelse])
            elif isinstance(stmt, ast.While):
                scan_expr(stmt.test)
                _scan_branches([stmt.body + stmt.orelse])
            elif isinstance(stmt, (ast.With, ast.AsyncWith)):
                for item in stmt.items:
                    scan_expr(item.context_expr)
                scan_block(stmt.body)
            elif isinstance(stmt, ast.Try):
                _scan_branches([stmt.body + stmt.finalbody]
                               + [h.body for h in stmt.handlers])
            elif isinstance(stmt, (ast.FunctionDef, ast.AsyncFunctionDef)):
                # closure body: uses of *outer* keys count against them;
                # the nested function's own keys are scanned separately
                inner = frozenset(a.arg for a in stmt.args.args)
                for call in [n for n in ast.walk(stmt)
                             if isinstance(n, ast.Call)]:
                    for a in (list(call.args)
                              + [kw.value for kw in call.keywords]):
                        use_arg(a, skip=inner)
            elif isinstance(stmt, (ast.Return, ast.Expr)):
                if stmt.value is not None:
                    scan_expr(stmt.value)
            else:
                scan_expr(stmt)

    def _scan_branches(branches) -> None:
        """Mutually exclusive arms: per-def use count is the max over
        arms, not the sum — a key consumed once in *each* arm of an
        if/else is consumed once per execution."""
        before = {i: len(uses) for i, (_, _, uses) in counts.defs.items()}
        best: Dict[int, List[int]] = {}
        for branch in branches:
            # rewind to the pre-branch counts, scan, keep the max
            for i, (_, _, uses) in counts.defs.items():
                del uses[before.get(i, 0):]
            env_before = dict(counts.env)
            scan_block(branch)
            for i, (_, _, uses) in counts.defs.items():
                new = uses[before.get(i, 0):]
                if len(new) > len(best.get(i, [])):
                    best[i] = list(new)
            counts.env = env_before
        for i, (_, _, uses) in counts.defs.items():
            del uses[before.get(i, 0):]
            uses.extend(best.get(i, []))

    scan_block(fn.body)
    for var, line, uses in counts.defs.values():
        if len(uses) >= 2:
            findings.append(Finding(
                RULE, mod.path, uses[1], f"{fn.name}:{var}",
                f"key {var!r} (defined line {line}) is consumed "
                f"{len(uses)} times (lines {', '.join(map(str, uses))}); "
                "split or fold_in fresh subkeys per sink"))


def check(tree: Tree, baseline=None) -> List[Finding]:
    del baseline
    findings: List[Finding] = []
    for mod in tree.src_modules():
        if not any(s in f"/{mod.path}" for s in SCOPES):
            continue
        ns = _RandomNS(mod)
        for node in ast.walk(mod.tree):
            if isinstance(node, (ast.FunctionDef, ast.AsyncFunctionDef)):
                _scan_function(node, ns, mod, findings)
    return findings
