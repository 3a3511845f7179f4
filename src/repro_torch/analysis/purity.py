"""R003 — purity of the simulator loop (the port of
``repro/analysis/purity.py``).

The reference's ``run_sim`` is one jitted ``lax.scan``; the port's is a
Python loop over epochs and ticks that launches one op after another on
the card.  A host-side effect there — wall clocks, ``np.random``, file or
console I/O, ``datetime`` — bakes one host value into the results and
breaks the bit-identical-backends contract that the fleet store's cache
keys rely on.  The serve engine's ``step`` shares the constraint: all its
timestamps come from the caller's clock domain, never wall time.

The port adds the eager counterpart of "everything in the call graph runs
under trace": a **host read** of a device value — ``.item()``,
``.tolist()``, ``.cpu()``, ``.numpy()``, ``torch.cuda.synchronize`` —
raises inside ``jit``, but in eager torch it waits for the card without a
word, and every read is a stall of the launch queue.  Reads that are the
point of a function (the serve engine's host bookkeeping) go on the
baseline with their reason.

The rule builds a conservative static call graph over the tree:

  * **roots** — ``run_sim`` / ``_epoch`` / ``_tick`` / ``run_open_loop`` /
    ``slo_indices`` wherever defined, ``step`` and ``submit`` methods of
    ``ServeEngine``-named classes, and every callable registered into the
    scenario registries (``register_*`` call sites, and the entries of the
    port's registry dict literals, ``MOBILITY_MODELS = {"circular":
    MobilityModel(init, step), ...}``), since registry dispatch is
    invisible to static analysis;
  * **edges** — direct calls, ``from``-imported names, module-alias
    attribute calls (``trace_record.write_records``), and ``self.``
    method calls, resolved against each module's import table; calls into
    code outside the tree are ignored.

Any reachable function whose body calls a banned API is a finding
anchored at the function's qualname, with the root→…→function chain in
the message.
"""
from __future__ import annotations

import ast
from typing import Dict, List, Optional, Tuple

from repro_torch.analysis.astutil import (Finding, Tree, dotted_name,
                                          functions, import_table,
                                          registry_entries, resolve_call)

RULE = "R003"
# run_open_loop / slo_indices: the observability surface makes the same
# promise as the engine ("timestamps from the caller's clock domain, never
# wall time"), so the open-loop driver and the SLO reducer are roots too
ROOT_FUNCS = {"run_sim", "_epoch", "_tick", "run_open_loop", "slo_indices"}
# class entries are *suffix*-matched, so SplitServeEngine.step and
# SyntheticServeEngine.submit (obs/loadgen.py) are roots, not just a
# class literally named ServeEngine
ROOT_METHODS = {("ServeEngine", "step"), ("ServeEngine", "submit")}

BANNED_PREFIXES = (
    "time.", "datetime.", "numpy.random", "random.",
    "jax.experimental.io_callback", "jax.experimental.host_callback",
    "jax.pure_callback", "jax.debug.callback", "jax.debug.print",
)
BANNED_EXACT = {"open", "print", "input", "time", "datetime",
                "torch.cuda.synchronize"}
#: tensor methods that copy a device value to the host and wait for it
HOST_READS = {"item", "tolist", "cpu", "numpy"}


def _banned(full: str) -> Optional[str]:
    if full in BANNED_EXACT:
        return full
    for p in BANNED_PREFIXES:
        if full == p.rstrip(".") or full.startswith(p):
            return full
    return None


class _Graph:
    """qualname-level call graph, keyed by (module path, qualname)."""

    def __init__(self, tree: Tree):
        self.tree = tree
        self.funcs: Dict[Tuple[str, str], ast.AST] = {}
        self.imports: Dict[str, Dict[str, str]] = {}
        self.module_of: Dict[str, str] = {}   # dotted module -> path
        for mod in tree.src_modules():
            self.imports[mod.path] = import_table(mod.tree)
            for qual, fn in functions(mod.tree).items():
                self.funcs[(mod.path, qual)] = fn
            dotted = (mod.path[len("src/"):-len(".py")]
                      .replace("/__init__", "").replace("/", "."))
            self.module_of[dotted] = mod.path

    def _module_path(self, dotted: str) -> Optional[str]:
        """Resolve a dotted module name to a tree path (suffix-tolerant,
        so fixture trees with shallow layouts still resolve)."""
        if dotted in self.module_of:
            return self.module_of[dotted]
        for name, path in self.module_of.items():
            if name.endswith("." + dotted) or dotted.endswith("." + name):
                return path
        return None

    def resolve(self, path: str, name: str,
                cls: Optional[str] = None) -> Optional[Tuple[str, str]]:
        """The tree function a dotted callee name in module ``path``
        resolves to, else None."""
        parts = name.split(".")
        if parts[0] == "self" and cls and len(parts) == 2:
            key = (path, f"{cls}.{parts[1]}")
            return key if key in self.funcs else None
        imports = self.imports[path]
        if len(parts) == 1:
            # bare name: same module, else a from-import
            if (path, parts[0]) in self.funcs:
                return (path, parts[0])
            origin = imports.get(parts[0])
            if origin and "." in origin:
                mod_dotted, fname = origin.rsplit(".", 1)
                tgt = self._module_path(mod_dotted)
                if tgt and (tgt, fname) in self.funcs:
                    return (tgt, fname)
            return None
        # attribute call: resolve the head as a module alias
        origin = imports.get(parts[0])
        if origin:
            tgt = self._module_path(".".join([origin] + parts[1:-1]))
            if tgt and (tgt, parts[-1]) in self.funcs:
                return (tgt, parts[-1])
        return None

    def callees(self, path: str, qual: str) -> List[Tuple[str, str]]:
        fn = self.funcs[(path, qual)]
        cls = qual.split(".")[0] if "." in qual else None
        out: List[Tuple[str, str]] = []
        for node in ast.walk(fn):
            if isinstance(node, ast.Call):
                name = dotted_name(node.func)
                tgt = self.resolve(path, name, cls) if name else None
                if tgt is not None:
                    out.append(tgt)
        return out

    def banned_calls(self, path: str, qual: str) -> List[Tuple[int, str]]:
        fn = self.funcs[(path, qual)]
        imports = self.imports[path]
        hits = []
        for node in ast.walk(fn):
            if not isinstance(node, ast.Call):
                continue
            if (isinstance(node.func, ast.Attribute)
                    and node.func.attr in HOST_READS and not node.args):
                hits.append((node.lineno, f".{node.func.attr}()"))
                continue
            full = resolve_call(node, imports)
            if full is not None:
                b = _banned(full)
                if b is not None:
                    hits.append((node.lineno, b))
        return hits


def _roots(graph: _Graph, tree: Tree) -> List[Tuple[str, str]]:
    roots: List[Tuple[str, str]] = []
    for (path, qual), _fn in graph.funcs.items():
        base = qual.split(".")[-1]
        if "." not in qual and base in ROOT_FUNCS:
            roots.append((path, qual))
        if "." in qual:
            cls, meth = qual.split(".", 1)
            if any(cls.endswith(c) and meth == m for c, m in ROOT_METHODS):
                roots.append((path, qual))
    # registry-registered callables are dispatch targets of the loop
    for mod in tree.src_modules():
        for _kind, _key, _line, fns in registry_entries(mod.tree):
            for a in fns:
                name = dotted_name(a)
                tgt = graph.resolve(mod.path, name) if name else None
                if tgt is not None:
                    roots.append(tgt)
    return sorted(set(roots))


def check(tree: Tree, baseline=None) -> List[Finding]:
    del baseline
    graph = _Graph(tree)
    findings: List[Finding] = []
    chain: Dict[Tuple[str, str], Tuple[str, ...]] = {}
    stack = []
    for r in _roots(graph, tree):
        chain[r] = (r[1],)
        stack.append(r)
    while stack:
        cur = stack.pop()
        for nxt in graph.callees(*cur):
            if nxt not in chain:
                chain[nxt] = chain[cur] + (nxt[1],)
                stack.append(nxt)
    for (path, qual), trail in sorted(chain.items()):
        for line, api in graph.banned_calls(path, qual):
            what = ("host read" if api.startswith(".")
                    or api == "torch.cuda.synchronize" else "host-side call")
            findings.append(Finding(
                RULE, path, line, qual,
                f"{what} {api!r} is reachable from the simulator loop via "
                f"{' -> '.join(trail)}"))
    return findings
