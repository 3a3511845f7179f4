"""Shared AST plumbing for the port's swarmlint rules (the port's copy of
``repro/analysis/astutil.py``).

A :class:`Tree` is a parsed snapshot of one repository (or fixture mini-
repo).  Its *subjects* are the ``.py`` files under ``src/repro_torch/``
and nothing else of ``src/``: the JAX package is another program, with
its own linter and baseline.  Its *evidence* is the port's tests
(``tests/test_torch_*.py``) and ``chip_smoke.py``, which R004 reads for
mentions of registry keys, and its documents are ``DESIGN.md`` and the
README's port section.  Rules never read the filesystem themselves, which
is what lets the fixture trees under ``tests/torch_lint/analysis_fixtures/``
run each rule with the same code path as the real tree.
"""
from __future__ import annotations

import ast
import dataclasses
import os
from typing import Dict, Iterator, List, Optional, Tuple

# directories that never contain rule subjects (fixtures are deliberately
# broken; artifacts/caches are not code)
SKIP_DIRS = {"analysis_fixtures", "artifacts", "__pycache__", ".git",
             ".claude", "node_modules"}
#: the subjects: the port's package
SUBJECT_DIR = "src/repro_torch"
#: the evidence: the port's tests and the card script
TEST_GLOB = ("tests", "test_torch_", ".py")
EVIDENCE_FILES = ("chip_smoke.py",)
#: the README section that documents the port (R004's second document)
PORT_SECTION = "## Running the port"


@dataclasses.dataclass(frozen=True)
class Finding:
    rule: str          # "R001" … "R004", "J001" … "J005"
    file: str          # repo-relative posix path
    line: int
    symbol: str        # rule-specific anchor, e.g. "init_state:key"
    message: str

    def to_dict(self) -> Dict:
        return dataclasses.asdict(self)


@dataclasses.dataclass
class Module:
    path: str          # repo-relative posix path
    tree: ast.Module
    source: str


def _parse(root: str, full: str) -> Optional[Module]:
    rel = os.path.relpath(full, root).replace(os.sep, "/")
    try:
        with open(full, encoding="utf-8") as f:
            src = f.read()
        return Module(rel, ast.parse(src), src)
    except (SyntaxError, UnicodeDecodeError, OSError):
        return None     # unparseable files are ruff's problem


def port_section(readme: str) -> str:
    """The README's port section: from its heading to the next ``## ``."""
    start = readme.find(PORT_SECTION)
    if start < 0:
        return ""
    end = readme.find("\n## ", start + len(PORT_SECTION))
    return readme[start:end if end >= 0 else len(readme)]


class Tree:
    """Parsed repo snapshot: the port's modules, its evidence, its docs."""

    def __init__(self, root: str, modules: Dict[str, Module],
                 texts: Dict[str, str]):
        self.root = root
        self.modules = modules
        self._texts = texts

    @classmethod
    def load(cls, root: str) -> "Tree":
        root = os.path.abspath(root)
        modules: Dict[str, Module] = {}
        top = os.path.join(root, *SUBJECT_DIR.split("/"))
        for dirpath, dirnames, filenames in os.walk(top):
            dirnames[:] = [d for d in sorted(dirnames) if d not in SKIP_DIRS]
            for fn in sorted(filenames):
                if fn.endswith(".py"):
                    mod = _parse(root, os.path.join(dirpath, fn))
                    if mod is not None:
                        modules[mod.path] = mod
        tests_dir, prefix, suffix = TEST_GLOB
        tdir = os.path.join(root, tests_dir)
        names = sorted(os.listdir(tdir)) if os.path.isdir(tdir) else []
        evidence = [os.path.join(tdir, fn) for fn in names
                    if fn.startswith(prefix) and fn.endswith(suffix)]
        evidence += [os.path.join(root, fn) for fn in EVIDENCE_FILES]
        for full in evidence:
            if os.path.isfile(full):
                mod = _parse(root, full)
                if mod is not None:
                    modules[mod.path] = mod
        texts = {}
        for doc in ("DESIGN.md", "README.md"):
            p = os.path.join(root, doc)
            if os.path.isfile(p):
                with open(p, encoding="utf-8") as f:
                    texts[doc] = f.read()
        return cls(root, modules, texts)

    def text(self, name: str) -> Optional[str]:
        return self._texts.get(name)

    def docs(self) -> str:
        """Where a registry key must be documented: DESIGN.md and the
        README's port section."""
        return "\n".join([self._texts.get("DESIGN.md", ""),
                          port_section(self._texts.get("README.md", ""))])

    def src_modules(self) -> Iterator[Module]:
        """Modules under ``src/repro_torch/``, the rule *subjects*."""
        for path, mod in self.modules.items():
            if path.startswith(SUBJECT_DIR + "/"):
                yield mod

    def test_sources(self) -> str:
        """Concatenated raw text of the evidence: the port's tests and
        ``chip_smoke.py`` (R004)."""
        return "\n".join(m.source for p, m in sorted(self.modules.items())
                         if not p.startswith(SUBJECT_DIR + "/"))


# ---------------------------------------------------------------------------
# import/alias resolution
# ---------------------------------------------------------------------------


def import_table(mod: ast.Module) -> Dict[str, str]:
    """Maps local name -> dotted origin for a module's imports.

    ``import numpy as np``              -> {"np": "numpy"}
    ``from repro_torch import rng``     -> {"rng": "repro_torch.rng"}
    ``import time``                     -> {"time": "time"}
    ``from time import time``           -> {"time": "time.time"}
    ``from repro_torch.trace import record as tr``
                                        -> {"tr": "repro_torch.trace.record"}
    """
    table: Dict[str, str] = {}
    for node in ast.walk(mod):
        if isinstance(node, ast.Import):
            for alias in node.names:
                table[alias.asname or alias.name.split(".")[0]] = (
                    alias.name if alias.asname else alias.name.split(".")[0])
        elif isinstance(node, ast.ImportFrom) and node.module:
            for alias in node.names:
                table[alias.asname or alias.name] = (
                    f"{node.module}.{alias.name}")
    return table


def dotted_name(node: ast.AST) -> Optional[str]:
    """``a.b.c`` attribute/name chain as a dotted string, else None."""
    parts: List[str] = []
    while isinstance(node, ast.Attribute):
        parts.append(node.attr)
        node = node.value
    if isinstance(node, ast.Name):
        parts.append(node.id)
        return ".".join(reversed(parts))
    return None


def resolve_call(node: ast.Call, imports: Dict[str, str]) -> Optional[str]:
    """Fully-qualified dotted name of a call target, import-resolved.

    ``np.random.default_rng(...)`` with ``import numpy as np`` resolves to
    ``numpy.random.default_rng``; plain builtins resolve to themselves.
    """
    name = dotted_name(node.func)
    if name is None:
        return None
    head, _, rest = name.partition(".")
    origin = imports.get(head)
    if origin is None:
        return name
    return f"{origin}.{rest}" if rest else origin


def functions(mod: ast.Module) -> Dict[str, ast.AST]:
    """{qualname: FunctionDef} for module-level functions and methods
    (methods as ``Class.method``)."""
    out: Dict[str, ast.AST] = {}
    for node in mod.body:
        if isinstance(node, (ast.FunctionDef, ast.AsyncFunctionDef)):
            out[node.name] = node
        elif isinstance(node, ast.ClassDef):
            for sub in node.body:
                if isinstance(sub, (ast.FunctionDef, ast.AsyncFunctionDef)):
                    out[f"{node.name}.{sub.name}"] = sub
    return out


def docstrings(mod: ast.Module) -> Iterator[Tuple[int, str]]:
    """(line, text) of every docstring in the module."""
    for node in ast.walk(mod):
        if isinstance(node, (ast.Module, ast.ClassDef, ast.FunctionDef,
                             ast.AsyncFunctionDef)):
            doc = ast.get_docstring(node, clean=False)
            if doc:
                first = node.body[0]
                yield first.lineno, doc


# ---------------------------------------------------------------------------
# the port's scenario registries: dict literals keyed by model name
# ---------------------------------------------------------------------------

#: registry name -> kind; the port fills its registries as module-level
#: dict literals (``swarm/scenario.py``) where the reference calls
#: ``register_*``, and both forms are recognised
REGISTRY_DICTS = {"MOBILITY_MODELS": "mobility",
                  "CHANNEL_MODELS": "channel",
                  "CHANNEL_EDGE_MODELS": "edge channel",
                  "FAULT_MODELS": "fault"}
REGISTER_FUNCS = {"register_mobility": "mobility",
                  "register_channel": "channel",
                  "register_channel_edges": "edge channel",
                  "register_fault": "fault"}


def registry_entries(mod: ast.Module) -> Iterator[
        Tuple[str, str, int, List[ast.AST]]]:
    """(kind, key, line, callables) of every registered scenario model:
    each ``register_*("key", fn, ...)`` call and each ``"key": value``
    entry of a registry dict literal (a value that is a call, such as
    ``MobilityModel(init, step)``, registers its arguments)."""
    for node in ast.walk(mod):
        if isinstance(node, ast.Call):
            fname = (dotted_name(node.func) or "").split(".")[-1]
            if fname in REGISTER_FUNCS and node.args and isinstance(
                    node.args[0], ast.Constant) and isinstance(
                    node.args[0].value, str):
                yield (REGISTER_FUNCS[fname], node.args[0].value,
                       node.lineno, list(node.args[1:]))
        targets, value = [], None
        if isinstance(node, ast.Assign):
            targets, value = node.targets, node.value
        elif isinstance(node, ast.AnnAssign) and node.value is not None:
            targets, value = [node.target], node.value
        names = [t.id for t in targets if isinstance(t, ast.Name)]
        kind = next((REGISTRY_DICTS[n] for n in names
                     if n in REGISTRY_DICTS), None)
        if kind is None or not isinstance(value, ast.Dict):
            continue
        for k, v in zip(value.keys, value.values, strict=True):
            if isinstance(k, ast.Constant) and isinstance(k.value, str):
                fns = list(v.args) if isinstance(v, ast.Call) else [v]
                yield kind, k.value, k.lineno, fns
