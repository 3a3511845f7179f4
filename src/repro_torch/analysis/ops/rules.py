"""Ops-tier rules J001–J004: lint the recorded op streams (the port of
``repro/analysis/jaxpr/rules.py``; DESIGN.md §15.2).

Each rule takes the shared ``{name: TracedTarget}`` map (one recording
per target and strategy, reused by every rule) plus the repo root, and
yields :class:`repro_torch.analysis.astutil.Finding` rows — the same
baseline matching and CLI rendering as the AST tier.  J005 (op-stream
fingerprint stability) lives in ``fingerprint.py``.
"""
from __future__ import annotations

import os
from typing import Dict, Iterable, List, Optional, Set, Tuple

from repro_torch.analysis.astutil import Finding
from repro_torch.analysis.ops.record import (HOST_DATA, IDX_CLIPPED,
                                             IDX_REDIRECTED, IN_RUN_SIM,
                                             IN_SUMMARIZE, SCOPED_OPS,
                                             tensor_bytes)
from repro_torch.analysis.ops.targets import TracedTarget

#: program-level findings (J002 / J004) anchor here, as the reference's
#: anchor at its targets.py
TARGETS_FILE = "src/repro_torch/analysis/ops/targets.py"

# --------------------------------------------------------------------------
# J001 — no cross-node float reductions inside the loop (DESIGN.md §8.2)
# --------------------------------------------------------------------------

#: reductions that collapse an axis by *accumulation*: the float cases
#: reassociate with the batch shape and the launch grid.  min / max /
#: argmin / argmax / any / all are exact in any order, and never listed.
ACCUM_REDUCE = SCOPED_OPS


def _drops_n(ev, n_axis: int) -> bool:
    """True when the call consumes an N-sized axis its output lacks.

    Per-node neighbour aggregations ([R, N, N] → [R, N], Eqs. 10–13) keep
    an N-sized output axis and stay allowed; only full cross-node
    collapses (→ [R], or → shapes with no N axis) are the §8.2 hazard."""
    in_has = any(n_axis in sig[0] for sig in ev.ins)
    out_has = any(n_axis in sig[0] for sig in ev.outs)
    return in_has and not out_has


def _is_float(ev) -> bool:
    return bool(ev.ins) and ev.ins[0][1].is_floating_point


def check_j001(traced: Dict[str, TracedTarget], root: str
               ) -> Iterable[Finding]:
    """J001: in-loop cross-node float reductions break backend parity.

    A call is in the loop when it ran inside ``run_sim`` but not inside
    ``summarize``.  Integer and bool accumulations are exact; float ones
    over the N axis must move to per-node accumulators summed in
    ``summarize``, or carry a baseline entry documenting why the collapse
    is safe.  ``core.fp.fsum``'s f64 accumulation is the correctly
    rounded sum for the simulator's operands, but not in every case, so it
    is flagged like any other sum."""
    del root
    seen: Set[Tuple] = set()
    for tt in traced.values():
        if tt.n_axis is None:
            continue
        for rec in tt.rec32.values():
            for ev in rec.unique():
                if (ev.op not in ACCUM_REDUCE
                        or ev.flags & (IN_RUN_SIM | IN_SUMMARIZE)
                        != IN_RUN_SIM
                        or not _drops_n(ev, tt.n_axis)
                        or not _is_float(ev)):
                    continue
                if ev.site is None:
                    fname, line, func = TARGETS_FILE, 0, tt.name
                else:
                    fname, line, func = ev.site
                key = ("J001", fname, line, func, ev.op)
                if key in seen:
                    continue
                seen.add(key)
                yield Finding(
                    "J001", fname, line, func,
                    f"in-loop cross-node reduction: '{ev.name}' collapses "
                    f"the N axis to a float inside the simulator loop "
                    f"(recorded via {tt.name}); float sums reassociate "
                    f"with the batch shape and break cross-backend "
                    f"bit-identity (DESIGN.md §8.2) — accumulate per node "
                    f"and reduce in summarize, or baseline with a reason")


# --------------------------------------------------------------------------
# J002 — dtype drift between float32 and float64 default dtypes
# --------------------------------------------------------------------------


def _dtype_drift(a, b) -> Optional[str]:
    """How the float64 run's event ``b`` differs from the float32 run's
    ``a`` (None: it does not)."""
    if (a.name, a.site) != (b.name, b.site):
        return f"the op stream diverges ({a.name} vs {b.name})"
    dt32 = tuple(sig[1] for sig in a.outs)
    if dt32 != b.outs:
        return (f"{a.name} returns {[str(d) for d in dt32]} vs "
                f"{[str(d) for d in b.outs]}")
    return None


def check_j002(traced: Dict[str, TracedTarget], root: str
               ) -> Iterable[Finding]:
    """J002: the program's types must not depend on the default dtype.

    The reference compares traces under x32 and x64; the port's global
    switch is ``torch.set_default_dtype``.  Two signals: (a) the float64
    run *raising* (a kernel or a check that only fails once a factory or a
    Python float follows the default — latent until someone flips it);
    (b) a call whose output dtypes differ between the two runs (an
    unpinned factory, ``torch.tensor`` of a Python float, or an integer
    tensor promoted by a Python float: the default dtype leaking into the
    program).  Torch has no weak types, so the reference's third signal
    has no counterpart."""
    del root
    for tt in traced.values():
        if tt.err64 is not None:
            yield Finding(
                "J002", TARGETS_FILE, 0, tt.name,
                f"target '{tt.name}' fails under the float64 default "
                f"dtype ({type(tt.err64).__name__}): "
                f"{str(tt.err64).splitlines()[0][:160]} — a dtype in the "
                f"program depends on torch's default dtype")
            continue
        drift: List = []
        for s, r32 in tt.rec32.items():
            r64 = tt.rec64.get(s)
            if r64 is None:
                continue
            verdict: Dict[Tuple[int, int], Optional[str]] = {}
            for i, (a, b) in enumerate(zip(r32.events, r64.events)):
                pair = (id(a), id(b))     # both recordings intern events
                if pair not in verdict:
                    verdict[pair] = _dtype_drift(a, b)
                what = verdict[pair]
                if what is not None:
                    drift.append((s, i, a, what))
                    if what.startswith("the op stream"):
                        break
            if len(r32.events) != len(r64.events) and not drift:
                drift.append((s, min(len(r32), len(r64)), None,
                              f"{len(r32)} vs {len(r64)} ops"))
        if drift:
            s, i, ev, what = drift[0]
            at = (f" at {ev.site.file}:{ev.site.line} ({ev.site.func})"
                  if ev is not None and ev.site is not None else "")
            yield Finding(
                "J002", TARGETS_FILE, 0, tt.name,
                f"dtype drift in target '{tt.name}': {len(drift)} call(s) "
                f"change under the float64 default dtype (first: op {i} "
                f"of strategy {s}{at}: {what}); an unpinned default dtype "
                f"is leaking into the program")


# --------------------------------------------------------------------------
# J003 — clamp- or where-made indices of gathers and scatters
# --------------------------------------------------------------------------

#: inline annotation marker acknowledging a deliberate clamp/redirect
OOB_MARK = "# oob:"
#: source-window (lines) searched around the anchored line
_OOB_WINDOW = 2

# module-level source cache for _is_annotated, keyed by (root, fname) —
# a memo, not shared state: entries are only ever the file's lines
_SRC_CACHE: Dict[Tuple[str, str], List[str]] = {}


def _is_annotated(root: str, fname: str, line: int) -> bool:
    ck = (root, fname)
    if ck not in _SRC_CACHE:
        try:
            with open(os.path.join(root, fname)) as f:
                _SRC_CACHE[ck] = f.readlines()
        except OSError:
            _SRC_CACHE[ck] = []
    lines = _SRC_CACHE[ck]
    lo = max(0, line - 1 - _OOB_WINDOW)
    hi = min(len(lines), line + _OOB_WINDOW)
    return any(OOB_MARK in ln for ln in lines[lo:hi])


def check_j003(traced: Dict[str, TracedTarget], root: str
               ) -> Iterable[Finding]:
    """J003: every clamp-made or where-redirected index must be annotated.

    Torch indexing has no out-of-bounds modes: where the reference's
    gathers and scatters clip (CLIP) or drop (FILL_OR_DROP), the port
    clamps the index (``clamp*``) or redirects it with ``where`` to a
    spare slot, and on CUDA an index that escapes anyway kills the
    context.  Each such site — an index op (``__getitem__`` /
    ``__setitem__`` with a tensor index, ``gather``, ``scatter*``,
    ``index_put*``, ``index_select``, ``take_along_dim`` …) whose index a
    ``clamp*`` made or a ``where`` redirected — must carry an inline
    ``# oob: <why the clamp or redirect is correct>`` comment within two
    lines of the call (or a baseline entry)."""
    seen: Set[Tuple] = set()
    for tt in traced.values():
        for rec in tt.rec32.values():
            for ev in rec.unique():
                if not ev.flags & (IDX_CLIPPED | IDX_REDIRECTED):
                    continue
                if ev.site is None:
                    continue                 # torch-internal: not ours
                fname, line, func = ev.site
                key = ("J003", fname, line)
                if key in seen:
                    continue
                seen.add(key)
                if _is_annotated(root, fname, line):
                    continue
                how = ("clamp-made" if ev.flags & IDX_CLIPPED
                       else "where-redirected")
                yield Finding(
                    "J003", fname, line, func,
                    f"unannotated {how} index of '{ev.name}': an "
                    f"out-of-range index is silently clamped or dropped "
                    f"here (recorded via {tt.name}); add an "
                    f"'{OOB_MARK} <reason>' comment within {_OOB_WINDOW} "
                    f"lines or baseline with a reason")


# --------------------------------------------------------------------------
# J004 — host data copied into a program
# --------------------------------------------------------------------------

#: bytes of host data one program may copy in before we call it bloat
#: (the reference's cap on closed-over constants; at N = 64k a stray
#: [N, N] table is 16 GiB)
J004_MAX_CONST_BYTES = 1 << 20


def check_j004(traced: Dict[str, TracedTarget], root: str
               ) -> Iterable[Finding]:
    """J004: large host data made into tensors inside a program call.

    The reference's constants closed into a jaxpr are per-compile
    payload; the port's counterpart is host data turned into tensors
    inside the call (``torch.tensor`` / ``as_tensor`` of host values) and,
    on the card, every copy from the host to the device: per-call payload
    that a sweep pays at every point.  The largest total over the
    target's recordings counts."""
    del root
    for tt in traced.values():
        total, worst = 0, None
        for rec in tt.rec32.values():
            run_total = 0
            for ev in rec.events:
                if ev.flags & HOST_DATA:
                    nbytes = sum(tensor_bytes(sig) for sig in ev.outs)
                    run_total += nbytes
                    if worst is None or nbytes > worst[0]:
                        worst = (nbytes, ev)
            total = max(total, run_total)
        if total > J004_MAX_CONST_BYTES:
            nbytes, ev = worst
            at = (f"{ev.site.file}:{ev.site.line}" if ev.site is not None
                  else "?")
            yield Finding(
                "J004", TARGETS_FILE, 0, tt.name,
                f"host-data bloat in target '{tt.name}': {total} bytes "
                f"copied from the host inside one call (largest "
                f"{ev.name} at {at}, {nbytes} bytes; cap "
                f"{J004_MAX_CONST_BYTES}); pass big tables as device "
                f"arguments so sweep points share them")
