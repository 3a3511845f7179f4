"""J005 — op-stream fingerprint stability (the port of
``repro/analysis/jaxpr/fingerprint.py``; DESIGN.md §15.3).

The reference's executors compile one program per ``(cfg, n)`` pair and
assume that *data-like* config changes — gamma, arrival rates, channel
parameters — retrace to the **same** program.  The port compiles
nothing, but the contract carries over as the eager program's shape: a
data-only sweep must run the same op stream at every point, or a host
branch on a float, a shape derived from a parameter or a data-dependent
loop has crept into the loop.  The port needs it for what the reference
needs it for — one program per structural group — and for capturing a
point's step once and replaying it for every data point (CUDA graphs),
which only an invariant op stream allows.

* :func:`program_fingerprint` — sha256 of a *canonical* op stream: each
  call's name, its tensors' shapes and dtypes, its abstracted non-tensor
  arguments (a float's value dropped, ints, strings, dtypes and index
  structure kept) and the ``kernel:`` launch events, without call sites
  or devices.  Two recordings share a fingerprint iff they run the same
  program shape.
* :func:`structural_signature` — splits a :class:`SweepPoint` into the
  fields that *legitimately* change the program (n, num_runs, every
  non-float config field, the float fields that set the loop lengths, and
  the strategy, on which the port branches in Python) versus the
  data-like rest.
* :func:`sweep_fingerprint_table` — per-point fingerprints and a
  stability verdict for a sweep.
* :func:`check_j005` — the repo-level rule: record stand-in data-only
  sweeps over the real ``run_sim`` and fail if any same-signature group
  runs more than one distinct program.
"""
from __future__ import annotations

import dataclasses
import hashlib
from typing import Any, Dict, Iterable, List, Optional, Tuple

from repro_torch.analysis.astutil import Finding
from repro_torch.analysis.ops.record import Recording

#: float config fields that legitimately change program structure: they
#: set the epoch/tick loop lengths (Python-computed trip counts)
STRUCTURAL_FLOATS = frozenset({"sim_time_s", "decision_period_s", "tick_s"})

#: hex digits shown in tables / finding messages (full digest in hashes)
SHORT = 12


# --------------------------------------------------------------------------
# canonical op-stream hashing
# --------------------------------------------------------------------------


def _canon_event(ev) -> str:
    ins = ",".join(f"{sig[1]}{list(sig[0])}" for sig in ev.ins)
    outs = ",".join(f"{sig[1]}{list(sig[0])}" for sig in ev.outs)
    return f"{ev.name}[{ev.args!r}]({ins})->({outs})"


def program_fingerprint(recording: Recording) -> str:
    """sha256 hex digest of the canonicalized op stream."""
    memo: Dict[int, bytes] = {}       # by id: a recording interns events
    h = hashlib.sha256()
    for ev in recording.events:
        line = memo.get(id(ev))
        if line is None:
            line = memo[id(ev)] = (_canon_event(ev) + "\n").encode()
        h.update(line)
    return h.hexdigest()


def fingerprint_fn(fn, *args) -> str:
    """Record ``fn(*args)`` and fingerprint the program."""
    from repro_torch.analysis.ops.targets import record
    return program_fingerprint(record(fn, args))


# --------------------------------------------------------------------------
# sweep-point fingerprints
# --------------------------------------------------------------------------


def structural_signature(point) -> Tuple[Tuple[str, Any], ...]:
    """The fields of a SweepPoint that may legitimately move the
    fingerprint.  Unlike the reference's (whose executors keep the
    strategy traced, one program for all five), the port branches on the
    strategy in Python, so it is structural here: points differing only in
    strategy run different op streams by design."""
    cfg = point.cfg
    sig: List[Tuple[str, Any]] = [("n", point.n),
                                  ("num_runs", point.num_runs),
                                  ("strategy", point.strategy)]
    for f in dataclasses.fields(type(cfg)):
        val = getattr(cfg, f.name)
        if not isinstance(val, float) or f.name in STRUCTURAL_FLOATS:
            sig.append((f.name, val))
    return tuple(sig)


# (device, point config, strategy, n) -> fingerprint: a process records
# each stand-in point once
_POINTS: Dict[Tuple, str] = {}


def point_fingerprint(point, device=None) -> str:
    """Fingerprint the single-run simulator program of one sweep point —
    the unit every executor backend batches (vmap, streaming and sharded
    all run this loop over their run axis).  ``device``: CUDA unless the
    caller asks for another device."""
    from repro_torch import rng
    from repro_torch.analysis.ops.targets import record, warm
    from repro_torch.device import resolve_device
    from repro_torch.swarm.simulator import run_sim
    dev = resolve_device(device)
    cfg, n = point.cfg, point.n
    # num_runs never reaches run_sim (the run axis is the keys')
    key = (str(dev), dataclasses.replace(cfg, num_runs=0), point.strategy,
           n)
    if key not in _POINTS:
        keys = rng.split(rng.PRNGKey(0, device=dev), 1)

        def fn(k):
            return run_sim(k, cfg, point.strategy, n)
        warm(fn, (keys,))
        _POINTS[key] = program_fingerprint(record(fn, (keys,)))
    return _POINTS[key]


def group_fingerprints(labeled: Iterable[Tuple[Any, str, Any]]
                       ) -> List[Dict[str, Any]]:
    """Group (signature, label, fingerprint) rows; one dict per
    signature group with its distinct fingerprints and a verdict."""
    groups: Dict[Any, Dict[str, Any]] = {}
    for sig, label, fp in labeled:
        g = groups.setdefault(sig, {"labels": [], "fingerprints": {}})
        g["labels"].append(label)
        g["fingerprints"].setdefault(fp, []).append(label)
    out = []
    for sig, g in groups.items():
        out.append({
            "signature": dict(sig) if isinstance(sig, tuple) else sig,
            "points": g["labels"],
            "distinct_programs": len(g["fingerprints"]),
            "stable": len(g["fingerprints"]) <= 1,
            "programs": {fp[:SHORT]: labels
                         for fp, labels in g["fingerprints"].items()},
        })
    return out


def sweep_fingerprint_table(spec, max_points: Optional[int] = None,
                            device=None) -> Dict[str, Any]:
    """Fingerprint every point of a sweep on ``device``: per-point
    fingerprints, the structural groups and a stability verdict, so a
    benchmark can name which point started running another program.

    ``max_points`` caps recording cost for very large grids (points beyond
    the cap are reported as skipped, never silently dropped).
    """
    points = spec.expand()
    skipped = 0
    if max_points is not None and len(points) > max_points:
        skipped = len(points) - max_points
        points = points[:max_points]
    rows = []
    table: Dict[str, str] = {}
    for p in points:
        fp = point_fingerprint(p, device)
        table[p.label] = fp[:SHORT]
        rows.append((structural_signature(p), p.label, fp))
    groups = group_fingerprints(rows)
    return {
        "sweep": spec.name,
        "points": table,
        "groups": groups,
        "distinct_programs": len(set(table.values())),
        "unstable_groups": [g for g in groups if not g["stable"]],
        "skipped_points": skipped,
        "stable": all(g["stable"] for g in groups),
    }


# --------------------------------------------------------------------------
# the repo-level rule
# --------------------------------------------------------------------------


def _standin_specs():
    """Data-only sweeps over the real simulator (the reference's): every
    axis below moves floats that must **not** move the program.  Small n
    and a short simulation keep the recordings cheap."""
    from repro_torch.configs import SwarmConfig
    from repro_torch.fleet.sweep import SweepSpec
    base = SwarmConfig(num_workers=13, sim_time_s=1.0, num_runs=2)
    sparse = dataclasses.replace(base, neighbor_mode="sparse", neighbor_k=4)
    return [
        SweepSpec.build("j005_gamma", base,
                        axes={"gamma": (0.01, 0.02, 0.05)},
                        strategies=(0, 4), num_runs=2),
        SweepSpec.build("j005_load", base,
                        axes={"task_period_s": (0.03, 0.06),
                              "tx_power_dbm": (24.0, 30.0)},
                        strategies=(4,), num_runs=2),
        SweepSpec.build("j005_sparse_gamma", sparse,
                        axes={"gamma": (0.01, 0.05)},
                        strategies=(4,), num_runs=2),
    ]


#: where J005 findings anchor (the sweep module, as the reference's)
SWEEP_FILE = "src/repro_torch/fleet/sweep.py"


def check_j005(traced, root: str, device=None,
               tables: Optional[List[Dict[str, Any]]] = None
               ) -> Iterable[Finding]:
    """J005: points differing only in data must run identical programs.

    ``traced`` (the shared target map) is unused — this rule records its
    own stand-in sweeps because the hazard lives in the *sweep grid*, not
    in any single target; same signature for registry uniformity.  Each
    sweep's table is appended to ``tables`` when given."""
    del traced, root
    for spec in _standin_specs():
        table = sweep_fingerprint_table(spec, device=device)
        if tables is not None:
            tables.append(table)
        for g in table["unstable_groups"]:
            programs = "; ".join(
                f"{fp}: {', '.join(labels[:3])}"
                f"{'…' if len(labels) > 3 else ''}"
                for fp, labels in g["programs"].items())
            yield Finding(
                "J005", SWEEP_FILE, 0, f"sweep:{spec.name}",
                f"op-stream instability: {g['distinct_programs']} distinct "
                f"programs in one structural-signature group of stand-in "
                f"sweep '{spec.name}' ({programs}) — a data-like config "
                f"field is leaking into program structure")
