"""Chrome-trace / Perfetto timeline export (DESIGN.md §10.4), a copy of
``repro/trace/export.py``.

One decoded run → the Trace Event JSON format both ``chrome://tracing``
and https://ui.perfetto.dev load directly:

  * one complete (``"X"``) slice per completed task on its completion
    node's track, spanning creation → completion (µs timebase);
  * one instant (``"i"``) event per dropped task at its drop time;
  * **without hop records**: a flow arrow (``"s"`` → ``"f"``) from the
    generating node's track to the completion node's for every task that
    was forwarded at least once — the net src→dst relocation, with the
    hop count and total in-flight time in ``args``;
  * **with hop records** (``decode_hops`` output passed as ``hops``):
    the net arrow is replaced by the true per-hop timeline — per
    delivered hop an in-flight ``"hop"`` slice on the *sender's* track
    (its single outgoing radio is busy exactly then), a ``"queue"``
    slice on the visited *receiving* node's track for the queue-wait
    tail (stall ticks: receiver contention / fault stalls), and one flow
    arrow per hop from departure to delivery.

  * **with the state stream** (``decode_state`` output passed as
    ``state``): Perfetto **counter tracks** (``"C"`` events) next to the
    slices — per recorded node a φ lane, a queue-depth lane and a
    cumulative-energy lane (``e_comp_j``/``e_tx_j`` stack), plus
    swarm-level counters (queue depth mean/max, tasks
    in-flight/completed/dropped, φ mean/min/max, total energy, queue
    Jain) from the system gauges.

Everything is stamped from record fields only — no wall clock — so the
export is deterministic in the records.
"""
from __future__ import annotations

import json
from typing import Dict, List, Mapping, Optional

from repro_torch.trace import schema

_US = 1e6     # trace event timestamps are microseconds


def _base(dec: Mapping, i: int, ph: str) -> Dict:
    return {"ph": ph, "pid": 0, "tid": int(dec["dst"][i])}


def hop_trace_events(hops: Mapping, tick_s: Optional[float] = None
                     ) -> List[Dict]:
    """Decoded single-run HopRecords → per-hop Trace Event list.

    ``tick_s`` sizes the queue-wait slice (``stall_ticks`` is in ticks);
    without it stall ticks still ride in ``args`` but no queue slice is
    drawn (its wall-time extent would be unknown).
    """
    events: List[Dict] = []
    for i in range(len(hops["seq"])):
        seq = int(hops["seq"][i])
        src, dst = int(hops["src"][i]), int(hops["dst"][i])
        t0, t1 = float(hops["t_depart"][i]), float(hops["t_arrive"][i])
        stall = int(hops["stall_ticks"][i])
        args = {"seq": seq, "src": src, "dst": dst,
                "bits": float(hops["bits"][i]),
                "boundary_layer": int(hops["boundary_layer"][i]),
                "stall_ticks": stall}
        wait_s = stall * tick_s if tick_s is not None else None
        if wait_s is not None:
            args["queue_wait_s"] = wait_s
            args["in_flight_s"] = (t1 - t0) - wait_s
        # the sender's radio is busy only while bits are on the air: with
        # tick_s known the slice is the in-flight interval and the stall
        # tail renders as its own queue slice below; without it, the full
        # span (the wait's wall-time extent is unknown)
        fly_s = (t1 - t0) - wait_s if wait_s is not None else (t1 - t0)
        events.append({"ph": "X", "pid": 0, "tid": src,
                       "name": f"hop {src}→{dst}", "cat": "hop",
                       "ts": t0 * _US, "dur": fly_s * _US,
                       "args": args})
        if wait_s is not None and stall > 0:
            # queue-wait at the visited receiving node, adjacent to the
            # in-flight slice (mid-flight fault stalls are approximated
            # into the same tail — the record stores a total, not phases)
            events.append({"ph": "X", "pid": 0, "tid": dst,
                           "name": "queue-wait", "cat": "queue",
                           "ts": (t1 - wait_s) * _US, "dur": wait_s * _US,
                           "args": args})
        events.append({"ph": "s", "pid": 0, "tid": src, "id": seq,
                       "cat": "transfer", "name": "xfer", "ts": t0 * _US,
                       "args": args})
        events.append({"ph": "f", "pid": 0, "tid": dst, "bp": "e",
                       "id": seq, "cat": "transfer", "name": "xfer",
                       "ts": t1 * _US})
    return events


def state_counter_events(state: Mapping, run: int = 0) -> List[Dict]:
    """Decoded state stream → Perfetto counter-track (``"C"``) events.

    One φ / queue-depth / energy counter lane per recorded node (its own
    pid so the lanes group under a "swarm state" process, clear of the
    slice tracks) and swarm-level lanes from the system gauges.  ``run``
    picks the Monte-Carlo run to render (counters are per-run series; the
    aggregate surfaces live in ``state_indices``, not the timeline).
    """
    ts_s = (state["t"][run] if "t" in state
            else state["epoch"].astype(float))
    events: List[Dict] = [
        {"ph": "M", "pid": 1, "name": "process_name",
         "args": {"name": "swarm state"}}]
    if "phi" in state:
        phi = state["phi"][run]                       # [S, M]
        depth = state["queue_depth"][run]
        e_comp = state["e_comp_j"][run]
        e_tx = state["e_tx_j"][run]
        for m in range(phi.shape[1]):
            for s in range(phi.shape[0]):
                ts = float(ts_s[s]) * _US
                events.append({"ph": "C", "pid": 1, "name": f"uav {m} phi",
                               "ts": ts,
                               "args": {"phi": float(phi[s, m])}})
                events.append({"ph": "C", "pid": 1,
                               "name": f"uav {m} queue", "ts": ts,
                               "args": {"depth": float(depth[s, m])}})
                events.append({"ph": "C", "pid": 1,
                               "name": f"uav {m} energy_j", "ts": ts,
                               "args": {"e_comp_j": float(e_comp[s, m]),
                                        "e_tx_j": float(e_tx[s, m])}})
    if "queue_depth_mean" in state:
        series = (
            ("swarm queue depth", {"mean": state["queue_depth_mean"],
                                   "max": state["queue_depth_max"]}),
            ("swarm tasks", {"in_flight": state["tasks_in_flight"],
                             "completed": state["completed"],
                             "dropped": state["dropped"]}),
            ("swarm phi", {"mean": state["phi_mean"],
                           "min": state["phi_min"],
                           "max": state["phi_max"]}),
            ("swarm energy_j", {"total": state["energy_j"]}),
            ("swarm queue jain", {"jain": state["queue_jain"]}),
        )
        for s in range(len(state["epoch"])):
            ts = float(ts_s[s]) * _US
            for name, cols in series:
                events.append({"ph": "C", "pid": 1, "name": name, "ts": ts,
                               "args": {k: float(v[run][s])
                                        for k, v in cols.items()}})
    return events


def chrome_trace_events(dec: Mapping, hops: Optional[Mapping] = None,
                        tick_s: Optional[float] = None,
                        state: Optional[Mapping] = None) -> List[Dict]:
    """Decoded single-run records → Trace Event list (chronological).

    With ``hops`` (a ``decode_hops`` dict for the same run) the per-task
    net src→dst arrows are replaced by true per-hop slices + one flow
    arrow per hop (see module docstring).
    """
    tracks = sorted({*map(int, dec["src"]), *map(int, dec["dst"]),
                     *(map(int, hops["src"]) if hops is not None else ()),
                     *(map(int, hops["dst"]) if hops is not None else ())})
    events: List[Dict] = [
        {"ph": "M", "pid": 0, "name": "process_name",
         "args": {"name": "swarm"}}]
    events += [{"ph": "M", "pid": 0, "tid": t, "name": "thread_name",
                "args": {"name": f"uav {t}"}} for t in tracks]
    order = sorted(range(len(dec["seq"])),
                   key=lambda i: (float(dec["created_t"][i]),
                                  int(dec["seq"][i])))
    for i in order:
        seq = int(dec["seq"][i])
        args = {"seq": seq, "src": int(dec["src"][i]),
                "hops": int(dec["hops"][i]),
                "exit_label": int(dec["exit_label"][i]),
                "layers": int(dec["layers"][i]),
                "energy_j": float(dec["energy_j"][i]),
                "tx_time_s": float(dec["tx_time_s"][i])}
        if dec["is_dropped"][i]:
            events.append({**_base(dec, i, "i"), "s": "t",
                           "name": f"drop {seq}", "cat": "drop",
                           "ts": dec["completed_t"][i] * _US,
                           "args": args})
            continue
        events.append({**_base(dec, i, "X"), "name": f"task {seq}",
                       "cat": "task", "ts": dec["created_t"][i] * _US,
                       "dur": dec["latency_s"][i] * _US, "args": args})
        if hops is None and dec["hops"][i] > 0:
            # no hop stream: fall back to the net relocation arrow
            events.append({"ph": "s", "pid": 0, "tid": int(dec["src"][i]),
                           "id": seq, "cat": "transfer", "name": "xfer",
                           "ts": dec["created_t"][i] * _US, "args": args})
            events.append({**_base(dec, i, "f"), "bp": "e", "id": seq,
                           "cat": "transfer", "name": "xfer",
                           "ts": dec["completed_t"][i] * _US})
    if hops is not None:
        events += hop_trace_events(hops, tick_s)
    if state is not None:
        events += state_counter_events(state)
    return events


def write_chrome_trace(path: str, dec: Mapping,
                       hops: Optional[Mapping] = None,
                       tick_s: Optional[float] = None,
                       state: Optional[Mapping] = None) -> str:
    """Write ``{"traceEvents": [...]}`` JSON; returns ``path``."""
    doc = {"traceEvents": chrome_trace_events(dec, hops, tick_s, state),
           "displayTimeUnit": "ms",
           "otherData": {"schema": list(schema.FIELDS),
                         "hop_schema": list(schema.HOP_FIELDS)}}
    if state is not None:
        doc["otherData"]["state_schema"] = list(schema.STATE_GAUGES)
        doc["otherData"]["state_sys_schema"] = list(schema.SYS_GAUGES)
    with open(path, "w") as f:
        json.dump(doc, f)
    return path
