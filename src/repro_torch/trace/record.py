"""In-loop TaskRecord, HopRecord and state-stream capture, port of
``repro/trace/record.py`` (DESIGN.md §10.2, §10.5, §12).

A fixed-capacity record buffer rides in the simulator's state; every task
completion (and queue-full drop) scatters one :mod:`schema` row into it,
keyed by the task's global sequence number (``swarm/queues.py``).  Each
seq finishes once, so slot ``seq`` is written at most once and the
result does not depend on lane order.  Records whose seq is at or past
the capacity are not captured and are counted in a saturating overflow
counter.  The hop stream is the same design one level down: one row per
delivered transfer, keyed by a hop sequence number assigned at
``transfer.initiate``.

The reference drops the lanes it must not keep (masked-off lanes and
overflowed seqs) by sending them to slot ``capacity`` of a scatter in
``mode="drop"``.  torch has no such mode, and an ``index_put_`` with
repeated indices leaves the kept value undefined on CUDA, so the port's
buffers carry one spare slot, ``[R, capacity + 1, F]``: every dropped lane
writes the spare slot, no two kept lanes share a slot, and ``summarize``
slices the spare off.  Nothing waits on the host.

The state stream (the flight recorder) is epoch-indexed: sample s holds the
snapshot at the end of epoch ``s * every``.  The port's epoch index is a
host integer, so a non-sampled epoch writes nothing.  Its cross-node sums go
through ``core.fp.fsum`` (exact, then rounded once), so the stream does not
depend on R, the backend or the device.

Attribution state (absent when the stream is off, so the untraced state is
unchanged): ``q_src`` / ``q_energy`` / ``q_txtime`` per queue slot and
``tx_src`` / ``tx_energy`` / ``tx_txtime`` per outgoing transfer (tasks);
``hop_seq`` / ``hop_bits`` / ``hop_layer`` / ``hop_stall`` per outgoing
transfer (hops).
"""
from __future__ import annotations

import torch

from repro_torch.configs import SwarmConfig
from repro_torch.core.fp import div, fma, fsum
from repro_torch.swarm.queues import push
from repro_torch.trace import schema

INT_MAX = torch.iinfo(torch.int32).max


def _zeros(runs, *shape, device, dtype=torch.float32):
    return torch.zeros((runs, *shape), dtype=dtype, device=device)


def enabled(cfg: SwarmConfig) -> bool:
    return cfg.trace_capacity > 0


def init_trace(cfg: SwarmConfig, n: int, runs: int, device) -> dict:
    """Task-stream state for ``init_state``: ``{}`` when the stream is off."""
    if not enabled(cfg):
        return {}
    Q, i32 = cfg.queue_slots, torch.int32
    return {
        "trace_records": schema.empty_buffer(cfg.trace_capacity + 1, runs,
                                             device),
        "trace_overflow": _zeros(runs, device=device, dtype=i32),
        "q_src": _zeros(runs, n, Q, device=device, dtype=i32),
        "q_energy": _zeros(runs, n, Q, device=device),
        "q_txtime": _zeros(runs, n, Q, device=device),
        "tx_src": _zeros(runs, n, device=device, dtype=i32),
        "tx_energy": _zeros(runs, n, device=device),
        "tx_txtime": _zeros(runs, n, device=device),
    }


def hops_enabled(cfg: SwarmConfig) -> bool:
    return cfg.trace_hop_capacity > 0


def init_hops(cfg: SwarmConfig, n: int, runs: int, device) -> dict:
    """Hop-stream state for ``init_state``: ``{}`` when the stream is off."""
    if not hops_enabled(cfg):
        return {}
    i32 = torch.int32
    return {
        "trace_hops": schema.empty_hop_buffer(cfg.trace_hop_capacity + 1,
                                              runs, device),
        "trace_hop_overflow": _zeros(runs, device=device, dtype=i32),
        "hop_counter": _zeros(runs, device=device, dtype=i32),
        # the in-flight hop of each node: its seq, the bits staged at
        # initiation, its boundary layer, the stall ticks so far
        "hop_seq": _zeros(runs, n, device=device, dtype=i32),
        "hop_bits": _zeros(runs, n, device=device),
        "hop_layer": _zeros(runs, n, device=device, dtype=i32),
        "hop_stall": _zeros(runs, n, device=device, dtype=i32),
    }


def state_enabled(cfg: SwarmConfig) -> bool:
    return cfg.trace_state_every > 0


def num_state_samples(cfg: SwarmConfig) -> int:
    """Slot count S = ceil(n_epochs / every) of the state buffers."""
    n_epochs = int(round(cfg.sim_time_s / cfg.decision_period_s))
    return (n_epochs + cfg.trace_state_every - 1) // cfg.trace_state_every


def state_nodes(cfg: SwarmConfig, n: int) -> int:
    """Recorded node-panel width M = min(N, trace_state_nodes or N)."""
    return min(n, cfg.trace_state_nodes or n)


def init_state_stream(cfg: SwarmConfig, n: int, runs: int, device) -> dict:
    """State-stream buffers for ``init_state``: ``{}`` when the stream is
    off."""
    if not state_enabled(cfg):
        return {}
    S, M = num_state_samples(cfg), state_nodes(cfg, n)
    return {
        "trace_state": _zeros(runs, S, M, schema.NUM_STATE_GAUGES,
                              device=device),
        "trace_state_sys": _zeros(runs, S, schema.NUM_SYS_GAUGES,
                                  device=device),
        # epoch of each written slot; -1 marks a slot never written
        "trace_state_epochs": torch.full((runs, S), -1.0,
                                         dtype=torch.float32, device=device),
    }


def write_state(st, epoch_idx: int, t_end: float, cfg: SwarmConfig):
    """Snapshot node gauges and system aggregates at the end of epoch
    ``epoch_idx`` when it is a sampled one (``epoch_idx % every == 0``);
    ``t_end`` is the simulation time at the end of the epoch."""
    every = cfg.trace_state_every
    if epoch_idx % every:
        return st
    slot = epoch_idx // every
    M = st["trace_state"].shape[2]
    n = st["F"].shape[-1]
    q = st["q_active"].sum(-1, dtype=torch.int32).float()
    e_comp = st["proc_gflops"] * cfg.energy_per_gflop_j
    inflight = torch.where(st["tx_active"],
                           torch.clamp_min(st["tx_bits"], 0.0), 0.0)
    st["trace_state"][:, slot] = torch.stack(
        [st["phi"][:, :M], q[:, :M], e_comp[:, :M], st["e_tx"][:, :M],
         st["alive"][:, :M].float(), inflight[:, :M]], dim=-1)
    sq = fsum(q)
    tx_act = st["tx_active"].sum(-1, dtype=torch.int32).float()
    st["trace_state_sys"][:, slot] = torch.stack(
        [torch.full_like(sq, t_end), sq + tx_act, tx_act,
         st["done_count"].float(), st["drop_count"].float(),
         st["gen_count"].float(), div(sq, n), q.amax(-1),
         sq ** 2 / fma(n, fsum(q * q), 1e-12),
         div(fsum(st["phi"]), n), st["phi"].amin(-1), st["phi"].amax(-1),
         fsum(st["e_comp"] + st["e_tx"])], dim=-1)
    st["trace_state_epochs"][:, slot] = float(epoch_idx)
    return st


def _scatter_records(st, key_records, key_overflow, mask, seq, rows):
    """Scatter ``rows`` [R, N, F] into slot ``seq`` [R, N] where ``mask``,
    and count the masked lanes whose seq is past the capacity in the
    saturating overflow counter.  Dropped lanes write the spare slot."""
    buf = st[key_records]
    cap = buf.shape[1] - 1
    slot = torch.where(mask & (seq < cap), seq, cap).long()
    rr = torch.arange(buf.shape[0], device=buf.device)[:, None]
    # oob: the redirect is load-bearing — unmasked lanes and overflowed
    # seqs target the spare slot (cap) so they vanish deterministically
    buf[rr, slot] = rows
    # saturate at int32 max instead of wrapping
    inc = (mask & (seq >= cap)).sum(-1, dtype=torch.int32)
    st[key_overflow] += torch.minimum(inc, INT_MAX - st[key_overflow])
    return st


def write_records(st, mask, *, seq, src, dst, created_t, completed_t,
                  exit_label, layers, hops, energy_j, tx_time_s):
    """Scatter one TaskRecord per ``mask`` lane into slot ``seq``."""
    rows = schema.pack(seq, src, dst, created_t, completed_t, exit_label,
                       layers, hops, energy_j, tx_time_s)
    return _scatter_records(st, "trace_records", "trace_overflow", mask,
                            seq, rows)


def write_hop_records(st, mask, *, seq, src, dst, t_depart, t_arrive, bits,
                      boundary_layer, stall_ticks):
    """Scatter one HopRecord per ``mask`` lane into slot ``seq``."""
    rows = schema.pack_hop(seq, src, dst, t_depart, t_arrive, bits,
                           boundary_layer, stall_ticks)
    return _scatter_records(st, "trace_hops", "trace_hop_overflow", mask,
                            seq, rows)


def traced_push(st, mask, cum, created, visited, *, src, energy, txtime,
                t_now: float, cfg: SwarmConfig):
    """``queues.push`` with the attribution columns, and a ``DROPPED``
    record, stamped ``t_now``, for each task that finds its queue full:
    under tracing a drop consumes a seq, so the records cover every task
    that finished, completed or not."""
    n = st["q_active"].shape[-2]
    dropped = mask & st["q_active"].all(dim=-1)
    push(st, mask, cum, created, visited,
         extras={"src": src, "energy": energy, "txtime": txtime})
    drop_seq = (st["seq_counter"][:, None]
                + torch.cumsum(dropped.to(torch.int32), dim=-1,
                               dtype=torch.int32) - 1)
    st["seq_counter"] += dropped.sum(dim=-1, dtype=torch.int32)
    return write_records(
        st, dropped, seq=drop_seq, src=src,
        dst=torch.arange(n, device=mask.device), created_t=created,
        completed_t=t_now, exit_label=schema.DROPPED, layers=0,
        hops=visited.sum(dim=-1), energy_j=energy, tx_time_s=txtime)
