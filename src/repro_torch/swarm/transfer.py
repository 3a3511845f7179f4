"""Single-outgoing-transfer machinery (paper §3.2), port of
``repro/swarm/transfer.py``.

An epoch decision *initiates* a transfer (pop the FIFO head, snap its
progress back to the last layer boundary, ship the boundary activation
bits); fine ticks *progress* it at the epoch-frozen link rate and *deliver*
it into the destination queue, one delivery per receiver per tick, lowest
origin index winning contention.  Once a payload has fully arrived
(``tx_bits <= 0``) but waits out contention, its bits and transmit energy
are frozen: the radio is done.  Under hop capture those waiting ticks
count in ``hop_stall``, with the ticks an endpoint is down.
"""
from __future__ import annotations

import torch

from repro_torch.configs import SwarmConfig
from repro_torch.core.fp import fsum
from repro_torch.swarm.queues import INT_MAX, grid, head_slot, pop_head, push
from repro_torch.swarm.tasks import (TaskProfile, boundary_bits, layer_of,
                                     snap_to_boundary)
from repro_torch.trace import record as trace_record


def initiate(st, elig, tgt, t0: float, profile: TaskProfile):
    """Start transfers where ``elig`` [R, N] toward ``tgt`` [R, N] int32."""
    rr, nn = grid(st)
    head, _ = head_slot(st)
    idx = (rr, nn, head)
    cum_h = st["q_cum"][idx]
    bits = boundary_bits(profile, cum_h)
    if "tx_src" in st:       # the task stream's attribution rides along
        for f in ("src", "energy", "txtime"):
            st[f"tx_{f}"] = torch.where(elig, st[f"q_{f}"][idx],
                                        st[f"tx_{f}"])
    if "hop_seq" in st:      # the hop stream: seqs assigned at initiation
        hseq = (st["hop_counter"][:, None]
                + torch.cumsum(elig.to(torch.int32), dim=-1,
                               dtype=torch.int32) - 1)
        st["hop_seq"] = torch.where(elig, hseq, st["hop_seq"])
        st["hop_counter"] += elig.sum(dim=-1, dtype=torch.int32)
        st["hop_bits"] = torch.where(elig, bits, st["hop_bits"])
        st["hop_layer"] = torch.where(
            elig, layer_of(profile, cum_h).clamp(
                0, profile.cum_gflops.shape[0] - 1).to(torch.int32),
            st["hop_layer"])
        st["hop_stall"] = torch.where(elig, 0, st["hop_stall"])
    st["tx_dst"] = torch.where(elig, tgt, st["tx_dst"])
    st["tx_bits"] = torch.where(elig, bits, st["tx_bits"])
    st["tx_cum"] = torch.where(elig, snap_to_boundary(profile, cum_h),
                               st["tx_cum"])
    st["tx_created"] = torch.where(elig, st["q_created"][idx],
                                   st["tx_created"])
    st["tx_visited"] = torch.where(elig[..., None], st["q_visited"][idx],
                                   st["tx_visited"])
    st["tx_start"] = torch.where(elig, t0, st["tx_start"])
    st["tx_count"] += elig.sum(dim=-1, dtype=torch.int32)
    st["tx_active"] |= elig
    return pop_head(st, elig)


def _scatter_reduce(n_out: int, index: torch.Tensor, src: torch.Tensor,
                 init: int, reduce: str) -> torch.Tensor:
    """Per-run ``out[r, index[r, i]] = reduce(out, src[r, i])`` over int32
    values (exact under any order, so deterministic with atomics)."""
    out = torch.full((index.shape[0], n_out), init, dtype=torch.int32,
                     device=index.device)
    return out.scatter_reduce(1, index.long(), src.to(torch.int32), reduce,
                              include_self=True)


def progress(st, cap, alive, cfg: SwarmConfig, t_now: float):
    """One tick of transfer progress and delivery.

    ``cap`` is the epoch-frozen capacity: [R, N, N] on the dense path, or
    the [R, N] per-node rate toward ``tx_dst`` on the sparse path.  A
    transfer whose endpoint is down (``alive`` [R, N]) stalls.
    """
    R, n = st["F"].shape
    rows = torch.arange(n, dtype=torch.int32, device=st["F"].device)
    rows = rows.expand(R, n)
    dst = st["tx_dst"].long()
    rate = cap if cap.dim() == 2 else torch.gather(cap, 2, dst[..., None])[
        ..., 0]
    live = alive & torch.gather(alive, 1, dst)
    active = st["tx_active"] & live
    pre_arrived = st["tx_bits"] <= 0.0
    flying = active & ~pre_arrived
    tx_w = 10.0 ** (cfg.tx_power_dbm / 10.0) * 1e-3
    if "hop_stall" in st:    # pending, not progressing: a fault stall or
        st["hop_stall"] += (     # a wait after arrival
            st["tx_active"] & (~live | pre_arrived)).to(torch.int32)
    st["tx_bits"] = torch.where(flying, st["tx_bits"] - rate * cfg.tick_s,
                                st["tx_bits"])
    # the airtime joules, in float32 (not torch's default dtype)
    air = torch.zeros_like(st["e_tx"]).masked_fill_(flying, tx_w * cfg.tick_s)
    st["e_tx"] += air
    if "tx_energy" in st:    # attributed to the task
        st["tx_energy"] += air
    arrived = active & (st["tx_bits"] <= 0.0)
    # receiver contention: the lowest-index origin wins per destination
    winner = _scatter_reduce(n, dst, torch.where(arrived, rows, INT_MAX),
                          INT_MAX, "amin")
    deliver = arrived & (torch.gather(winner, 1, dst) == rows)
    dst_mask = _scatter_reduce(n, dst, deliver, 0, "amax") > 0
    inv = _scatter_reduce(n, dst, torch.where(deliver, rows, 0), 0,
                       "amax").long()                    # origin per dst
    rr, nn = grid(st)
    cum_d = torch.gather(st["tx_cum"], 1, inv)
    created_d = torch.gather(st["tx_created"], 1, inv)
    visited_d = st["tx_visited"][rr, inv]
    visited_d[rr, nn, inv] = True                        # mark the origin
    if trace_record.hops_enabled(cfg):
        trace_record.write_hop_records(
            st, deliver, seq=st["hop_seq"], src=rows, dst=st["tx_dst"],
            t_depart=st["tx_start"], t_arrive=t_now, bits=st["hop_bits"],
            boundary_layer=st["hop_layer"], stall_ticks=st["hop_stall"])
    if trace_record.enabled(cfg):
        trace_record.traced_push(
            st, dst_mask, cum_d, created_d, visited_d,
            src=torch.gather(st["tx_src"], 1, inv),
            energy=torch.gather(st["tx_energy"], 1, inv),
            txtime=torch.gather(st["tx_txtime"], 1, inv) + torch.where(
                dst_mask, t_now - torch.gather(st["tx_start"], 1, inv),
                0.0),
            t_now=t_now, cfg=cfg)
    else:
        push(st, dst_mask, cum_d, created_d, visited_d)
    st["tx_active"] &= ~deliver
    st["tx_delivered"] += deliver.sum(dim=-1, dtype=torch.int32)
    st["tx_time_sum"] += fsum(torch.where(deliver, t_now - st["tx_start"],
                                          0.0))
    return st
