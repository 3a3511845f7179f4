"""Struct-of-arrays task-queue ops, port of ``repro/swarm/queues.py``.

Each node owns ``Q = cfg.queue_slots`` slots; a task is (active,
cum_gflops, created_t, seq, visited set).  FIFO order is by global sequence
number, so the head is an argmin over active seqs.  All state carries a
leading run axis: ``q_*`` are [R, N, Q] (``q_visited`` [R, N, Q, N]),
counters [R].  The scatters write one slot per (run, node) pair, so they
are plain ``index_put_`` without accumulation: deterministic on CUDA.
Updates are in place on the state dict's tensors.
"""
from __future__ import annotations

import torch

from repro_torch.core.fp import fsum
from repro_torch.swarm.tasks import TaskProfile

INT_MAX = torch.iinfo(torch.int32).max


def grid(st):
    """(rr [R, 1], nn [1, N]) index tensors over the run and node axes."""
    R, N = st["F"].shape
    dev = st["F"].device
    return (torch.arange(R, device=dev)[:, None],
            torch.arange(N, device=dev)[None, :])


def head_slot(st):
    """FIFO head per node: (head slot [R, N] int64, has_task [R, N])."""
    seqv = torch.where(st["q_active"], st["q_seq"], INT_MAX)
    return seqv.argmin(dim=-1), st["q_active"].any(dim=-1)


def queued_gflops(st, profile: TaskProfile) -> torch.Tensor:
    """Remaining GFLOPs per node across all queued tasks (load metric T)."""
    rem = torch.clamp_min(profile.total_gflops - st["q_cum"], 0.0)
    return fsum(torch.where(st["q_active"], rem, 0.0))


def push(st, mask, cum, created, visited, extras=None):
    """Insert one task per node where ``mask`` into the first free slot;
    a full queue drops the task and counts it.  cum/created broadcast to
    [R, N], visited to [R, N, N].  ``extras`` ``{name: value}`` writes
    further per-task columns ``q_<name>`` at the same slot (the trace
    layer's attribution, ``repro_torch.trace.record``)."""
    rr, nn = grid(st)
    active = st["q_active"]
    free = active.to(torch.uint8).argmin(dim=-1)          # first free slot
    has_free = ~active.all(dim=-1)
    ok = mask & has_free
    seq = (st["seq_counter"][:, None]
           + torch.cumsum(ok.to(torch.int32), dim=-1, dtype=torch.int32) - 1)
    idx = (rr, nn, free)
    active[idx] = ok | active[idx]
    extras = tuple((f"q_{k}", v) for k, v in (extras or {}).items())
    for name, val in (*extras, ("q_cum", cum), ("q_created", created),
                      ("q_seq", seq)):
        st[name][idx] = torch.where(ok, val, st[name][idx])
    st["q_visited"][idx] = torch.where(ok[..., None], visited,
                                       st["q_visited"][idx])
    st["seq_counter"] += ok.sum(dim=-1, dtype=torch.int32)
    st["drop_count"] += (mask & ~has_free).sum(dim=-1, dtype=torch.int32)
    return st


def pop_head(st, mask):
    """Deactivate the FIFO head where ``mask``."""
    head, _ = head_slot(st)
    rr, nn = grid(st)
    idx = (rr, nn, head)
    st["q_active"][idx] = st["q_active"][idx] & ~mask
    return st
