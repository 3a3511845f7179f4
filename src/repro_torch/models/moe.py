"""Capacity-based expert-parallel MoE (qwen3-moe / granite-moe); port of
``repro/models/moe.py``.

The reference's shard body ``_moe_shard``: routing in the compute dtype,
an f32 softmax and top-k, the optional renormalisation, per-expert
capacity ``C = ceil(T·k/E · cf)`` with Switch-style overflow drops, the
slot maps, the expert FFN as batched matrix products, the weighted
combine, and the Switch aux loss with the drop fraction.  Without a mesh
(or on a ``"model"`` axis of 1) it runs as one shard.

Expert parallelism, the reference's ``shard_map`` path (``apply_moe`` with
a ``models.parallel.Sharding``): each ``"model"`` rank owns ``E / m``
experts, ``shard_id`` being its ``"model"`` coordinate; it routes its data
shard's tokens (``T`` is the local token count, so capacity is per data
shard), runs ``_moe_shard`` for its own experts, and the ranks' outputs
are summed over ``"model"`` (the ``psum``), the aux loss averaged (the
``pmean``) and the drop fraction summed and divided by ``m``.  The expert
weights arrive gathered over the batch axes on their ``d`` / ``ff`` dim
(ZeRO-3, ``Sharding.layer``).

Three choices keep the port equal to the reference and the same from
launch to launch on the card:

* **top-k by a stable sort.** ``lax.top_k`` puts the lower expert first
  on ties, which are common between bf16 router logits; ``torch.topk``
  promises no order.  ``route`` takes the first k of a stable descending
  sort, which is ``lax.top_k``'s order.
* **drops written to the dummy slot only.** The slot maps take every
  dropped assignment (and, under expert parallelism, every assignment to
  another shard's expert) at the dummy slot ``E_loc·C`` and slice it
  off; a kept slot is written by exactly one assignment, so
  ``index_put_``'s undefined winner among repeated indices on CUDA never
  reaches a kept value.
* **a combine without atomics.** The reference scatter-adds each slot's
  weighted output into its token in ascending slot order (XLA's serial
  order).  A token's kept slots lie in distinct experts, so ascending slot
  order is ascending expert order: ``_moe_shard`` gathers each token's k
  contributions, orders them by expert and sums them in f32 one after the
  other, where ``index_add_`` on CUDA would add in an order that varies
  from run to run.

Nor do the backward passes of the block's two gathers use atomics.
Autograd's backward of an advanced-index read on CUDA is the sorted,
accumulating ``index_put_``, which walks each run of equal indices in
series: the dispatch's empty slots all read token 0 and the combine's
dropped assignments all read slot ``n_slots - 1``, so each has one run of
tens of thousands of rows.  Where autograd records them on the card,
``kernels.ops.moe_dispatch`` and ``moe_combine`` give each gather a
backward kernel of its own, driven by the inverse maps: a token's
gradient is its kept slots' rows added in ascending slot order (the list
``slot[a]``, which the combine reads too), each partial sum rounded to the
compute dtype, which is the order and the rounding of the ``index_put_``
they replace; a slot's gradient is the row of the one assignment that
holds it.  The terms they skip are the zero gradients of empty slots and
dropped assignments, so the gradients keep their bits, and two runs give
the same bits.
"""
from __future__ import annotations

import math
from typing import Dict, Tuple

import torch
import torch.nn.functional as F
from torch import nn

from repro_torch.configs import ModelConfig
from repro_torch.kernels import ops
from repro_torch.launch.mesh import P
from repro_torch.models.common import dense_init, param_dict
from repro_torch.obs import spans


def init_moe(gen: torch.Generator, cfg: ModelConfig, dtype,
             device) -> nn.ParameterDict:
    m, d = cfg.moe, cfg.d_model
    E, ff = m.num_experts, m.d_ff_expert
    return param_dict(
        router=dense_init(gen, (d, E), d, dtype, device),
        w_gate=dense_init(gen, (E, d, ff), d, dtype, device),
        w_up=dense_init(gen, (E, d, ff), d, dtype, device),
        w_down=dense_init(gen, (E, ff, d), ff, dtype, device))


def specs_moe(cfg: ModelConfig):
    return {"router": P(None, None), "w_gate": P("model", "data", None),
            "w_up": P("model", "data", None),
            "w_down": P("model", None, "data")}


def capacity(cfg: ModelConfig, T: int) -> int:
    """Slots per expert for ``T`` tokens: ``ceil(T·k/E · cf)``, at least 1."""
    m = cfg.moe
    return max(1, math.ceil(T * m.experts_per_token / m.num_experts
                            * m.capacity_factor))


def route(x2d: torch.Tensor, router_w: torch.Tensor, cfg: ModelConfig
          ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """x2d [T, d] -> (probs [T, E] f32, gate_vals [T, k] f32, gate_idx
    [T, k] int64): router logits in the compute dtype, an f32 softmax, the
    top k by a stable descending sort (lower expert first on ties), then
    the optional renormalisation."""
    m = cfg.moe
    logits = (x2d @ router_w.to(x2d.dtype)).float()               # [T, E]
    probs = torch.softmax(logits, dim=-1)
    gate_vals, gate_idx = torch.sort(probs, dim=-1, descending=True,
                                     stable=True)
    gate_vals = gate_vals[:, :m.experts_per_token]
    gate_idx = gate_idx[:, :m.experts_per_token]
    if m.router_norm_topk:
        gate_vals = gate_vals / gate_vals.sum(dim=-1, keepdim=True)
    return probs, gate_vals, gate_idx


def slots(gate_idx: torch.Tensor, cfg: ModelConfig, C: int
          ) -> Tuple[torch.Tensor, torch.Tensor]:
    """gate_idx [T, k] -> (keep [A] bool, slot [A] int64) over the A = T·k
    assignments in token-major order: an assignment's position within its
    expert is the count of earlier assignments to that expert; those at or
    beyond ``C`` drop, and a dropped assignment's slot is the dummy
    ``E·C``.

    The count is the reference's cumsum of a one-hot, laid out [E, A] so
    that the scan runs along the fast axis (down an [A, E] one-hot, on an
    H100, it took 3 ms a layer at a 2,048-token prefill)."""
    E = cfg.moe.num_experts
    eid = gate_idx.reshape(-1)                                     # [A]
    oh = eid[None, :] == torch.arange(E, device=eid.device)[:, None]
    pos = (torch.cumsum(oh, dim=1) - 1).gather(0, eid[None, :])[0]
    keep = pos < C
    slot = torch.where(keep, eid * C + pos, E * C)
    return keep, slot


def inverse_maps(slot: torch.Tensor, k: int, n_slots: int
                 ) -> Tuple[torch.Tensor, torch.Tensor]:
    """slot [A] -> (slot_tok [n_slots] int64, slot_ok [n_slots] bool): the
    token each slot holds, and whether it holds one.  The dummy slot
    ``n_slots`` takes every dropped assignment and is sliced off."""
    tok = torch.arange(slot.numel() // k,
                       device=slot.device).repeat_interleave(k)
    slot_tok = torch.zeros(n_slots + 1, dtype=torch.int64,
                           device=slot.device)
    slot_tok[slot] = tok
    slot_ok = torch.zeros(n_slots + 1, dtype=torch.bool, device=slot.device)
    slot_ok[slot] = True
    return slot_tok[:n_slots], slot_ok[:n_slots]


def _moe_shard(x2d: torch.Tensor, router_w, w_gate, w_up, w_down,
               cfg: ModelConfig, shard_id: int = 0, n_shards: int = 1):
    """x2d [T, d] -> (y [T, d], aux, dropped): the reference's
    ``_moe_shard``.  Only the assignments to this shard's experts ``[lo,
    lo + E / n_shards)`` contribute to ``y`` (the expert weights are this
    shard's); the caller sums ``y`` over the shards."""
    m = cfg.moe
    T, d = x2d.shape
    E, k = m.num_experts, m.experts_per_token
    E_loc = E // n_shards
    cd = x2d.dtype
    A = T * k
    C = capacity(cfg, T)
    n_slots = E_loc * C

    # the four parts time themselves as spans (and their backward passes
    # through grad_mark) while repro_torch.obs.spans is on; each opens
    # where the last closed, so one event marks both
    with spans.span("moe.route", x2d) as sp:
        probs, gate_vals, gate_idx = route(
            spans.grad_mark("moe.route", x2d), router_w, cfg)
        keep, slot = slots(gate_idx, cfg, C)
        if n_shards > 1:
            # an assignment's position within its expert does not depend
            # on the sharding; keep this shard's and renumber their slots
            lo = shard_id * E_loc
            eid = gate_idx.reshape(-1)
            keep = keep & (eid >= lo) & (eid < lo + E_loc)
            slot = torch.where(keep, slot - lo * C, n_slots)
        # each token's k assignments in ascending expert (= slot) order,
        # and their slots: the combine's order, and the dispatch
        # backward's list of each token's slots
        order = torch.argsort(gate_idx, dim=-1)                   # [T, k]
        a = (torch.arange(T, device=x2d.device)[:, None] * k
             + order).reshape(-1)
        slot_a = slot[a]
        gate_vals = spans.grad_mark("moe.route", gate_vals, end=True)

    # dispatch: gather tokens into [E_loc, C, d]; the expert FFN batched
    with spans.span("moe.dispatch", x2d, after=sp) as sp:
        slot_tok, slot_ok = inverse_maps(slot, k, n_slots)
        buf = (ops.moe_dispatch(spans.grad_mark("moe.dispatch", x2d),
                                slot_tok, slot_a.view(T, k))
               * slot_ok[:, None].to(cd)).reshape(E_loc, C, d)
        buf = spans.grad_mark("moe.dispatch", buf, end=True)
    with spans.span("moe.experts", x2d, after=sp) as sp:
        buf = spans.grad_mark("moe.experts", buf)
        g = F.silu(torch.bmm(buf, w_gate.to(cd)))
        u = torch.bmm(buf, w_up.to(cd))
        y_flat = torch.bmm(g * u, w_down.to(cd)).reshape(n_slots, d)
        y_flat = spans.grad_mark("moe.experts", y_flat, end=True)

    # combine: each token's kept contributions in ascending slot (= expert)
    # order, summed in f32 one after the other
    with spans.span("moe.combine", x2d, after=sp):
        y_flat = spans.grad_mark("moe.combine", y_flat)
        contrib = ops.moe_combine(y_flat, slot_a).float() \
            * gate_vals.reshape(-1)[a, None]
        contrib = torch.where(keep[a, None], contrib, 0.0).reshape(T, k, d)
        y = torch.zeros((T, d), dtype=torch.float32, device=x2d.device)
        # unbind, whose backward stacks the k gradients once (a select's
        # fills a [T, k, d] f32 zero tensor, and autograd adds the k)
        for c in contrib.unbind(1):
            y = y + c
        y = spans.grad_mark("moe.combine", y, end=True)

    # aux: load-balance loss (Switch eq. 4) + drop fraction
    me = probs.mean(dim=0)                                         # [E]
    # the per-expert counts as a scatter-add of ones (exact, and of a shape
    # that does not depend on the data, so it runs on the meta device)
    eid = gate_idx.reshape(-1)
    ce = torch.zeros(E, dtype=torch.int64, device=eid.device).scatter_add_(
        0, eid, torch.ones_like(eid)).float() / A
    aux = E * torch.sum(me * ce)
    kept = keep.sum()
    if spans.enabled() and not x2d.is_meta:
        # A - n_shards·kept in one kernel: the drops the fraction counts
        spans.count("moe.assignments", A)
        spans.count("moe.dropped", torch.rsub(kept, A, alpha=n_shards))
    dropped = 1.0 - kept.float() * n_shards / A
    return y.to(cd), aux, dropped


def apply_moe(p, cfg: ModelConfig, x: torch.Tensor, par=None
              ) -> Tuple[torch.Tensor, Dict[str, torch.Tensor]]:
    """x [B, S, d] -> (y [B, S, d], {"moe_aux", "moe_dropped"}).  With a
    ``Sharding`` whose ``"model"`` axis splits the experts, the
    expert-parallel path; ``p`` is then the layer's view from
    ``Sharding.layer``."""
    B, S, d = x.shape
    if par is not None and par.pure_dp and par.model_size > 1:
        return _moe_pure_dp(p, cfg, x, par)
    if par is None or not par.moe_ep:
        y, aux, dropped = _moe_shard(x.reshape(B * S, d), p["router"],
                                     p["w_gate"], p["w_up"], p["w_down"],
                                     cfg)
        return y.reshape(B, S, d), {"moe_aux": aux, "moe_dropped": dropped}
    n = par.model_size
    x = par.enter(x, True)
    y, aux, dropped = _moe_shard(x.reshape(B * S, d), p["router"],
                                 p["w_gate"], p["w_up"], p["w_down"], cfg,
                                 shard_id=par.model_index, n_shards=n)
    y = par.exit_tp(y)
    aux = par.exit_tp(aux) / n
    dropped = par.model_sum(dropped) / n
    return y.reshape(B, S, d), {"moe_aux": aux, "moe_dropped": dropped}


def _moe_pure_dp(p, cfg: ModelConfig, x: torch.Tensor, par
                 ) -> Tuple[torch.Tensor, Dict[str, torch.Tensor]]:
    """The ``pure_dp`` layout's MoE: the reference's token group (a
    ``"data"`` shard's tokens, ``Sharding.moe_tokens``) routed on every
    ``"model"`` rank, each rank's expert shard run on it, and the shards'
    outputs summed and cut back to the rank's rows
    (``Sharding.moe_rows``); the aux loss and the drop fraction are the
    shards' means, as the reference's ``pmean`` / ``psum``."""
    n, r = par.model_size, par.model_index
    E = cfg.moe.num_experts
    if E % n:
        raise ValueError(f"{E} experts do not split over the {n} ranks of "
                         f"'model' (the pure_dp layout's expert shards)")
    d = x.shape[-1]
    xg = par.moe_tokens(x)
    e = slice(r * (E // n), (r + 1) * (E // n))
    y, aux, dropped = _moe_shard(xg.reshape(-1, d), p["router"],
                                 p["w_gate"][e], p["w_up"][e],
                                 p["w_down"][e], cfg, shard_id=r, n_shards=n)
    y = par.moe_rows(y.reshape(xg.shape), x.shape[0])
    aux = par.sum_tp(aux) / n
    dropped = par.model_sum(dropped) / n
    return y, {"moe_aux": aux, "moe_dropped": dropped}
