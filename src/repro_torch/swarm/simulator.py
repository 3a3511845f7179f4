"""Time-stepped swarm simulator (paper §5 environment), port of
``repro/swarm/simulator.py``.

One simulation is a loop over decision epochs (Δt = 200 ms).  Each epoch
refreshes the scenario (fault -> alive mask, mobility -> positions,
channel -> adjacency and capacity), runs the strategy's decision once
(Alg. 1: the Eq. 10 φ update, then Eqs. 11-13 or a baseline), applies the
congestion early exit (Eqs. 14-16), initiates transfers, then runs the fine
ticks (10 ms): Markov arrivals, two compute passes, transfer progress and
delivery.

Where the reference ``vmap``s over Monte-Carlo runs and ``scan``s over
epochs and ticks, every tensor here carries a leading run axis ``[R]`` and
epochs and ticks are Python loops; one φ kernel launch per epoch covers all
R runs.  The state is a dict of tensors updated in place, with exactly the
keys, shapes (plus the run axis) and dtypes of the reference's state, but
for the one spare slot of the two record buffers (``trace/record.py``).
The telemetry streams (``trace_capacity``, ``trace_hop_capacity``,
``trace_state_every``) add their state only when on and observe without
intervening: every untraced metric of a traced run is bit-identical.
Random numbers come from ``repro_torch.rng`` with the reference's
key derivation, so a run follows the reference's streams.

Strategies (paper §5): 0 LocalOnly · 1 Random · 2 RandomAcyclic · 3 Greedy
· 4 Distributed (ours, diffusive φ).  Every strategy updates φ every epoch
(the reference computes all five and selects; only φ reaches the state),
so the φ kernel is on the path whichever strategy runs.

No float reduction across nodes or queue slots happens in float32 order:
each goes through ``core.fp.fsum`` (exact, then rounded once), so results do
not depend on R, on the device's reduction strategy or on the launch grid.
"""
from __future__ import annotations

from typing import Dict

import numpy as np
import torch

from repro_torch import rng
from repro_torch.configs import SwarmConfig
from repro_torch.core.decision import (transfer_decision,
                                       transfer_decision_sparse)
from repro_torch.core.diffusive import (gather_rows, phi_update_op,
                                        phi_update_op_sparse)
from repro_torch.core.early_exit import (CongestionState, congestion_update,
                                         exit_accuracy, exit_boundary_layers,
                                         exit_label)
from repro_torch.core.fp import div, fma, fsum
from repro_torch.swarm import transfer as transfer_mod
from repro_torch.swarm.channel import edge_rate, link_state, link_state_sparse
from repro_torch.swarm.neighbors import mask_neighbors, neighbor_lists
from repro_torch.swarm.queues import grid, head_slot, push, queued_gflops
from repro_torch.swarm.scenario import (burst_arrivals, burst_draws,
                                        get_channel, get_channel_edges,
                                        get_fault, get_mobility,
                                        mask_adjacency)
from repro_torch.swarm.tasks import TaskProfile, make_profile
from repro_torch.trace import record as trace_record

BIG = 1e30

LOCAL_ONLY, RANDOM, RANDOM_ACYCLIC, GREEDY, DISTRIBUTED = range(5)
STRATEGY_NAMES = ("LocalOnly", "Random", "RandomAcyclic", "Greedy",
                  "Distributed")


def _f32(x) -> float:
    return float(np.float32(x))


def _fma_host(a, b, c) -> float:
    """fl32(a·b + c) with one rounding, on host scalars (XLA contracts the
    reference's time arithmetic the same way)."""
    return _f32(np.float64(np.float32(a)) * np.float64(np.float32(b))
                + np.float64(np.float32(c)))


# ---------------------------------------------------------------------------
# state
# ---------------------------------------------------------------------------


def init_state(keys: torch.Tensor, cfg: SwarmConfig, n: int) -> Dict:
    """Initial state of R runs from keys [R, 2]."""
    R, dev, Q = keys.shape[0], keys.device, cfg.queue_slots
    k = rng.split(keys, 3)
    kf, km, k_fault = k[..., 0, :], k[..., 1, :], k[..., 2, :]
    F = torch.clamp_min(fma(cfg.capability_std, rng.normal(kf, (n,)),
                            cfg.capability_mean), 50.0)

    def zeros(*shape, dtype=torch.float32):
        return torch.zeros((R, *shape), dtype=dtype, device=dev)

    b, i32 = torch.bool, torch.int32
    return {
        "mob": get_mobility(cfg).init(km, cfg, n),
        "alive": get_fault(cfg).init(k_fault, cfg, n),
        "F": F,
        # queues (struct-of-arrays)
        "q_active": zeros(n, Q, dtype=b),
        "q_cum": zeros(n, Q),
        "q_created": zeros(n, Q),
        "q_seq": zeros(n, Q, dtype=i32),
        "q_visited": zeros(n, Q, n, dtype=b),
        "seq_counter": zeros(dtype=i32),
        # single outgoing transfer per node (§3.2)
        "tx_active": zeros(n, dtype=b),
        "tx_dst": zeros(n, dtype=i32),
        "tx_bits": zeros(n),
        "tx_cum": zeros(n),
        "tx_created": zeros(n),
        "tx_visited": zeros(n, n, dtype=b),
        "tx_start": zeros(n),
        # protocol state
        "phi": F.clone(),
        "cong_prev": zeros(n),
        "cong_D": zeros(n),
        "xi_layers": torch.full((R, n), cfg.exit_points[2], dtype=i32,
                                device=dev),
        "xi_label": zeros(n, dtype=i32),
        # Markov-modulated arrival chain
        "burst_on": zeros(n, dtype=b),
        # metric accumulators: event counts int32, energy per node
        "done_count": zeros(dtype=i32), "lat_sum": zeros(),
        "acc_sum": zeros(), "proc_gflops": zeros(n),
        "e_comp": zeros(n),
        "e_tx": zeros(n),
        "tx_count": zeros(dtype=i32), "tx_delivered": zeros(dtype=i32),
        "tx_time_sum": zeros(),
        "drop_count": zeros(dtype=i32), "gen_count": zeros(dtype=i32),
        # the telemetry streams: {} when off, so the untraced state is
        # exactly the one above
        **trace_record.init_trace(cfg, n, R, dev),
        **trace_record.init_hops(cfg, n, R, dev),
        **trace_record.init_state_stream(cfg, n, R, dev),
    }


# ---------------------------------------------------------------------------
# per-tick dynamics
# ---------------------------------------------------------------------------


def _compute_pass(st, budget, targets_cum, t_now: float, cfg: SwarmConfig):
    """Advance each node's head task by up to ``budget`` GFLOPs."""
    rr, nn = grid(st)
    head, has = head_slot(st)
    idx = (rr, nn, head)
    cur = st["q_cum"][idx]
    rem = torch.clamp_min(targets_cum - cur, 0.0)
    adv = torch.where(has, torch.minimum(budget, rem), 0.0)
    new_cum = cur + adv
    completed = has & (new_cum >= targets_cum - 1e-6)
    lat = t_now - st["q_created"][idx]
    acc = exit_accuracy(st["xi_label"], cfg.exit_accuracy)

    st["q_cum"][idx] = torch.where(has, new_cum, cur)
    st["proc_gflops"] += adv
    st["e_comp"] = fma(adv, cfg.energy_per_gflop_j, st["e_comp"])
    st["done_count"] += completed.sum(dim=-1, dtype=torch.int32)
    st["lat_sum"] += fsum(torch.where(completed, lat, 0.0))
    st["acc_sum"] += fsum(torch.where(completed, acc, 0.0))
    st["q_active"][idx] = st["q_active"][idx] & ~completed
    if trace_record.enabled(cfg):
        # the reference's scatter-add rounds the product, then the sum (no
        # fused multiply-add, unlike e_comp above)
        st["q_energy"][idx] += adv * cfg.energy_per_gflop_j
        trace_record.write_records(
            st, completed, seq=st["q_seq"][idx], src=st["q_src"][idx],
            dst=nn, created_t=st["q_created"][idx], completed_t=t_now,
            exit_label=st["xi_label"], layers=st["xi_layers"],
            hops=st["q_visited"][idx].sum(dim=-1),
            energy_j=st["q_energy"][idx], tx_time_s=st["q_txtime"][idx])
    return st, budget - adv


def _tick(st, draws, cfg: SwarmConfig, targets, budget, cap, alive,
          t_now: float):
    """One fine tick: arrivals, two compute passes, transfer progress.
    ``draws`` are this tick's ``burst_draws``; ``targets`` [R, N] and the
    compute ``budget`` [R, N] are fixed for the epoch."""
    # (a) Markov-modulated arrivals (down nodes don't generate)
    st["burst_on"], arrive = burst_arrivals(st["burst_on"], draws, cfg)
    arrive = arrive & alive
    none = torch.zeros((), dtype=torch.bool, device=alive.device)
    if trace_record.enabled(cfg):
        n = alive.shape[-1]
        trace_record.traced_push(
            st, arrive, 0.0, t_now, none,
            src=torch.arange(n, dtype=torch.int32, device=alive.device),
            energy=0.0, txtime=0.0, t_now=t_now, cfg=cfg)
    else:
        push(st, arrive, 0.0, t_now, none)
    st["gen_count"] += arrive.sum(dim=-1, dtype=torch.int32)

    # (b) compute (budget cascade x2: finish a task and start the next)
    for _ in range(2):
        st, budget = _compute_pass(st, budget, targets, t_now, cfg)

    # (c) transfer progress + delivery
    return transfer_mod.progress(st, cap, alive, cfg, t_now)


# ---------------------------------------------------------------------------
# epoch decision (strategy dispatch)
# ---------------------------------------------------------------------------


def _no_transfer(st):
    z = torch.zeros_like(st["tx_dst"])
    return z.to(torch.bool), z


def _strategy_decision(st, strategy: int, adj, d_tx, T, key,
                       cfg: SwarmConfig):
    """Returns (do_transfer [R, N] bool, target [R, N] int32, phi')."""
    n = st["F"].shape[-1]
    k = rng.split(key, 3)
    k1, k2, k3 = k[..., 0, :], k[..., 1, :], k[..., 2, :]
    has_nbr = adj.any(dim=-1)

    # Distributed (ours), Eqs. 10-13: φ is updated whatever the strategy
    phi = phi_update_op(st["phi"], st["F"], adj, d_tx)
    if strategy == DISTRIBUTED:
        dec = transfer_decision(T, phi, adj, cfg.gamma)
        return dec.transfer, dec.target, phi
    if strategy == GREEDY:       # least instantaneous load, w.p. p_greedy
        cand = torch.where(adj, T[..., None, :], BIG)
        tgt = cand.argmin(dim=-1).to(torch.int32)
        do = (rng.bernoulli(k1, cfg.greedy_offload_p, (n,)) & has_nbr
              & (cand.amin(dim=-1) < T))
        return do, tgt, phi
    if strategy == RANDOM:       # uniform neighbour, w.p. 0.2
        gum = rng.gumbel(k2, (n, n))
        tgt = torch.where(adj, gum, -BIG).argmax(dim=-1).to(torch.int32)
        do = rng.bernoulli(rng.fold_in(k2, 1), cfg.random_offload_p,
                           (n,)) & has_nbr
        return do, tgt, phi
    if strategy == RANDOM_ACYCLIC:   # uniform unvisited neighbour, w.p. 0.1
        rr, nn = grid(st)
        head, _ = head_slot(st)
        amask = adj & ~st["q_visited"][rr, nn, head]
        gum = rng.gumbel(k3, (n, n))
        tgt = torch.where(amask, gum, -BIG).argmax(dim=-1).to(torch.int32)
        do = rng.bernoulli(rng.fold_in(k3, 1), cfg.random_acyclic_p,
                           (n,)) & amask.any(dim=-1)
        return do, tgt, phi
    if strategy == LOCAL_ONLY:
        return (*_no_transfer(st), phi)
    raise ValueError(f"unknown strategy {strategy}")


def _strategy_decision_sparse(st, strategy: int, adj_e, nbr, d_tx_e, T, key,
                              cfg: SwarmConfig):
    """Neighbour-list twin of ``_strategy_decision``: reductions over the K
    axis, mapped back through ``nbr``.  Offload coins and the Greedy and
    Distributed targets equal the dense path's; Random/RandomAcyclic draw
    their gumbels per slot [N, K], a different stream (as in the
    reference)."""
    n, K = nbr.shape[-2:]
    k = rng.split(key, 3)
    k1, k2, k3 = k[..., 0, :], k[..., 1, :], k[..., 2, :]
    has_nbr = adj_e.any(dim=-1)

    def via(slot):
        return torch.gather(nbr, -1, slot[..., None])[..., 0]

    phi = phi_update_op_sparse(st["phi"], st["F"], adj_e, nbr, d_tx_e)
    if strategy == DISTRIBUTED:
        dec = transfer_decision_sparse(T, phi, adj_e, nbr, cfg.gamma)
        return dec.transfer, dec.target, phi
    if strategy == GREEDY:
        cand = torch.where(adj_e, gather_rows(T, nbr), BIG)
        do = (rng.bernoulli(k1, cfg.greedy_offload_p, (n,)) & has_nbr
              & (cand.amin(dim=-1) < T))
        return do, via(cand.argmin(dim=-1)), phi
    if strategy == RANDOM:
        gum = rng.gumbel(k2, (n, K))
        tgt = via(torch.where(adj_e, gum, -BIG).argmax(dim=-1))
        do = rng.bernoulli(rng.fold_in(k2, 1), cfg.random_offload_p,
                           (n,)) & has_nbr
        return do, tgt, phi
    if strategy == RANDOM_ACYCLIC:
        rr, nn = grid(st)
        head, _ = head_slot(st)
        visited_head = st["q_visited"][rr, nn, head]        # [R, N, N]
        amask = adj_e & ~torch.gather(visited_head, -1, nbr.long())
        gum = rng.gumbel(k3, (n, K))
        tgt = via(torch.where(amask, gum, -BIG).argmax(dim=-1))
        do = rng.bernoulli(rng.fold_in(k3, 1), cfg.random_acyclic_p,
                           (n,)) & amask.any(dim=-1)
        return do, tgt, phi
    if strategy == LOCAL_ONLY:
        return (*_no_transfer(st), phi)
    raise ValueError(f"unknown strategy {strategy}")


def _epoch(st, key, epoch_idx: int, strategy: int, cfg: SwarmConfig,
           profile: TaskProfile):
    """One decision epoch of R runs, key [R, 2]; updates ``st`` in place."""
    t0 = _f32(np.float32(epoch_idx) * np.float32(cfg.decision_period_s))
    # the reference takes kd, kt = split(key) and folds 11, 13, 17 into the
    # key for the scenario; with the partitionable threefry, fold_in(key, i)
    # is split(key, n)[i] and split(key)[j] is split(key, n)[j], so one
    # split of 18 yields all five keys, bit for bit
    k = rng.split(key, 18)
    kd, kt = k[..., 0, :], k[..., 1, :]
    k_mob, k_ch, k_fault = k[..., 11, :], k[..., 13, :], k[..., 17, :]

    # 1. refresh the scenario; 2. strategy decision (Alg. 1 lines 2-5)
    st["alive"] = get_fault(cfg).step(st["alive"], k_fault, cfg)
    st["mob"], pos = get_mobility(cfg).step(st["mob"], k_mob, cfg, t0)
    T = queued_gflops(st, profile)
    sparse = cfg.neighbor_mode == "sparse"
    if sparse:
        edge_fn = get_channel_edges(cfg)
        nbr, valid = neighbor_lists(pos, cfg)
        valid = mask_neighbors(valid, nbr, st["alive"])
        adj_e, cap_e = link_state_sparse(pos, nbr, valid, cfg, key=k_ch,
                                         pathloss_fn=edge_fn)
        d_tx_e = torch.where(adj_e, div(profile.bits_per_gflop, cap_e), BIG)
        do, tgt, phi = _strategy_decision_sparse(st, strategy, adj_e, nbr,
                                                 d_tx_e, T, kd, cfg)
    else:
        adj, cap = link_state(pos, cfg, key=k_ch,
                              pathloss_fn=get_channel(cfg))
        adj = mask_adjacency(adj, st["alive"])
        d_tx = torch.where(adj, div(profile.bits_per_gflop, cap), BIG)
        do, tgt, phi = _strategy_decision(st, strategy, adj, d_tx, T, kd,
                                          cfg)
    st["phi"] = phi

    # 3. congestion-aware early exit (Alg. 1 lines 10-11, Eqs. 14-16)
    cong = congestion_update(CongestionState(st["cong_prev"], st["cong_D"]),
                             T, cfg.decision_period_s, cfg.ema_alpha)
    st["cong_prev"], st["cong_D"] = cong.prev_T, cong.D
    if cfg.early_exit_enabled:
        lbl = exit_label(cong.D, *cfg.exit_thresholds)
    else:
        lbl = torch.zeros_like(st["xi_label"])
    st["xi_label"] = lbl
    st["xi_layers"] = exit_boundary_layers(lbl, cfg.exit_points,
                                           cfg.exit_finalize_layers)

    # 4. initiate transfers: pop head, snap to boundary (§3.1 discard)
    _, has = head_slot(st)
    elig = do & has & ~st["tx_active"] & (tgt >= 0)
    transfer_mod.initiate(st, elig, tgt, t0, profile)

    # 5. fine ticks.  tx_dst is frozen between decisions, so the sparse path
    #    resolves each node's outgoing link rate once per epoch
    if sparse:
        link = edge_rate(pos, st["tx_dst"], cfg, key=k_ch,
                         pathloss_fn=edge_fn)
    else:
        link = cap
    n_ticks = int(round(cfg.decision_period_s / cfg.tick_s))
    n = st["F"].shape[-1]
    flips, arrivals = burst_draws(
        rng.fold_in(kt, torch.arange(n_ticks, device=key.device)), n)
    alive = st["alive"]
    targets = profile.cum_gflops[
        st["xi_layers"].clamp(0, profile.gflops.shape[0]).long()]
    budget = torch.where(alive, st["F"] * cfg.tick_s, 0.0)
    for i in range(n_ticks):
        t_now = _fma_host(i + 1, cfg.tick_s, t0)
        _tick(st, (flips[:, i], arrivals[:, i]), cfg, targets, budget, link,
              alive, t_now)

    # 6. the flight recorder: a snapshot at the end of every
    #    trace_state_every-th epoch
    if trace_record.state_enabled(cfg):
        trace_record.write_state(
            st, epoch_idx, _fma_host(epoch_idx, cfg.decision_period_s,
                                     cfg.decision_period_s), cfg)
    return st


# ---------------------------------------------------------------------------
# run + metrics
# ---------------------------------------------------------------------------


def run_sim(keys: torch.Tensor, cfg: SwarmConfig, strategy: int,
            n: int | None = None) -> Dict[str, torch.Tensor]:
    """R full simulations from keys [R, 2] (on their device); returns the
    metric dict of [R] tensors (see ``summarize``)."""
    n = n or cfg.num_workers
    strategy = int(strategy)
    profile = make_profile(cfg, device=keys.device)
    k = rng.split(keys)
    st = init_state(k[..., 0, :], cfg, n)
    n_epochs = int(round(cfg.sim_time_s / cfg.decision_period_s))
    epoch_keys = rng.fold_in(k[..., 1, :],
                             torch.arange(n_epochs, device=keys.device))
    for i in range(n_epochs):
        _epoch(st, epoch_keys[:, i], i, strategy, cfg, profile)
    return summarize(st, cfg, profile)


def summarize(st, cfg: SwarmConfig, profile: TaskProfile
              ) -> Dict[str, torch.Tensor]:
    """The paper's indices per run, [R] float32 each, and the enabled
    telemetry streams' ``trace_*`` leaves.  The cross-node sums happen
    here, once."""
    done_f = st["done_count"].to(torch.float32)
    done = torch.clamp_min(done_f, 1.0)
    rem_q = queued_gflops(st, profile)
    rem_tx = torch.where(st["tx_active"],
                         profile.total_gflops - st["tx_cum"], 0.0)
    # Jain fairness over capability-normalised processed GFLOPs (Fig. 4d)
    x = st["proc_gflops"] / st["F"]
    jain = fsum(x) ** 2 / fma(x.shape[-1], fsum(x * x), 1e-12)
    tps = div(done_f, cfg.sim_time_s)
    acc = st["acc_sum"] / done
    e_total = fsum(st["e_comp"] + st["e_tx"])
    ae = e_total / done
    al = st["lat_sum"] / done
    fom = tps * acc / torch.clamp_min(ae * al, 1e-12)
    out = {
        "completed": done_f,
        "generated": st["gen_count"].to(torch.float32),
        "avg_latency_s": al, "avg_accuracy": acc,
        "remaining_gflops": fsum(rem_q) + fsum(rem_tx),
        "avg_transfer_time_s": st["tx_time_sum"] / torch.clamp_min(
            st["tx_delivered"].to(torch.float32), 1.0),
        "transfers": st["tx_count"].to(torch.float32),
        "transfers_delivered": st["tx_delivered"].to(torch.float32),
        "jain_fairness": jain,
        "energy_per_task_j": ae,
        "energy_total_j": e_total,
        "throughput_tps": tps,
        "dropped": st["drop_count"].to(torch.float32),
        "fom": fom,
    }
    # the telemetry leaves (trace_ prefix), the record buffers without their
    # spare slot (trace/record.py)
    if trace_record.enabled(cfg):
        out["trace_records"] = st["trace_records"][:, :-1]
        out["trace_overflow"] = st["trace_overflow"]
    if trace_record.hops_enabled(cfg):
        out["trace_hops"] = st["trace_hops"][:, :-1]
        out["trace_hop_overflow"] = st["trace_hop_overflow"]
    if trace_record.state_enabled(cfg):
        for k in ("trace_state", "trace_state_sys", "trace_state_epochs"):
            out[k] = st[k]
    return out


def run_many(key: torch.Tensor, cfg: SwarmConfig, strategy, n: int,
             num_runs: int, device=None) -> Dict[str, torch.Tensor]:
    """``num_runs`` Monte-Carlo runs on the explicit run axis; returns a dict
    of [num_runs] tensors.  Runs on CUDA unless ``device`` says otherwise,
    and raises where CUDA is absent (it never falls back to the CPU)."""
    from repro_torch.fleet.executor import run_batch  # no import cycle
    return run_batch(key, cfg, strategy, n, num_runs, device=device)
