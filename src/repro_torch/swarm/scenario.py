"""Pluggable scenario engine (DESIGN.md §3.4), port of
``repro/swarm/scenario.py``: the mobility, channel and fault registries
and the bursty arrival process.

A model is selected by the string fields of ``SwarmConfig``
(``mobility_model``, ``channel_model``, ``fault_model``); unknown names
raise ``KeyError`` with the registered ones.  The built-in models are the
dict literals below; third-party models register with ``register_*``,
which returns what it registered and raises ``ValueError`` on a name
that is taken.

A third-party callable is batched over the runs, as the built-ins are
(the reference's is per run and ``vmap``ped)::

                 port (batched, R runs)           reference (per run)
    mobility     init(keys, cfg, n) -> state      init(key, cfg, n) -> state
                 step(state, keys, cfg, t0)       step(state, key, cfg, t0)
                   -> (state', pos [R, N, 2])       -> (state', pos [N, 2])
    channel      fn(keys, dist [R, N, N], cfg)    fn(key, dist [N, N], cfg)
                   -> dB [R, N, N]                  -> dB [N, N]
    edge channel fn(keys, dist, src, dst, cfg)    fn(key, dist, src, dst,
                   -> dB, each [R, N, K]            cfg), each [N, K]
    fault        init(keys, cfg, n) -> alive      init(key, cfg, n)
                 step(alive, keys, cfg)             -> alive [N] bool
                   -> alive' [R, N] bool          step(alive, key, cfg)

``keys`` is ``[R, 2]`` uint32 (``repro_torch.rng``; ``rng.uniform(keys,
(n,))`` draws ``[R, n]``, run r's row what ``jax.random.uniform(key_r,
(n,))`` draws); a mobility state is a dict of ``[R, ...]`` tensors; ``t0``
is the epoch's start in seconds, a Python float (a traced float32 scalar
in the reference); every tensor lies on the keys' device, and what a
model makes goes there too.  The edge channel is also called with K = 1
(each node's link toward its transfer target).  A channel that has no
edge model runs dense only: ``neighbor_mode="sparse"`` raises
``KeyError`` for it.  The sparse search window is derived from the
built-in channels; for a third-party one it is the area's diagonal unless
``cfg.neighbor_range_m`` is set.
"""
from __future__ import annotations

import functools
from typing import Callable, Dict, NamedTuple

import torch

from repro_torch import rng
from repro_torch.configs import SwarmConfig
from repro_torch.swarm import channel as _channel
from repro_torch.swarm import mobility as _mobility


class MobilityModel(NamedTuple):
    init: Callable   # (keys, cfg, n) -> state dict
    step: Callable   # (state, keys, cfg, t0) -> (state', pos [R, N, 2])


class FaultModel(NamedTuple):
    init: Callable   # (keys, cfg, n) -> alive [R, N] bool
    step: Callable   # (alive, keys, cfg) -> alive' [R, N] bool


MOBILITY_MODELS: Dict[str, MobilityModel] = {
    "circular": MobilityModel(_mobility.init_mobility,
                              _mobility.step_circular),
    "random_waypoint": MobilityModel(_mobility.init_random_waypoint,
                                     _mobility.step_random_waypoint),
    "gauss_markov": MobilityModel(_mobility.init_gauss_markov,
                                  _mobility.step_gauss_markov),
    "levy_flight": MobilityModel(_mobility.init_levy_flight,
                                 _mobility.step_levy_flight),
}
CHANNEL_MODELS: Dict[str, Callable] = {
    "two_ray": _channel.two_ray,
    "free_space": _channel.free_space,
    "log_normal": _channel.log_normal,
    "log_normal_corr": _channel.log_normal_corr,
    "rician": _channel.rician,
    "nakagami": _channel.nakagami,
}
CHANNEL_EDGE_MODELS: Dict[str, Callable] = {
    "two_ray": _channel.two_ray_edges,
    "free_space": _channel.free_space_edges,
    "log_normal": _channel.log_normal_edges,
    "rician": _channel.rician_edges,
    "nakagami": _channel.nakagami_edges,
}
# models of the reference the port does not have: none
NOT_PORTED: Dict[str, tuple] = {}


def _register(registry: Dict, kind: str, name: str, value):
    if name in registry:
        raise ValueError(f"duplicate {kind} model {name!r}")
    registry[name] = value
    return value


def register_mobility(name: str, init: Callable, step: Callable
                      ) -> MobilityModel:
    return _register(MOBILITY_MODELS, "mobility", name,
                     MobilityModel(init, step))


def register_channel(name: str, pathloss_fn: Callable) -> Callable:
    return _register(CHANNEL_MODELS, "channel", name, pathloss_fn)


def register_channel_edges(name: str, pathloss_edges_fn: Callable
                           ) -> Callable:
    return _register(CHANNEL_EDGE_MODELS, "edge channel", name,
                     pathloss_edges_fn)


def register_fault(name: str, init: Callable, step: Callable) -> FaultModel:
    return _register(FAULT_MODELS, "fault", name, FaultModel(init, step))


def _lookup(registry: Dict, kind: str, name: str):
    if name in registry:
        return registry[name]
    raise KeyError(f"unknown {kind} model {name!r}; registered: "
                   f"{sorted(registry)}")


def get_mobility(cfg: SwarmConfig) -> MobilityModel:
    return _lookup(MOBILITY_MODELS, "mobility", cfg.mobility_model)


def get_channel(cfg: SwarmConfig) -> Callable:
    return _lookup(CHANNEL_MODELS, "channel", cfg.channel_model)


def get_channel_edges(cfg: SwarmConfig) -> Callable:
    """Per-edge pathloss model for ``neighbor_mode="sparse"``.  A channel
    without one (``log_normal_corr`` needs the whole node field's
    Cholesky factor) raises here rather than falling back to dense."""
    if cfg.channel_model not in CHANNEL_EDGE_MODELS:
        raise KeyError(
            f"channel model {cfg.channel_model!r} has no per-edge (sparse) "
            f"implementation; registered: {sorted(CHANNEL_EDGE_MODELS)} — "
            f"use neighbor_mode='dense' or register_channel_edges()")
    return CHANNEL_EDGE_MODELS[cfg.channel_model]


def get_fault(cfg: SwarmConfig) -> FaultModel:
    return _lookup(FAULT_MODELS, "fault", cfg.fault_model)


# ---------------------------------------------------------------------------
# fault/churn models
# ---------------------------------------------------------------------------


def _f32_exp_prob(x: float) -> float:
    """1 - exp(x) with the exp in float32, as the reference computes its
    per-tick transition probabilities (one host-side constant)."""
    e = torch.exp(torch.tensor(x, dtype=torch.float32))
    return float(torch.tensor(1.0, dtype=torch.float32) - e)


def _fault_none_init(keys, cfg: SwarmConfig, n: int):
    return torch.ones((keys.shape[0], n), dtype=torch.bool,
                      device=keys.device)


def _fault_none_step(alive, keys, cfg: SwarmConfig):
    return alive


def _fault_markov_init(keys, cfg: SwarmConfig, n: int):
    # start at the chain's stationary distribution
    p_down = cfg.fault_mean_down_s / (cfg.fault_mean_up_s
                                      + cfg.fault_mean_down_s)
    return ~rng.bernoulli(keys, p_down, (n,))


def _fault_markov_step(alive, keys, cfg: SwarmConfig):
    dt = cfg.decision_period_s
    p_fail = _f32_exp_prob(-dt / cfg.fault_mean_up_s)
    p_recover = _f32_exp_prob(-dt / cfg.fault_mean_down_s)
    u = rng.uniform(keys, (alive.shape[-1],))
    return torch.where(alive, u >= p_fail, u < p_recover)


FAULT_MODELS: Dict[str, FaultModel] = {
    "none": FaultModel(_fault_none_init, _fault_none_step),
    "markov": FaultModel(_fault_markov_init, _fault_markov_step),
}


def mask_adjacency(adj: torch.Tensor, alive: torch.Tensor) -> torch.Tensor:
    """Down nodes have no links in either direction."""
    return adj & alive[..., :, None] & alive[..., None, :]


# ---------------------------------------------------------------------------
# workload: Markov-modulated (bursty) arrivals
# ---------------------------------------------------------------------------


def burst_draws(keys: torch.Tensor, n: int):
    """The random numbers of ``burst_arrivals`` for keys [..., 2]: the
    chain's flip uniforms and the arrival uniforms, each [..., n].  They do
    not depend on the state, so the simulator draws a whole epoch's ticks
    in one call."""
    k = rng.split(keys)
    return rng.uniform(k[..., 0, :], (n,)), rng.uniform(k[..., 1, :], (n,))


@functools.lru_cache(maxsize=64)
def burst_probs(cfg: SwarmConfig):
    """(p_on_off, p_off_on, p_arrive) per tick, float32 as the reference
    computes them."""
    tick = cfg.tick_s
    duty = cfg.burst_on_s / (cfg.burst_on_s + cfg.burst_off_s)
    return (_f32_exp_prob(-tick / cfg.burst_on_s),
            _f32_exp_prob(-tick / cfg.burst_off_s),
            _f32_exp_prob(-tick / (cfg.task_period_s * duty)))


def burst_arrivals(burst_on, draws, cfg: SwarmConfig):
    """One tick of the per-node ON/OFF arrival chain; long-run mean
    inter-arrival stays ``task_period_s``, bursts arrive at rate
    1/(period·duty) while ON.  ``draws`` is ``burst_draws`` of this tick's
    key.  Returns (burst_on', arrive [.., N] bool)."""
    flip, u_arrive = draws
    p_on_off, p_off_on, p_arr = burst_probs(cfg)
    burst_on = torch.where(burst_on, flip >= p_on_off, flip < p_off_on)
    return burst_on, (u_arrive < p_arr) & burst_on

