"""Scenario registries (mobility, channel, fault) and the bursty arrival
process, port of ``repro/swarm/scenario.py``.

A model is selected by the string fields of ``SwarmConfig``; unknown names
raise ``KeyError``.  Every model of the reference is registered.
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
    if cfg.channel_model == "log_normal_corr":
        raise KeyError("channel model 'log_normal_corr' has no per-edge "
                       "(sparse) implementation; use neighbor_mode='dense'")
    return _lookup(CHANNEL_EDGE_MODELS, "edge channel", cfg.channel_model)


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

