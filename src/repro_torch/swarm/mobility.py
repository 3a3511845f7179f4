"""Mobility models, port of ``repro/swarm/mobility.py`` on [R, N] tensors.

Every model has the epoch-stepped interface of the reference:

    init(keys [R, 2], cfg, n)        -> state dict of [R, N, ...] tensors
    step(state, keys [R, 2], cfg, t0) -> (state', pos [R, N, 2])

``step`` runs once per decision epoch with the epoch start time ``t0``.

* **circular** (paper §5, the default): centres on a granularity-g grid
  over the mission area; each UAV orbits its centre at ``speed_mps``.
* **random_waypoint**, **gauss_markov**, **levy_flight**: as in the
  reference.

Every ``a * b + c`` the reference's XLA code contracts is a ``core.fp.fma``
here, so positions agree with the reference to the ulps of sin/cos.
"""
from __future__ import annotations

import math

import torch

from repro_torch import rng
from repro_torch.configs import SwarmConfig
from repro_torch.core.fp import fma

TWO_PI = 2.0 * math.pi


# ---------------------------------------------------------------------------
# circular orbits (closed form in t)
# ---------------------------------------------------------------------------


def init_mobility(keys, cfg: SwarmConfig, n: int):
    """Returns dict(center [R, N, 2], phase0 [R, N], omega [R, N])."""
    k = rng.split(keys, 3)
    kc, kp, kj = k[..., 0, :], k[..., 1, :], k[..., 2, :]
    g = cfg.placement_granularity
    idx = rng.randint(kc, (n, 2), 0, g)
    jitter = rng.uniform(kj, (n, 2), 0.25, 0.75)
    center = (idx.to(torch.float32) + jitter) * (cfg.area_m / g)
    phase0 = rng.uniform(kp, (n,), 0.0, TWO_PI)
    omega = torch.full_like(phase0, cfg.speed_mps / cfg.movement_radius_m)
    return {"center": center, "phase0": phase0, "omega": omega}


def positions_at(mob, cfg: SwarmConfig, t: float) -> torch.Tensor:
    """[R, N, 2] positions at simulation time t (seconds, float32)."""
    ang = fma(mob["omega"], t, mob["phase0"])
    off = torch.stack([torch.cos(ang), torch.sin(ang)], dim=-1)
    return fma(cfg.movement_radius_m, off, mob["center"])


def step_circular(state, keys, cfg: SwarmConfig, t0: float):
    return state, positions_at(state, cfg, t0)


# ---------------------------------------------------------------------------
# random waypoint
# ---------------------------------------------------------------------------


def init_random_waypoint(keys, cfg: SwarmConfig, n: int):
    k = rng.split(keys, 3)
    return {"pos": rng.uniform(k[..., 0, :], (n, 2), 0.0, cfg.area_m),
            "wp": rng.uniform(k[..., 1, :], (n, 2), 0.0, cfg.area_m),
            "speed": rng.uniform(k[..., 2, :], (n,), cfg.speed_min_mps,
                                 cfg.speed_max_mps)}


def step_random_waypoint(state, keys, cfg: SwarmConfig, t0: float):
    n = state["pos"].shape[-2]
    # epoch-start contract: the first epoch (t0 = 0) observes the init
    # placement; later epochs advance one decision period
    dt = cfg.decision_period_s if t0 > 0.0 else 0.0
    vec = state["wp"] - state["pos"]
    dist = torch.sqrt(fma(vec[..., 0], vec[..., 0],
                          vec[..., 1] * vec[..., 1]) + 1e-12)
    hop = state["speed"] * dt
    reached = dist <= hop
    step = vec / dist[..., None] * hop[..., None]
    pos = torch.where(reached[..., None], state["wp"], state["pos"] + step)
    k = rng.split(keys)
    wp = torch.where(reached[..., None],
                     rng.uniform(k[..., 0, :], (n, 2), 0.0, cfg.area_m),
                     state["wp"])
    speed = torch.where(reached,
                        rng.uniform(k[..., 1, :], (n,), cfg.speed_min_mps,
                                    cfg.speed_max_mps),
                        state["speed"])
    return {"pos": pos, "wp": wp, "speed": speed}, pos


# ---------------------------------------------------------------------------
# Lévy flight
# ---------------------------------------------------------------------------


def init_levy_flight(keys, cfg: SwarmConfig, n: int):
    return {"pos": rng.uniform(keys, (n, 2), 0.0, cfg.area_m)}


def _reflect(pos: torch.Tensor, A: float):
    out_lo, out_hi = pos < 0.0, pos > A
    pos = torch.where(out_lo, -pos, torch.where(out_hi, 2.0 * A - pos, pos))
    return pos.clamp(0.0, A), out_lo | out_hi


def step_levy_flight(state, keys, cfg: SwarmConfig, t0: float):
    n = state["pos"].shape[-2]
    dt = cfg.decision_period_s
    k = rng.split(keys)
    l_min = cfg.speed_min_mps * dt
    l_max = cfg.speed_max_mps * dt
    u = rng.uniform(k[..., 0, :], (n,), 1e-6, 1.0)
    hop = torch.clamp_max(l_min * torch.pow(u, -1.0 / cfg.levy_alpha), l_max)
    theta = rng.uniform(k[..., 1, :], (n,), 0.0, TWO_PI)
    step = hop[..., None] * torch.stack([torch.cos(theta),
                                         torch.sin(theta)], dim=-1)
    # epoch-start contract: the first epoch (t0 = 0) observes init placement
    pos = fma(1.0 if t0 > 0.0 else 0.0, step, state["pos"])
    pos, _ = _reflect(pos, cfg.area_m)
    return {"pos": pos}, pos


# ---------------------------------------------------------------------------
# Gauss-Markov
# ---------------------------------------------------------------------------


def init_gauss_markov(keys, cfg: SwarmConfig, n: int):
    k = rng.split(keys)
    pos = rng.uniform(k[..., 0, :], (n, 2), 0.0, cfg.area_m)
    theta = rng.uniform(k[..., 1, :], (n,), 0.0, TWO_PI)
    mean_speed = 0.5 * (cfg.speed_min_mps + cfg.speed_max_mps)
    mean_vel = mean_speed * torch.stack([torch.cos(theta), torch.sin(theta)],
                                        dim=-1)
    return {"pos": pos, "vel": mean_vel, "mean_vel": mean_vel.clone()}


def step_gauss_markov(state, keys, cfg: SwarmConfig, t0: float):
    dt = cfg.decision_period_s
    a = cfg.gm_alpha
    w = rng.normal(keys, tuple(state["vel"].shape[-2:]))
    vel = fma(cfg.gm_sigma_mps * (1.0 - a * a) ** 0.5, w,
              fma(a, state["vel"], (1.0 - a) * state["mean_vel"]))
    # epoch-start contract: no advance (and no AR velocity step) at t0 = 0
    if t0 <= 0.0:
        vel = state["vel"]
    pos = fma(vel, dt if t0 > 0.0 else 0.0, state["pos"])
    pos, bounce = _reflect(pos, cfg.area_m)
    vel = torch.where(bounce, -vel, vel)
    mean_vel = torch.where(bounce, -state["mean_vel"], state["mean_vel"])
    return {"pos": pos, "vel": vel, "mean_vel": mean_vel}, pos
