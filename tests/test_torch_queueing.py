"""Queueing-theory validation of the port's simulator (the twin of
tests/test_queueing.py, with its configs and tolerances).

Under LocalOnly with zero capability spread and a degenerate burst chain
(duty → 1), every node is an independent discrete-time Geo/D/1 queue:
Bernoulli(p_arr) arrivals per tick, ``p_arr = 1 - exp(-tick /
(task_period_s · duty))``, and deterministic service ``D =
task_gflops_total / capability_mean`` (8 ticks here), of which a task
receives its first tick's compute on arrival, so pure service shows up in
the latency metric as ``D - tick``.  The mean queue wait is the discrete
Pollaczek–Khinchine value ``W_q = ρ·(D - tick) / (2·(1 - ρ))``, ``ρ =
λ·D``, ``λ = p_arr / tick``: ``avg_latency_s = W_q + (D - tick)`` pins the
port's queue, compute and arrival plumbing against theory rather than
against the reference or its own accounting.
"""
import dataclasses
import math

import numpy as np
import pytest

from repro_torch import rng
from repro_torch.configs import SwarmConfig
from repro_torch.swarm.simulator import LOCAL_ONLY, run_many

KEY = rng.PRNGKey(0)
N, RUNS = 16, 4
TICK = 0.005


def _mdl_cfg(period_s: float) -> SwarmConfig:
    return dataclasses.replace(
        SwarmConfig(), num_workers=N, sim_time_s=30.0, tick_s=TICK,
        # deterministic service: F = capability_mean exactly, and
        # D = 12 GFLOP / 300 GFLOP/s = 40 ms = 8 ticks
        capability_mean=300.0, capability_std=0.0,
        # degenerate ON/OFF chain: duty -> 1, i.e. plain memoryless arrivals
        burst_on_s=1e6, burst_off_s=1e-6,
        task_period_s=period_s)


def _analytics(cfg: SwarmConfig):
    D = cfg.task_gflops_total / cfg.capability_mean
    duty = cfg.burst_on_s / (cfg.burst_on_s + cfg.burst_off_s)
    p_arr = 1.0 - math.exp(-cfg.tick_s / (cfg.task_period_s * duty))
    lam = p_arr / cfg.tick_s
    rho = lam * D
    wq_disc = rho * (D - cfg.tick_s) / (2.0 * (1.0 - rho))
    wq_cont = rho * D / (2.0 * (1.0 - rho))
    return D, rho, wq_disc, wq_cont


def _run(cfg: SwarmConfig) -> dict:
    m = run_many(KEY, cfg, LOCAL_ONLY, N, RUNS, device="cpu")
    return {k: v.numpy() for k, v in m.items()}


@pytest.fixture(scope="module")
def measured():
    return {period: (_mdl_cfg(period), _run(_mdl_cfg(period)))
            for period in (0.12, 0.06)}       # rho ~= 0.33 and ~= 0.64


@pytest.mark.parametrize("period", [0.12, 0.06])
def test_queue_wait_matches_pollaczek_khinchine(measured, period):
    cfg, m = measured[period]
    D, rho, wq_disc, wq_cont = _analytics(cfg)
    assert rho < 1.0
    # the queue never saturates: the analytic regime requires no loss
    assert m["dropped"].sum() == 0.0
    wq_meas = m["avg_latency_s"] - (D - cfg.tick_s)
    # ~16k / ~31k completed tasks per point: Monte-Carlo error on the mean
    # wait is < 1%, so an 8% band is dominated by model error, not noise
    np.testing.assert_allclose(wq_meas.mean(), wq_disc, rtol=0.08)
    # and the textbook continuous M/D/1 value is the tick -> 0 limit: it
    # must bracket the measurement from above within ~15%
    assert wq_meas.mean() < wq_cont * 1.05
    assert wq_meas.mean() > wq_cont * 0.85


def test_queue_wait_grows_with_load(measured):
    (_, lo), (_, hi) = measured[0.12], measured[0.06]
    D = _mdl_cfg(0.06).task_gflops_total / _mdl_cfg(0.06).capability_mean
    assert (hi["avg_latency_s"] - (D - TICK)).mean() > \
        2.5 * (lo["avg_latency_s"] - (D - TICK)).mean()


@pytest.mark.parametrize("period", [0.12, 0.06])
def test_arrival_rate_matches_bernoulli_thinning(measured, period):
    """Generated-task counts pin the arrival side of the model: n nodes x
    ticks x p_arr, within Monte-Carlo error (binomial, ~1%)."""
    cfg, m = measured[period]
    duty = cfg.burst_on_s / (cfg.burst_on_s + cfg.burst_off_s)
    p_arr = 1.0 - math.exp(-cfg.tick_s / (cfg.task_period_s * duty))
    ticks = round(cfg.sim_time_s / cfg.tick_s)
    expect = N * ticks * p_arr
    np.testing.assert_allclose(m["generated"].mean(), expect, rtol=0.03)


def test_service_floor_at_vanishing_load():
    """rho -> 0: latency collapses to the pure service time D - tick and
    the wait formula's prediction goes to ~0 with it."""
    cfg = _mdl_cfg(2.0)                    # rho ~= 0.02
    D, rho, wq_disc, _ = _analytics(cfg)
    lat = float(_run(cfg)["avg_latency_s"].mean())
    assert wq_disc < 1e-3
    assert lat == pytest.approx(D - cfg.tick_s, abs=2e-3)
