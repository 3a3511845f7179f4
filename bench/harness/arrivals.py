"""Arrival times and request lengths of the serve mixes, drawn from a seed.

The processes are those of ``repro_torch.obs.loadgen`` (a homogeneous
Poisson process, and a two-state Markov-modulated Poisson process whose
dwell means are ``SwarmConfig.burst_on_s`` / ``burst_off_s``), frozen here
so that a change to the program cannot move the yardstick.  Two changes
to them:

* a draw takes the same multiset of inter-arrival gaps, dwells and
  lengths whatever its generator (the quantiles of their distributions at
  the midpoints of equal strata), in an order the generator draws; the
  serve driver draws once per mix, from its ``schedule_seed``;
* the modulating chain may start in its high state (``start_high``).

Everything here is numpy on the host, a pure function of its arguments.
"""
from __future__ import annotations

import math
from statistics import NormalDist
from typing import List, Tuple

import numpy as np

def rng_for(seed: int, stream: str) -> np.random.Generator:
    """An independent generator for one named stream of one seed (any
    non-negative whole number, of any size)."""
    tag = int.from_bytes(stream.encode(), "little") % (1 << 61)
    return np.random.default_rng([int(seed) % (1 << 64), tag])


def _mid_quantiles(n: int) -> np.ndarray:
    return (np.arange(n, dtype=np.float64) + 0.5) / n


def exp_gaps(n: int, mean: float, rng: np.random.Generator) -> np.ndarray:
    """``n`` exponential gaps of mean ``mean``: the distribution's
    quantiles at the midpoints of ``n`` equal strata, in the order ``rng``
    draws."""
    if n <= 0:
        return np.zeros((0,), np.float64)
    return rng.permutation(-np.log1p(-_mid_quantiles(n)) * mean)


def poisson_arrivals(rate_hz: float, horizon_s: float,
                     rng: np.random.Generator) -> np.ndarray:
    """Arrival times on [0, horizon) at ``rate_hz``: ``round(rate ·
    horizon)`` arrivals whose gaps are ``exp_gaps`` scaled to span the
    horizon (the last gap ends at the horizon, and takes no arrival)."""
    n = int(round(rate_hz * horizon_s))
    if n <= 0:
        return np.zeros((0,), np.float64)
    gaps = exp_gaps(n, 1.0 / rate_hz, rng)
    times = np.cumsum(gaps) * (horizon_s / gaps.sum())
    return times[:-1]


def mmpp_arrivals(rate_lo_hz: float, rate_hi_hz: float, horizon_s: float,
                  rng: np.random.Generator, *, mean_lo_s: float,
                  mean_hi_s: float, start_high: bool
                  ) -> Tuple[np.ndarray, List[Tuple[float, float, bool]]]:
    """A two-state Markov-modulated Poisson process on [0, horizon):
    exponential dwells (means ``mean_lo_s`` / ``mean_hi_s``, each state's
    dwells the quantiles of ``exp_gaps`` over as many cycles as cover the
    horizon twice), Poisson arrivals at the state's rate inside each
    dwell (``poisson_arrivals`` over the dwell).  Returns the sorted
    arrival times and the dwells as (start, end, high)."""
    cycles = max(2, int(math.ceil(2 * horizon_s / (mean_lo_s + mean_hi_s))))
    hi = list(exp_gaps(cycles, mean_hi_s, rng))
    lo = list(exp_gaps(cycles, mean_lo_s, rng))
    out, dwells = [], []
    t, high = 0.0, start_high
    while t < horizon_s and (hi if high else lo):
        end = min(t + (hi if high else lo).pop(), horizon_s)
        rate = rate_hi_hz if high else rate_lo_hz
        out.append(t + poisson_arrivals(rate, end - t, rng))
        dwells.append((t, end, high))
        t, high = end, not high
    return np.sort(np.concatenate(out)), dwells


def lognormal_lengths(n: int, median: float, sigma: float, lo: int, hi: int,
                      multiple: int, rng: np.random.Generator
                      ) -> np.ndarray:
    """``n`` lengths: the log-normal's quantiles (median ``median``, log
    standard deviation ``sigma``) at the midpoints of ``n`` strata, clipped
    to [lo, hi], rounded up to a multiple of ``multiple``, in the order
    ``rng`` draws."""
    if n <= 0:
        return np.zeros((0,), np.int64)
    z = np.array([NormalDist().inv_cdf(u) for u in _mid_quantiles(n)])
    s = np.clip(median * np.exp(sigma * z), lo, hi)
    s = np.ceil(s / multiple).astype(np.int64) * multiple
    return rng.permutation(s)


def length_buckets(lo: int, hi: int, multiple: int) -> List[int]:
    """Every length ``lognormal_lengths`` can give: the shapes to warm."""
    first = int(math.ceil(lo / multiple)) * multiple
    return list(range(first, hi + 1, multiple))
