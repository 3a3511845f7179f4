"""The last two channel models of the reference, ported: ``log_normal_corr``
(a Cholesky field over the nodes, dense only) and ``nakagami`` (a gamma
rejection sampler, dense and per edge), with ``rng.gamma`` under them.

What each comparison with JAX is:

* ``log_normal_corr``: within a tolerance, rtol 1e-4 (the Cholesky
  factor and ``chol @ z`` are LAPACK/BLAS on both sides, ulps apart); a
  covariance that is not positive definite gives NaN for NaN, as JAX's.
* ``rng.gamma`` against ``jax.random.gamma`` for the same keys: the keys,
  splits and uniforms are exact, ``normal`` and ``log`` ulp-level, so an
  element's acceptance test can flip and its draw then differs entirely.
  At least 99 % of the elements are exact; the rest pass a two-sample KS
  test (p > 1e-3).  ``nakagami`` and ``nakagami_edges`` inherit that:
  99 % of links within rtol 1e-5, a KS test on the rest.
* A whole simulation under either channel is therefore *statistical*: the
  per-run indices' 95 % CIs must overlap JAX's.
* Within the port, the contract tests of ``tests/test_scenarios.py``
  (finite, symmetric, key-varying, unit-mean fading, Gudmundson
  decorrelation, Nakagami concentration) and the per-edge symmetry of
  ``tests/test_sparse.py`` hold.
"""
import dataclasses

import numpy as np
import pytest
from scipy import stats

torch = pytest.importorskip("torch")
import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

import repro.fleet as jfleet  # noqa: E402
from repro.configs.base import SwarmConfig as JCfg  # noqa: E402
from repro.swarm import channel as jch  # noqa: E402
from repro_torch import rng  # noqa: E402
from repro_torch.configs import SwarmConfig  # noqa: E402
from repro_torch.fleet import build_report, run_batch  # noqa: E402
from repro_torch.swarm import channel as tch  # noqa: E402
from repro_torch.swarm.scenario import (CHANNEL_MODELS,  # noqa: E402
                                        get_channel)
from repro_torch.swarm.simulator import DISTRIBUTED  # noqa: E402
from repro_torch.trace import decode  # noqa: E402

torch.set_num_threads(1)
CFG = SwarmConfig()
JC = JCfg(**dataclasses.asdict(CFG))
R, N = 4, 30


def _keys(seed, n):
    k = np.asarray(jax.random.split(jax.random.PRNGKey(seed), n))
    return k, torch.from_numpy(k.copy()).to(torch.uint32)


def _positions(seed=0, span=2000.0):
    return np.random.default_rng(seed).uniform(
        0, span, size=(R, N, 2)).astype(np.float32)


def assert_mostly_exact(got, want, rtol=0.0, share=0.99):
    """At least ``share`` of the elements equal (within ``rtol``); the
    others, whose rejection loop flipped, pass a two-sample KS test."""
    ok = np.isclose(got, want, rtol=rtol, atol=0.0) if rtol else \
        got == want
    assert ok.mean() >= share, ok.mean()
    if not ok.all():
        assert stats.ks_2samp(got[~ok], want[~ok],
                              method="asymp").pvalue > 1e-3


# ---------------------------------------------------------------------------
# against JAX
# ---------------------------------------------------------------------------


def test_log_normal_corr_matches_reference():
    jk, tk = _keys(1, R)
    pos = _positions()
    want = np.asarray(jax.vmap(lambda k, p: jch.log_normal_corr(
        k, jch.pairwise_distance(p), JC))(jk, pos))
    got = tch.log_normal_corr(tk, tch.pairwise_distance(
        torch.from_numpy(pos)), CFG).numpy()
    assert np.isfinite(got).all()
    np.testing.assert_allclose(got, want, rtol=1e-4)


def test_log_normal_corr_not_positive_definite_is_nan_for_nan():
    """Run 0's 'distances' give a correlation matrix with a negative
    eigenvalue: JAX's Cholesky yields NaN there, and so does the port's,
    without touching run 1."""
    d = np.array([[[0, 0, 0], [0, 0, 1e9], [0, 1e9, 0]],
                  [[0, 100, 200], [100, 0, 150], [200, 150, 0]]], np.float32)
    jk, tk = _keys(1, 2)
    want = np.asarray(jax.vmap(lambda k, x: jch.log_normal_corr(k, x, JC))(
        jk, d))
    got = tch.log_normal_corr(tk, torch.from_numpy(d), CFG).numpy()
    np.testing.assert_array_equal(np.isnan(got), np.isnan(want))
    assert np.isnan(got[0]).all() and np.isfinite(got[1]).all()
    np.testing.assert_allclose(got[1], want[1], rtol=1e-4)


@pytest.mark.parametrize("a", [0.5, 1.0, 2.0, 64.0])
def test_gamma_matches_jax_random_gamma(a):
    jk, tk = _keys(3, 4)
    shape = (40, 50)
    want = np.asarray(jax.vmap(lambda k: jax.random.gamma(
        k, jnp.float32(a), shape, jnp.float32))(jk))
    got = rng.gamma(tk, a, shape).numpy()
    assert got.shape == want.shape == (4, *shape) and got.dtype == np.float32
    assert (got > 0).all()
    assert_mostly_exact(got, want)


def test_gamma_scalar_draws_split_each_key_once():
    """The per-edge draw is a scalar gamma per key: jax splits each key
    into one (``split(key, 1)``), and the port does the same."""
    jk, tk = _keys(4, 3000)
    want = np.asarray(jax.vmap(lambda k: jax.random.gamma(
        k, jnp.float32(2.0), (), jnp.float32))(jk))
    got = rng.gamma(tk, 2.0, ()).numpy()
    assert got.shape == (3000,)
    assert_mostly_exact(got, want)


def test_nakagami_matches_reference():
    jk, tk = _keys(5, R)
    pos = _positions(1)
    want = np.asarray(jax.vmap(lambda k, p: jch.nakagami(
        k, jch.pairwise_distance(p), JC))(jk, pos))
    got = tch.nakagami(tk, tch.pairwise_distance(torch.from_numpy(pos)),
                       CFG).numpy()
    assert_mostly_exact(got, want, rtol=1e-5)


def test_nakagami_edges_matches_reference():
    g = np.random.default_rng(2)
    K = 8
    src = np.broadcast_to(np.arange(N, dtype=np.int32)[None, :, None],
                          (R, N, K)).copy()
    dst = g.integers(0, N, size=(R, N, K)).astype(np.int32)
    dist = g.uniform(10, 2000, size=(R, N, K)).astype(np.float32)
    jk, tk = _keys(6, R)
    want = np.asarray(jax.vmap(lambda k, d, s, t: jch.nakagami_edges(
        k, d, s, t, JC))(jk, dist, src, dst))
    got = tch.nakagami_edges(tk, torch.from_numpy(dist),
                             torch.from_numpy(src), torch.from_numpy(dst),
                             CFG).numpy()
    assert_mostly_exact(got, want, rtol=1e-5)


# ---------------------------------------------------------------------------
# the contract tests of tests/test_scenarios.py, on the port
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("name", ["two_ray", "free_space", "log_normal",
                                  "log_normal_corr", "rician", "nakagami"])
def test_channel_link_state_contract(name):
    cfg = dataclasses.replace(CFG, channel_model=name)
    _, tk = _keys(0, R)
    pos = rng.uniform(tk, (N, 2), 0.0, cfg.area_m)
    adj, cap = tch.link_state(pos, cfg, key=tk, pathloss_fn=get_channel(cfg))
    assert adj.shape == (R, N, N) and cap.shape == (R, N, N)
    assert not adj.diagonal(dim1=-2, dim2=-1).any()
    assert (cap > 0.0).all() and torch.isfinite(cap).all()
    assert torch.equal(adj, adj.transpose(-1, -2))


@pytest.mark.parametrize("name", ["log_normal", "log_normal_corr", "rician",
                                  "nakagami"])
def test_stochastic_channel_varies_with_key_but_not_baseline(name):
    fn = CHANNEL_MODELS[name]
    d = torch.full((1, 4, 4), 2_000.0)
    pl1 = fn(_keys(1, 1)[1], d, CFG)[0].numpy()
    pl2 = fn(_keys(2, 1)[1], d, CFG)[0].numpy()
    off = ~np.eye(4, dtype=bool)
    assert not np.allclose(pl1[off], pl2[off])
    np.testing.assert_array_equal(np.diag(pl1), np.diag(pl2))
    np.testing.assert_allclose(pl1, pl1.T)


@pytest.mark.parametrize("name", ["rician", "nakagami"])
def test_fading_gain_is_unit_mean_around_log_distance_baseline(name):
    n = 200
    d = torch.full((1, n, n), 2_000.0)
    pl = CHANNEL_MODELS[name](_keys(0, 1)[1], d, CFG)[0].numpy()
    base = float(tch._log_distance_db(torch.tensor(2_000.0), CFG))
    g = 10.0 ** ((base - pl) / 10.0)
    off = ~np.eye(n, dtype=bool)
    assert abs(g[off].mean() - 1.0) < 0.05
    assert g[off].std() > 0.05


def test_correlated_shadowing_follows_gudmundson_decorrelation():
    """Links between distinct endpoint pairs co-shadow when the endpoints
    sit within the decorrelation distance and not far outside it, and
    every link keeps the marginal N(0, σ²).  The 400 draws are 400 runs of
    one batched call."""
    pos = torch.tensor([[0.0, 0.0], [10.0, 0.0], [5_000.0, 0.0],
                        [5_010.0, 0.0]])
    dist = tch.pairwise_distance(pos[None]).expand(400, 4, 4)
    base = tch._log_distance_db(dist, CFG)
    keys = torch.stack([rng.PRNGKey(i) for i in range(400)])

    def samples(corr_m):
        cfg = dataclasses.replace(CFG, shadow_corr_m=corr_m)
        x = (tch.log_normal_corr(keys, dist, cfg) - base).numpy()
        return x[:, 0, 2], x[:, 1, 3]

    a, b = samples(50_000.0)
    assert np.corrcoef(a, b)[0, 1] > 0.8
    a, b = samples(1.0)
    assert abs(np.corrcoef(a, b)[0, 1]) < 0.3
    assert abs(a.std() - CFG.shadowing_sigma_db) < 1.0


def test_nakagami_concentrates_with_large_m():
    d = torch.full((1, 64, 64), 2_000.0)
    off = ~np.eye(64, dtype=bool)
    spread = {m: tch.nakagami(_keys(0, 1)[1], d, dataclasses.replace(
        CFG, nakagami_m=m))[0].numpy()[off].std() for m in (1.0, 64.0)}
    assert spread[64.0] < spread[1.0] / 3.0


def test_edge_draws_are_symmetric():
    """The per-edge draw on (i, j) equals the one on (j, i)
    (``tests/test_sparse.py``)."""
    key = rng.fold_in(rng.PRNGKey(0), 7)[None]
    src = torch.tensor([[[0, 3, 5]]], dtype=torch.int32)
    dst = torch.tensor([[[3, 0, 2]]], dtype=torch.int32)
    d = torch.full((1, 1, 3), 800.0)
    for fn in (tch.log_normal_edges, tch.nakagami_edges):
        pl = fn(key, d, src, dst, CFG)[0, 0].numpy()
        assert pl[0] == pl[1], fn.__name__
        assert pl[0] != pl[2], fn.__name__


# ---------------------------------------------------------------------------
# a traced simulation under each channel, held statistically against JAX
# ---------------------------------------------------------------------------

SIM_INDICES = ("completed", "generated", "avg_latency_s", "transfers",
               "energy_per_task_j", "throughput_tps")


@pytest.mark.parametrize("channel,extra", [
    ("log_normal_corr", {}), ("nakagami", {}),
    ("nakagami", {"neighbor_mode": "sparse", "neighbor_k": 6})],
    ids=["log_normal_corr", "nakagami", "nakagami_edges"])
def test_traced_simulation_under_channel_matches_reference_statistically(
        channel, extra):
    """Statistical, not exact: the per-run indices' 95 % CIs overlap
    JAX's, and the task records account for every finished task."""
    cfg = dataclasses.replace(CFG, num_workers=12, sim_time_s=5.0,
                              channel_model=channel, trace_capacity=2048,
                              trace_hop_capacity=512, **extra)
    got = {k: v.numpy() for k, v in run_batch(
        rng.PRNGKey(0), cfg, DISTRIBUTED, 12, R, device="cpu").items()}
    want = {k: np.asarray(v) for k, v in jfleet.run_batch(
        jax.random.PRNGKey(0), JCfg(**dataclasses.asdict(cfg)),
        jnp.int32(DISTRIBUTED), 12, R).items()}
    assert sorted(got) == sorted(want)
    g = build_report({"p": got})["points"]["p"]
    w = jfleet.build_report({"p": want})["points"]["p"]
    for k in SIM_INDICES:
        assert abs(g[k]["mean"] - w[k]["mean"]) <= \
            g[k]["ci95"] + w[k]["ci95"] + 1e-9, (k, g[k], w[k])
    assert g["transfers"]["mean"] > 0
    dec = decode(got["trace_records"], got["trace_overflow"])
    assert dec["seq"].size == int(got["completed"].sum()
                                  + got["dropped"].sum())
