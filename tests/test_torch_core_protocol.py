"""The eleven protocol properties of tests/test_core_protocol.py (Eqs. 9-16)
on the port's public ``repro_torch.core`` API, with the reference's
sizes, seeds and ``settings``; where a property computes a value the
reference computes too, the two are held together (floats rtol 1e-5)."""
import hypothesis.strategies as st
import numpy as np
import pytest
from hypothesis import given, settings

torch = pytest.importorskip("torch")
import jax.numpy as jnp  # noqa: E402

import repro.core as jcore  # noqa: E402
from repro_torch.configs import SwarmConfig  # noqa: E402
from repro_torch.core import (CongestionState, congestion_update,  # noqa: E402
                              decision_epoch, exit_accuracy,
                              exit_boundary_layers, exit_label,
                              init_protocol, phi_bounds_ok, phi_fixpoint,
                              phi_update, transfer_decision)

torch.set_num_threads(1)


def t(x, dtype=torch.float32):
    return torch.as_tensor(np.asarray(x)).to(dtype)


def ring_topology(n, d=1e-3):
    adj = np.zeros((n, n), bool)
    for i in range(n):
        adj[i, (i + 1) % n] = adj[i, (i - 1) % n] = True
    return torch.from_numpy(adj), torch.full((n, n), d, dtype=torch.float32)


# ---------------------------------------------------------------------------
# Eq. 10 — diffusive metric
# ---------------------------------------------------------------------------


def test_phi_isolated_node_equals_local_capability():
    F = t([100.0, 200.0, 300.0])
    adj = torch.zeros((3, 3), dtype=torch.bool)
    d_tx = torch.zeros((3, 3))
    phi = phi_update(F, F, adj, d_tx)
    np.testing.assert_allclose(phi.numpy(), F.numpy())


def test_phi_converges_geometrically_on_connected_graph():
    """Paper's claim: residuals contract >= 2x per round for |M_i| >= 1."""
    n = 24
    adj, d_tx = ring_topology(n)
    F = t(np.random.default_rng(0).uniform(100, 800, n))
    phi, residuals = phi_fixpoint(F, adj, d_tx, iters=20)
    res = residuals.numpy()
    assert res[-1] < 1e-6
    late = res[3:12]
    ratios = late[1:] / np.maximum(late[:-1], 1e-30)
    assert np.all(ratios < 0.75), ratios
    jphi, jres = jcore.phi_fixpoint(jnp.asarray(F.numpy()),
                                    jnp.asarray(adj.numpy()),
                                    jnp.asarray(d_tx.numpy()), iters=20)
    np.testing.assert_allclose(phi.numpy(), np.asarray(jphi), rtol=1e-5)


def test_phi_bounds_invariant():
    n = 16
    rng = np.random.default_rng(1)
    adj = rng.uniform(size=(n, n)) < 0.4
    adj = np.logical_and(adj, ~np.eye(n, dtype=bool))
    F = t(rng.uniform(100, 500, n))
    d_tx = torch.where(torch.from_numpy(adj), 1e-3, -1e30).float()
    phi, _ = phi_fixpoint(F, torch.from_numpy(adj), d_tx, iters=16)
    assert bool(phi_bounds_ok(phi, F, torch.from_numpy(adj)))


def test_phi_prefers_fast_neighborhoods():
    """A node with strong neighbors must end with higher φ than an identical
    node with weak neighbors (the metric's whole point)."""
    F = t([200.0, 800.0, 800.0, 200.0, 50.0, 50.0])
    adj = np.zeros((6, 6), bool)
    adj[0, 1] = adj[1, 0] = adj[0, 2] = adj[2, 0] = True
    adj[3, 4] = adj[4, 3] = adj[3, 5] = adj[5, 3] = True
    d_tx = torch.where(torch.from_numpy(adj), 1e-4, -1e30).float()
    phi, _ = phi_fixpoint(F, torch.from_numpy(adj), d_tx, iters=16)
    assert float(phi[0]) > float(phi[3])


@settings(max_examples=40, deadline=None)
@given(
    n=st.integers(3, 20),
    seed=st.integers(0, 2**31 - 1),
)
def test_phi_update_positive_and_finite(n, seed):
    rng = np.random.default_rng(seed)
    F = rng.uniform(50, 1000, n).astype(np.float32)
    adj = rng.uniform(size=(n, n)) < 0.5
    adj = np.logical_and(adj, ~np.eye(n, dtype=bool))
    d_tx = np.where(adj, rng.uniform(1e-5, 1e-2, (n, n)).astype(np.float32),
                    np.float32(-1e30)).astype(np.float32)
    phi, jphi = t(F), jnp.asarray(F)
    for _ in range(5):
        phi = phi_update(phi, t(F), torch.from_numpy(adj), t(d_tx))
        jphi = jcore.phi_update(jphi, jnp.asarray(F), jnp.asarray(adj),
                                jnp.asarray(d_tx))
        a = phi.numpy()
        assert np.all(np.isfinite(a)) and np.all(a > 0)
        np.testing.assert_allclose(a, np.asarray(jphi), rtol=1e-5)


# ---------------------------------------------------------------------------
# Eqs. 11-13 — transfer decision
# ---------------------------------------------------------------------------


def test_transfer_picks_least_utilized_neighbor_and_respects_gamma():
    phi = t([100.0, 100.0, 100.0])
    T = t([50.0, 10.0, 30.0])      # U = [.5, .1, .3]
    adj = torch.from_numpy(~np.eye(3, dtype=bool))
    dec = transfer_decision(T, phi, adj, gamma=0.1)
    assert int(dec.target[0]) == 1           # least utilized neighbor
    assert bool(dec.transfer[0])             # 0.5 - 0.1 > γ
    assert not bool(dec.transfer[1])         # already the least utilized
    dec2 = transfer_decision(T, phi, adj, gamma=10.0)
    assert not bool(dec2.transfer.any())


def test_no_neighbors_means_no_transfer():
    dec = transfer_decision(t([99.0]), t([1.0]),
                            torch.zeros((1, 1), dtype=torch.bool), gamma=0.0)
    assert not bool(dec.transfer[0]) and int(dec.target[0]) == -1


# ---------------------------------------------------------------------------
# Eqs. 14-16 — congestion-aware early exit
# ---------------------------------------------------------------------------


def test_congestion_ema_and_labels():
    s = CongestionState(torch.zeros((1,)), torch.zeros((1,)))
    # queue grows by 1 GFLOP per 0.2 s epoch => dT/dt = 5
    for k in range(1, 30):
        s = congestion_update(s, t([float(k)]), 0.2, 0.3)
    assert abs(float(s.D[0]) - 5.0) < 0.1    # EMA converges to the true slope
    assert int(exit_label(s.D, 1.5, 2.5)[0]) == 2       # high congestion
    assert int(exit_label(t([2.0]), 1.5, 2.5)[0]) == 1  # medium
    assert int(exit_label(t([0.0]), 1.5, 2.5)[0]) == 0


def test_exit_boundaries_and_accuracy_levels():
    pts = (15, 30, 60)
    lbl = t([0, 1, 2], torch.int32)
    np.testing.assert_array_equal(exit_boundary_layers(lbl, pts, 3).numpy(),
                                  [60, 33, 18])
    np.testing.assert_allclose(exit_accuracy(lbl, (0.6, 0.9, 0.95)).numpy(),
                               [0.95, 0.9, 0.6])


def test_exit_boundary_layers_pins_table2_mapping():
    """Table 2 label→layers mapping, pinned against the default config:
    truncation depth decreases as congestion rises (full → L2+3 → L1+3)."""
    cfg = SwarmConfig()
    L1, L2, L_full = cfg.exit_points
    fin = cfg.exit_finalize_layers
    layers = exit_boundary_layers(t([0, 1, 2], torch.int32), cfg.exit_points,
                                  fin)
    np.testing.assert_array_equal(layers.numpy(),
                                  [L_full, L2 + fin, L1 + fin])
    # finalize layers can never push a truncated exit past the full network
    capped = exit_boundary_layers(t([1, 2], torch.int32), (59, 59, 60), 3)
    np.testing.assert_array_equal(capped.numpy(), [60, 60])


# ---------------------------------------------------------------------------
# Alg. 1 — composed epoch
# ---------------------------------------------------------------------------


def test_decision_epoch_runs_and_is_consistent():
    n = 8
    rng = np.random.default_rng(2)
    F = rng.uniform(100, 500, n).astype(np.float32)
    T = rng.uniform(0, 100, n).astype(np.float32)
    adj, d_tx = ring_topology(n)
    kw = dict(gamma=0.02, dt=0.2, alpha=0.3, tau_med=1.5, tau_high=2.5,
              exit_points=(15, 30, 60), finalize_layers=3)
    out = decision_epoch(init_protocol(t(F)), F=t(F), adj=adj, d_tx=d_tx,
                         queued_gflops=t(T), **kw)
    assert out.exit_layers.shape == (n,)
    assert bool((out.state.phi > 0).all())
    # transfers only point at actual neighbors
    tgt, tr = out.decision.target.numpy(), out.decision.transfer.numpy()
    for i in range(n):
        if tr[i]:
            assert adj[i, tgt[i]]
    want = jcore.decision_epoch(
        jcore.init_protocol(jnp.asarray(F)), F=jnp.asarray(F),
        adj=jnp.asarray(adj.numpy()), d_tx=jnp.asarray(d_tx.numpy()),
        queued_gflops=jnp.asarray(T), **kw)
    np.testing.assert_array_equal(tgt, np.asarray(want.decision.target))
    np.testing.assert_array_equal(tr, np.asarray(want.decision.transfer))
    np.testing.assert_array_equal(out.exit_layers.numpy(),
                                  np.asarray(want.exit_layers))
    np.testing.assert_allclose(out.state.phi.numpy(),
                               np.asarray(want.state.phi), rtol=1e-5)
