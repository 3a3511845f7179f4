"""repro_torch.core (Eqs. 9-16) against repro.core on the same numpy inputs.

Tolerance: rtol 1e-5, atol 1e-7 for floats (the kernel tests' tolerance);
integer and boolean outputs (targets, transfer predicates, labels, layers)
exact.  The sparse φ update equals the dense one bit for bit where the
lists cover every neighbour.
"""
import numpy as np
import pytest

torch = pytest.importorskip("torch")
import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from repro.core import decision as jdec  # noqa: E402
from repro.core import diffusive as jdiff  # noqa: E402
from repro.core import early_exit as jee  # noqa: E402
from repro_torch.core import decision as tdec  # noqa: E402
from repro_torch.core import diffusive as tdiff  # noqa: E402
from repro_torch.core import early_exit as tee  # noqa: E402

torch.set_num_threads(1)
TOL = dict(rtol=1e-5, atol=1e-7)


def _graph(R, N, seed, p=0.35):
    g = np.random.default_rng(seed)
    F = g.uniform(100, 500, (R, N)).astype(np.float32)
    phi = g.uniform(50, 800, (R, N)).astype(np.float32)
    adj = (g.uniform(size=(R, N, N)) < p) & ~np.eye(N, dtype=bool)
    adj[:, 1, :] = False
    adj[:, :, 1] = False                 # node 1 isolated
    dtx = g.uniform(1e-4, 1e-2, (R, N, N)).astype(np.float32)
    T = g.uniform(0, 40, (R, N)).astype(np.float32)
    T[:, 2] = T[:, 3]                    # a utilization tie candidate
    return F, phi, adj, dtx, T


def _lists(adj, dtx):
    R, N, _ = adj.shape
    nbr = np.broadcast_to(np.arange(N, dtype=np.int32), (R, N, N)).copy()
    return np.where(adj, nbr, 0).astype(np.int32), dtx


def _t(*a):
    return [torch.from_numpy(np.ascontiguousarray(x)) for x in a]


@pytest.mark.parametrize("R,N,seed", [(1, 12, 0), (3, 30, 1), (2, 64, 2)])
def test_phi_updates_match_reference(R, N, seed):
    F, phi, adj, dtx, _ = _graph(R, N, seed)
    want = np.stack([np.asarray(jdiff.phi_update(phi[r], F[r], adj[r],
                                                 dtx[r])) for r in range(R)])
    want_op = np.asarray(jdiff.phi_update_op(phi, F, adj, dtx))
    got = tdiff.phi_update(*_t(phi, F, adj, dtx)).numpy()
    got_op = tdiff.phi_update_op(*_t(phi, F, adj, dtx)).numpy()
    np.testing.assert_allclose(got, want, **TOL)
    np.testing.assert_allclose(got_op, want_op, **TOL)
    np.testing.assert_array_equal(got[:, 1], F[:, 1])      # isolated: φ = F
    # one unbatched [N] call takes the same path
    one = tdiff.phi_update_op(*_t(phi[0], F[0], adj[0], dtx[0])).numpy()
    np.testing.assert_array_equal(one, got_op[0])
    # sparse lists covering every neighbour: bit-identical to dense
    nbr, dtx_e = _lists(adj, dtx)
    sp = tdiff.phi_update_sparse(*_t(phi, F, adj, nbr, dtx_e)).numpy()
    sp_op = tdiff.phi_update_op_sparse(*_t(phi, F, adj, nbr, dtx_e)).numpy()
    np.testing.assert_array_equal(sp, got)
    np.testing.assert_array_equal(sp_op, got_op)
    want_sp = np.asarray(jdiff.phi_update_op_sparse(phi, F, adj, nbr, dtx_e))
    np.testing.assert_allclose(sp_op, want_sp, **TOL)


def test_fixpoint_bounds_and_neighbor_mask():
    F, _, adj, dtx, _ = _graph(1, 20, 5)
    jphi, jres = jdiff.phi_fixpoint(F[0], adj[0], dtx[0], iters=12)
    tphi, tres = tdiff.phi_fixpoint(*_t(F[0], adj[0], dtx[0]), iters=12)
    np.testing.assert_allclose(tphi.numpy(), np.asarray(jphi), **TOL)
    np.testing.assert_allclose(tres.numpy(), np.asarray(jres), rtol=1e-4,
                               atol=1e-9)
    assert bool(tdiff.phi_bounds_ok(tphi, *_t(F[0], adj[0])))
    assert bool(jdiff.phi_bounds_ok(jphi, F[0], adj[0]))
    snr = np.random.default_rng(0).uniform(-10, 20, (15, 15)).astype(
        np.float32)
    np.testing.assert_array_equal(
        tdiff.neighbor_mask(torch.from_numpy(snr), 3.0).numpy(),
        np.asarray(jdiff.neighbor_mask(snr, 3.0)))


@pytest.mark.parametrize("R,N,seed", [(2, 12, 3), (4, 30, 4)])
def test_transfer_decision_dense_and_sparse(R, N, seed):
    _, phi, adj, _, T = _graph(R, N, seed)
    for r in range(R):
        want = jdec.transfer_decision(T[r], phi[r], adj[r], 0.02)
        got = tdec.transfer_decision(*_t(T[r], phi[r], adj[r]), 0.02)
        np.testing.assert_allclose(got.utilization.numpy(),
                                   np.asarray(want.utilization), **TOL)
        assert got.target.dtype == torch.int32
        np.testing.assert_array_equal(got.target.numpy(),
                                      np.asarray(want.target))
        np.testing.assert_array_equal(got.transfer.numpy(),
                                      np.asarray(want.transfer))
    nbr, _ = _lists(adj, adj)
    dense = tdec.transfer_decision(*_t(T, phi, adj), 0.02)
    sparse = tdec.transfer_decision_sparse(*_t(T, phi, adj, nbr), 0.02)
    for a, b in zip(dense, sparse, strict=True):
        assert torch.equal(a, b)
    jsp = jax.vmap(lambda t, p, a, n: jdec.transfer_decision_sparse(
        t, p, a, n, 0.02))(T, phi, adj, nbr)
    np.testing.assert_array_equal(sparse.target.numpy(),
                                  np.asarray(jsp.target))


def test_early_exit_matches_reference():
    g = np.random.default_rng(9)
    T = g.uniform(0, 50, (3, 40)).astype(np.float32)
    prev = g.uniform(0, 50, (3, 40)).astype(np.float32)
    D = g.uniform(-5, 5, (3, 40)).astype(np.float32)
    want = jee.congestion_update(jee.CongestionState(prev, D), T, 0.2, 0.3)
    got = tee.congestion_update(tee.CongestionState(*_t(prev, D)),
                                torch.from_numpy(T), 0.2, 0.3)
    np.testing.assert_array_equal(got.prev_T.numpy(), np.asarray(want.prev_T))
    np.testing.assert_allclose(got.D.numpy(), np.asarray(want.D), **TOL)
    lbl_j = jee.exit_label(want.D, 1.5, 2.5)
    lbl_t = tee.exit_label(got.D, 1.5, 2.5)
    assert lbl_t.dtype == torch.int32
    np.testing.assert_array_equal(lbl_t.numpy(), np.asarray(lbl_j))
    lbl = torch.tensor([0, 1, 2, 1, 0], dtype=torch.int32)
    np.testing.assert_array_equal(
        tee.exit_boundary_layers(lbl, (15, 30, 60), 3).numpy(),
        np.asarray(jee.exit_boundary_layers(jnp.asarray(lbl.numpy()),
                                            (15, 30, 60), 3)))
    np.testing.assert_array_equal(
        tee.exit_accuracy(lbl, (0.6, 0.9, 0.95)).numpy(),
        np.asarray(jee.exit_accuracy(jnp.asarray(lbl.numpy()),
                                     (0.6, 0.9, 0.95))))


@pytest.mark.parametrize("early_exit", [True, False])
def test_decision_epoch_matches_reference(early_exit):
    from repro.core import protocol as jproto
    from repro_torch.core import protocol as tproto

    F, _, adj, dtx, T = _graph(1, 24, 7)
    F, adj, dtx, T = F[0], adj[0], dtx[0], T[0]
    kw = dict(gamma=0.02, dt=0.2, alpha=0.3, tau_med=1.5, tau_high=2.5,
              exit_points=(15, 30, 60), finalize_layers=3,
              early_exit_enabled=early_exit)
    js, ts = jproto.init_protocol(F), tproto.init_protocol(
        torch.from_numpy(F))
    for step in range(3):
        Tq = T * (step + 1)
        jo = jproto.decision_epoch(js, F=F, adj=adj, d_tx=dtx,
                                   queued_gflops=Tq, **kw)
        to = tproto.decision_epoch(ts, F=torch.from_numpy(F),
                                   adj=torch.from_numpy(adj),
                                   d_tx=torch.from_numpy(dtx),
                                   queued_gflops=torch.from_numpy(Tq), **kw)
        np.testing.assert_allclose(to.state.phi.numpy(),
                                   np.asarray(jo.state.phi), **TOL)
        np.testing.assert_allclose(to.state.congestion.D.numpy(),
                                   np.asarray(jo.state.congestion.D), **TOL)
        for a, b in ((to.decision.target, jo.decision.target),
                     (to.decision.transfer, jo.decision.transfer),
                     (to.exit_lbl, jo.exit_lbl),
                     (to.exit_layers, jo.exit_layers)):
            np.testing.assert_array_equal(a.numpy(), np.asarray(b))
        js, ts = jo.state, to.state
