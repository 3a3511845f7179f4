"""The φ update on inputs with NaN, ±inf and zero φ, and the fused sparse
update ``phi_update_sparse``.

The max of Eq. 10 propagates NaN in the reference (``jnp.max``, and
``jnp.maximum`` in its Pallas kernels) and in the port's plain versions
(``torch.amax``); the CUDA kernels must do the same.  The inputs carry NaN,
+inf and -inf delays on links, NaN delays only off-link in some rows (the
adjacency mask must hide them, as ``torch.where(adj, ..., NEG)`` does), φ =
0, -0 and inf (so 1/φ is +inf, -inf and 0) and F = 0 and inf.

* On the CPU: the port's four plain φ functions (``ref.diffusive_phi``,
  ``ref.diffusive_phi_sparse``, ``ref.phi_update`` and
  ``core.diffusive.phi_update_sparse``) against the live JAX reference and
  the Pallas kernels in interpret mode, exactly
  (``np.testing.assert_array_equal``, NaN equal to NaN at the same places).
  Node 0 keeps a finite φ: the lists' invalid slots point at it, and so do
  the Pallas sparse kernel's padding slots.  Where the Pallas sparse kernel
  and its own oracle disagree (a row whose every candidate is below NEG),
  the port follows the oracle.
* On the card (marker ``cuda``, skipped without one): every φ launcher
  equals its plain twin on the same inputs, NaN for NaN; the fused sparse
  update is one launch, equal to the plain update at the simulator's
  (4, 4096, 16) and at K > 32, and to the dense update on covering lists.
"""
import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro_torch.core import diffusive as tdiff  # noqa: E402
from repro_torch.kernels import build as kbuild  # noqa: E402
from repro_torch.kernels import diffusive_phi as cuda_phi  # noqa: E402
from repro_torch.kernels import ops, ref  # noqa: E402

torch.set_num_threads(1)
NEG = -1e30


def _specials(R, N, seed=0, p=0.3):
    """(phi, F, adj, d_tx) [R, N], [R, N, N]: run 0 has φ = 0, -0 and inf
    at nodes 2-4; run 1 (where R > 1) NaN, +inf and -inf delays on every
    7th link and, in rows 5-8, NaN delays on every off-link pair only; run
    2 (where R > 2) φ = inf and 0 at nodes 5-6, F = inf and 0 at nodes 7-8
    and NaN on every link of row 9.  Node 0 has no neighbour."""
    g = np.random.default_rng(seed + 31 * N)
    F = g.uniform(100, 500, (R, N)).astype(np.float32)
    phi = g.uniform(50, 800, (R, N)).astype(np.float32)
    adj = (g.uniform(size=(R, N, N)) < p) & ~np.eye(N, dtype=bool)
    adj[:, 0, :] = False
    dtx = g.uniform(1e-4, 1e-2, (R, N, N)).astype(np.float32)
    phi[0, 2], phi[0, 3], phi[0, 4] = 0.0, -0.0, np.inf
    if R > 1:
        links = np.argwhere(adj[1])[::7]
        for (i, k), v in zip(links, [np.nan, np.inf, -np.inf] * len(links)):
            dtx[1, i, k] = v
        for i in range(5, 9):
            dtx[1, i] = np.where(adj[1, i], g.uniform(1e-4, 1e-2, N), np.nan)
    if R > 2:
        phi[2, 5], phi[2, 6] = np.inf, 0.0
        F[2, 7], F[2, 8] = np.inf, 0.0
        dtx[2, 9] = np.where(adj[2, 9], np.nan, dtx[2, 9])
    return phi, F, adj, dtx


def _lists(adj, dtx, K=None, seed=0):
    """Neighbour lists [R, N, K] from a dense graph: with K None, lists
    covering every link (slot k is node k); else K random slots a row, 60 %
    on-link, their delays drawn from the row's own (specials kept), and
    row 5 of run 1 on-link in every slot with a NaN delay in slot 0."""
    R, N, _ = adj.shape
    if K is None:
        nbr = np.broadcast_to(np.arange(N, dtype=np.int32), (R, N, N))
        return adj.copy(), np.where(adj, nbr, 0).astype(np.int32), dtx
    g = np.random.default_rng(seed + 1000 * N + K)
    nbr = g.integers(0, N, (R, N, K)).astype(np.int32)
    on = g.uniform(size=(R, N, K)) < 0.6
    on[:, 0] = False
    d_e = np.take_along_axis(dtx, nbr, axis=-1)
    if R > 1:
        on[1, 5], d_e[1, 5, 0] = True, np.nan
    return on, np.where(on, nbr, 0).astype(np.int32), d_e


def _inv(phi):
    with np.errstate(divide="ignore"):
        return (np.float32(1.0) / phi).astype(np.float32)


def _masked(adj, dtx):
    return np.where(adj, dtx, NEG).astype(np.float32)


def _t(*arrays):
    return [torch.from_numpy(np.ascontiguousarray(a)) for a in arrays]


def _nan_equal(got, want) -> bool:
    """Equal values, NaN at the same places (torch.equal with NaN equal)."""
    return (got.shape == want.shape
            and torch.equal(got.isnan(), want.isnan())
            and torch.equal(torch.where(got.isnan(), 0.0, got),
                            torch.where(want.isnan(), 0.0, want)))


@pytest.fixture(scope="module")
def jax_side():
    """(repro.kernels.ref, repro.core.diffusive, Pallas dense, Pallas
    sparse, jax.numpy)."""
    jnp = pytest.importorskip("jax.numpy")
    from repro.core import diffusive as jdiff
    from repro.kernels import ref as jref
    from repro.kernels.diffusive_phi import diffusive_phi, \
        diffusive_phi_sparse
    return jref, jdiff, diffusive_phi, diffusive_phi_sparse, jnp


def _per_run(fn, *arrays):
    """A JAX function of [N]-shaped operands over the run axis."""
    return np.stack([np.asarray(fn(*(a[r] for a in arrays)))
                     for r in range(arrays[0].shape[0])])


def _quiet(fn, *args, **kw):
    with np.errstate(divide="ignore", invalid="ignore"):
        return np.asarray(fn(*args, **kw))


# ---------------------------------------------------------------------------
# on the CPU: the plain versions against the live reference
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("R,N", [(3, 30), (4, 37), (3, 64), (3, 200)])
def test_dense_plain_propagates_nan_as_reference_and_pallas(jax_side, R, N):
    jref, _, pl_phi, _, jnp = jax_side
    phi, F, adj, dtx = _specials(R, N)
    inv, dm = _inv(phi), _masked(adj, dtx)
    got = ref.diffusive_phi(*_t(inv, F, dm)).numpy()
    assert np.isnan(got).any() and np.isinf(got).any()
    np.testing.assert_array_equal(got, _quiet(jref.diffusive_phi, inv, F, dm))
    np.testing.assert_array_equal(got, _quiet(
        pl_phi, jnp.asarray(inv), jnp.asarray(F), jnp.asarray(dm),
        interpret=True))


@pytest.mark.parametrize("R,N,K", [(3, 30, None), (3, 64, 16), (4, 37, 5),
                                   (3, 40, 1), (3, 50, 40), (3, 40, 130)])
def test_sparse_plain_propagates_nan_as_reference_and_pallas(jax_side, R, N,
                                                             K):
    jref, _, _, pl_sparse, jnp = jax_side
    phi, F, adj, dtx = _specials(R, N)
    on, nbr, d_e = _lists(adj, dtx, K)
    inv, dm = _inv(phi), _masked(on, d_e)
    got = ref.diffusive_phi_sparse(*_t(inv, F, dm, nbr)).numpy()
    # (a NaN delay is no link here: with K = 1 it leaves no NaN candidate)
    assert np.isnan(got).any() or K == 1
    np.testing.assert_array_equal(got, _quiet(jref.diffusive_phi_sparse, inv,
                                              F, dm, nbr))
    pallas = _quiet(pl_sparse, jnp.asarray(inv), jnp.asarray(F),
                    jnp.asarray(dm), jnp.asarray(nbr), interpret=True)
    # The Pallas kernel starts its running max at NEG (and pads K with NEG
    # slots), where jnp.max starts at -inf: a row whose every candidate
    # lies below NEG (a single link to the node with φ = -0, so 1/φ =
    # -inf) differs between the reference's kernel and its own oracle.
    # The port follows the oracle there; everywhere else all three agree.
    R = inv.shape[0]
    gathered = np.take_along_axis(inv, nbr.reshape(R, -1), 1)
    with np.errstate(invalid="ignore"):
        below = (dm + gathered.reshape(dm.shape)).max(-1) < np.float32(NEG)
    np.testing.assert_array_equal(got[~below], pallas[~below])
    assert not below.any() or K == 1   # only a single-slot row gets there


@pytest.mark.parametrize("R,N", [(3, 30), (4, 37), (3, 64), (3, 200)])
def test_phi_update_plain_propagates_nan_as_reference(jax_side, R, N):
    _, jdiff, _, _, _ = jax_side
    phi, F, adj, dtx = _specials(R, N)
    args = _t(phi, F, adj, dtx)
    got = ref.phi_update(*args)
    np.testing.assert_array_equal(got.numpy(), _per_run(
        lambda *a: _quiet(jdiff.phi_update, *a), phi, F, adj, dtx))
    assert torch.isnan(got).any() and (got == 0).any()
    # NaN delays off-link only: masked away, the rows stay finite
    assert torch.isfinite(got[1, 5:9]).all()
    assert torch.equal(ops.phi_update(*args).isnan(), got.isnan())
    assert _nan_equal(tdiff.phi_update_op(*args), got)


@pytest.mark.parametrize("R,N,K", [(3, 30, None), (3, 64, None),
                                   (3, 64, 16), (4, 37, 5), (3, 40, 1),
                                   (3, 50, 40), (3, 40, 130)])
def test_phi_update_sparse_plain_propagates_nan_as_reference(jax_side, R, N,
                                                             K):
    _, jdiff, _, _, _ = jax_side
    phi, F, adj, dtx = _specials(R, N)
    on, nbr, d_e = _lists(adj, dtx, K)
    args = _t(phi, F, on, nbr, d_e)
    got = tdiff.phi_update_sparse(*args)
    np.testing.assert_array_equal(got.numpy(), _per_run(
        lambda *a: _quiet(jdiff.phi_update_sparse, *a), phi, F, on, nbr,
        d_e))
    assert torch.isnan(got).any()
    before = dict(kbuild.LAUNCHES)
    assert _nan_equal(ops.phi_update_sparse(*args), got)
    assert _nan_equal(tdiff.phi_update_op_sparse(*args), got)
    with ops.reference():
        assert _nan_equal(ops.phi_update_sparse(*args), got)
    assert kbuild.LAUNCHES == before
    if K is None:   # covering lists: the dense update's bits, NaN for NaN
        assert _nan_equal(got, ref.phi_update(*_t(phi, F, adj, dtx)))
        assert torch.isfinite(got[1, 5:9]).all()


@pytest.mark.parametrize("R,N,K", [(1, 12, 4), (2, 30, 16), (3, 40, 130)])
def test_phi_update_op_sparse_matches_reference_op(jax_side, R, N, K):
    """The kernel-dispatched sparse op (one launch on the card) against the
    reference's ``phi_update_op_sparse`` (its op chain), exactly, batched
    and unbatched: finite delays, and where R > 1 the NaN delay that
    ``_lists`` puts on row 5 of run 1, which both propagate."""
    _, jdiff, _, _, _ = jax_side
    g = np.random.default_rng(R * N * K)
    F = g.uniform(100, 500, (R, N)).astype(np.float32)
    phi = g.uniform(50, 800, (R, N)).astype(np.float32)
    adj = (g.uniform(size=(R, N, N)) < 0.3) & ~np.eye(N, dtype=bool)
    dtx = g.uniform(1e-4, 1e-2, (R, N, N)).astype(np.float32)
    on, nbr, d_e = _lists(adj, dtx, K)
    want = np.asarray(jdiff.phi_update_op_sparse(phi, F, on, nbr, d_e))
    got = tdiff.phi_update_op_sparse(*_t(phi, F, on, nbr, d_e)).numpy()
    np.testing.assert_array_equal(got, want)
    one = tdiff.phi_update_op_sparse(*_t(phi[0], F[0], on[0], nbr[0],
                                         d_e[0])).numpy()
    np.testing.assert_array_equal(one, got[0])


def test_phi_update_sparse_wrapper_refuses_cpu_tensors():
    phi, F, adj, dtx = _specials(1, 8)
    with pytest.raises(ValueError, match="CUDA"):
        cuda_phi.phi_update_sparse(*_t(phi, F, *_lists(adj, dtx, 4)))
    assert "phi_update_sparse" in kbuild.LAUNCHES


# ---------------------------------------------------------------------------
# on the card
# ---------------------------------------------------------------------------


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    return torch.device("cuda")


def _card(*arrays):
    return [t.cuda() for t in _t(*arrays)]


@pytest.mark.cuda
@pytest.mark.parametrize("R,N", [(3, 30), (4, 37), (3, 200), (3, 1024)])
def test_dense_launchers_propagate_nan_on_card(cuda, R, N):
    phi, F, adj, dtx = _specials(R, N)
    contract = _card(_inv(phi), F, _masked(adj, dtx))
    assert _nan_equal(cuda_phi.diffusive_phi(*contract),
                      ref.diffusive_phi(*contract))
    args = _card(phi, F, adj, dtx)
    got = cuda_phi.phi_update(*args)
    assert torch.isnan(got).any()
    assert _nan_equal(got, ref.phi_update(*args))


@pytest.mark.cuda
@pytest.mark.parametrize("R,N,K", [(3, 30, None), (3, 64, 16), (4, 37, 5),
                                   (3, 40, 1), (3, 50, 40), (3, 40, 130),
                                   (3, 1000, 16)])
def test_sparse_launchers_propagate_nan_on_card(cuda, R, N, K):
    phi, F, adj, dtx = _specials(R, N)
    on, nbr, d_e = _lists(adj, dtx, K)
    contract = _card(_inv(phi), F, _masked(on, d_e), nbr)
    assert _nan_equal(cuda_phi.diffusive_phi_sparse(*contract),
                      ref.diffusive_phi_sparse(*contract))
    args = _card(phi, F, on, nbr, d_e)
    kbuild.reset_launches()
    got = cuda_phi.phi_update_sparse(*args)
    assert kbuild.LAUNCHES["phi_update_sparse"] == 1
    assert torch.isnan(got).any()
    assert _nan_equal(got, ref.phi_update_sparse(*args))


def _sim_lists(R, N, K, seed=0):
    """Lists as the simulator hands them over: ids ascending, invalid
    slots last and 0, 60 % valid, finite delays."""
    g = np.random.default_rng(seed + N + K)
    phi = g.uniform(50, 800, (R, N)).astype(np.float32)
    F = g.uniform(100, 500, (R, N)).astype(np.float32)
    nbr = np.sort(g.integers(0, N, (R, N, K)), axis=-1).astype(np.int32)
    on = g.uniform(size=(R, N, K)) < 0.6
    on[:, 0] = False                      # a node without neighbours
    d_e = g.uniform(1e-4, 1e-2, (R, N, K)).astype(np.float32)
    return phi, F, on, np.where(on, nbr, 0).astype(np.int32), d_e


@pytest.mark.cuda
@pytest.mark.parametrize("R,N,K", [(4, 4096, 16), (50, 30, 16), (2, 1000, 40),
                                   (1, 40, 130), (1, 100, 1), (2, 300, 7),
                                   (1, 65536, 16)])
def test_phi_update_sparse_equals_plain_on_card(cuda, R, N, K):
    args = _card(*_sim_lists(R, N, K))
    kbuild.reset_launches()
    got = tdiff.phi_update_op_sparse(*args)
    assert kbuild.LAUNCHES["phi_update_sparse"] == 1
    assert kbuild.LAUNCHES["diffusive_phi_sparse"] == 0
    want = ref.phi_update_sparse(*args)
    assert torch.equal(got, want)
    assert torch.equal(got[:, 0], args[1][:, 0])          # no neighbour: F
    with ops.reference():
        assert torch.equal(tdiff.phi_update_op_sparse(*args), want)
    one = tdiff.phi_update_op_sparse(*(a[0] for a in args))
    assert torch.equal(one, got[0])


@pytest.mark.cuda
@pytest.mark.parametrize("R,N", [(3, 50), (2, 200)])
def test_phi_update_sparse_equals_dense_on_covering_lists(cuda, R, N):
    phi, F, adj, dtx = _specials(R, N, seed=9)
    on, nbr, d_e = _lists(adj, dtx)
    dense = cuda_phi.phi_update(*_card(phi, F, adj, dtx))
    assert _nan_equal(cuda_phi.phi_update_sparse(*_card(phi, F, on, nbr,
                                                        d_e)), dense)


@pytest.mark.cuda
def test_phi_update_sparse_bad_index_makes_the_row_nan(cuda):
    """An on-link index outside [0, N) is not read: the row comes out NaN;
    the same index on an off-link slot is never looked at."""
    phi, F, on, nbr, d_e = _card(*_sim_lists(2, 64, 16))
    row = int(on[1].any(dim=-1).nonzero()[1])
    k = int(on[1, row].nonzero()[0])
    bad = nbr.clone()
    bad[1, row, k] = 64
    off = (~on[0, 3]).nonzero()
    if len(off):
        bad[0, 3, int(off[0])] = -5
    got = cuda_phi.phi_update_sparse(phi, F, on, bad, d_e)
    want = ref.phi_update_sparse(phi, F, on, nbr, d_e)
    assert torch.isnan(got[1, row])
    keep = torch.ones_like(got, dtype=torch.bool)
    keep[1, row] = False
    assert torch.equal(got[keep], want[keep])
