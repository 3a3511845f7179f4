"""The φ kernels of the port (Eq. 10, dense and sparse, and the fused
dense update ``phi_update``).

* On the CPU: the plain PyTorch versions (``repro_torch.kernels.ref``) are
  held against the JAX package's oracles (``repro.kernels.ref``) and its
  Pallas kernels in interpret mode, at the shapes of tests/test_kernels.py
  and tests/test_sparse.py, at rtol 1e-5 / atol 1e-7 as test_kernels.py
  holds the Pallas kernel.  (They come out bit-identical.)  The fused
  update's plain twin and its dispatch are held against the JAX package's
  ``phi_update_op`` at the same tolerance, and equal
  ``core.diffusive.phi_update`` and the seven-op chain it replaced exactly.
* On the card (marker ``cuda``, skipped without one): the CUDA kernels
  must be ``torch.equal`` to the plain versions, sparse equal to dense
  where the lists cover every neighbour, and the fused update equal to the
  seven-op chain.  The JAX package is imported only by the CPU tests
  that compare with it, so ``pytest -m cuda`` runs on a machine without
  jax.
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
TOL = dict(rtol=1e-5, atol=1e-7)


def _dense(R, N, seed=0, p=0.3, isolate=True):
    g = np.random.default_rng(seed)
    F = g.uniform(100, 500, (R, N)).astype(np.float32)
    phi = g.uniform(50, 800, (R, N)).astype(np.float32)
    adj = (g.uniform(size=(R, N, N)) < p) & ~np.eye(N, dtype=bool)
    if isolate:
        adj[:, 0, :] = False             # an isolated node: φ = F fallback
    dtx = np.where(adj, g.uniform(1e-4, 1e-2, (R, N, N)),
                   NEG).astype(np.float32)
    return (1.0 / phi).astype(np.float32), F, dtx


def _sparse(R, N, K, seed=0):
    g = np.random.default_rng(seed + 1000 * N + K)
    F = g.uniform(100, 500, (R, N)).astype(np.float32)
    nbr = g.integers(0, N, (R, N, K)).astype(np.int32)
    ok = g.uniform(size=(R, N, K)) < 0.6
    ok[:, 0, :] = False
    dtx = np.where(ok, g.uniform(1e-4, 1e-2, (R, N, K)),
                   NEG).astype(np.float32)
    return (1.0 / F).astype(np.float32), F, dtx, np.where(ok, nbr, 0)


def _update(R, N, seed=0, p=0.3):
    """(phi, F, adj, d_tx) as the simulator hands them to the update: node
    0 has no neighbour (φ = F), node 1 is nobody's neighbour; delays on
    every pair (off-link ones are ignored)."""
    g = np.random.default_rng(seed + 7 * N)
    F = g.uniform(100, 500, (R, N)).astype(np.float32)
    phi = g.uniform(50, 800, (R, N)).astype(np.float32)
    adj = (g.uniform(size=(R, N, N)) < p) & ~np.eye(N, dtype=bool)
    adj[:, 0, :] = False
    adj[:, :, 1 % N] = False
    dtx = g.uniform(1e-4, 1e-2, (R, N, N)).astype(np.float32)
    return phi, F, adj, dtx


def seven_op_chain(phi, F, adj, d_tx):
    """``core.diffusive.phi_update_op`` as it was before the fused kernel:
    1/φ, the masked delays, the Pallas-contract reduction, the degree, its
    compare, 1/x and the fallback: seven ops, 11 launches on the card."""
    inv_new = ops.diffusive_phi(1.0 / phi, F, torch.where(adj, d_tx, NEG))
    deg = adj.sum(dim=-1)
    return torch.where(deg > 0, 1.0 / inv_new, F)


def _t(*arrays):
    return [torch.from_numpy(a) for a in arrays]


@pytest.fixture(scope="module")
def jax_ref():
    """(repro.kernels.ref, Pallas dense, Pallas sparse, jax.numpy)."""
    jnp = pytest.importorskip("jax.numpy")
    from repro.kernels import ref as jref
    from repro.kernels.diffusive_phi import diffusive_phi, \
        diffusive_phi_sparse
    return jref, diffusive_phi, diffusive_phi_sparse, jnp


@pytest.mark.parametrize("R,N", [(1, 64), (2, 128), (2, 200), (4, 37)])
def test_dense_plain_matches_reference_and_pallas(jax_ref, R, N):
    jref, pl_phi, _, jnp = jax_ref
    inv_phi, F, dtx = _dense(R, N)
    got = ref.diffusive_phi(*_t(inv_phi, F, dtx)).numpy()
    want = np.asarray(jref.diffusive_phi(inv_phi, F, dtx))
    pallas = np.asarray(pl_phi(jnp.asarray(inv_phi), jnp.asarray(F),
                               jnp.asarray(dtx), interpret=True))
    np.testing.assert_allclose(got, want, **TOL)
    np.testing.assert_allclose(got, pallas, **TOL)
    np.testing.assert_array_equal(got[:, 0], 1.0 / F[:, 0])


@pytest.mark.parametrize("R,N,K", [(1, 64, 8), (2, 40, 37), (1, 100, 1),
                                   (1, 40, 130)])
def test_sparse_plain_matches_reference_and_pallas(jax_ref, R, N, K):
    jref, _, pl_phi_sparse, jnp = jax_ref
    inv_phi, F, dtx, nbr = _sparse(R, N, K)
    got = ref.diffusive_phi_sparse(*_t(inv_phi, F, dtx, nbr)).numpy()
    want = np.asarray(jref.diffusive_phi_sparse(inv_phi, F, dtx, nbr))
    pallas = np.asarray(pl_phi_sparse(
        jnp.asarray(inv_phi), jnp.asarray(F), jnp.asarray(dtx),
        jnp.asarray(nbr), interpret=True))
    np.testing.assert_allclose(got, want, **TOL)
    np.testing.assert_allclose(got, pallas, **TOL)
    np.testing.assert_array_equal(got[:, 0], 1.0 / F[:, 0])


def _dense_as_lists(dtx):
    """Neighbour lists covering every link of a dense [R, N, N] operand."""
    R, N, _ = dtx.shape
    nbr = np.broadcast_to(np.arange(N, dtype=np.int32), (R, N, N)).copy()
    on = dtx > NEG / 2
    return np.where(on, dtx, NEG).astype(np.float32), np.where(on, nbr, 0)


def test_sparse_equals_dense_when_lists_cover_degree():
    inv_phi, F, dtx = _dense(3, 50, seed=4)
    d_e, nbr = _dense_as_lists(dtx)
    dense = ref.diffusive_phi(*_t(inv_phi, F, dtx))
    sparse = ref.diffusive_phi_sparse(*_t(inv_phi, F, d_e, nbr))
    assert torch.equal(dense, sparse)


def test_ops_dispatch_cpu_to_plain_version():
    inv_phi, F, dtx = _t(*_dense(2, 37))
    before = dict(cuda_phi.LAUNCHES)
    assert torch.equal(ops.diffusive_phi(inv_phi, F, dtx),
                       ref.diffusive_phi(inv_phi, F, dtx))
    with ops.reference():
        assert torch.equal(ops.diffusive_phi(inv_phi, F, dtx),
                           ref.diffusive_phi(inv_phi, F, dtx))
    assert cuda_phi.LAUNCHES == before


@pytest.mark.parametrize("R,N", [(1, 64), (2, 128), (2, 200), (4, 37)])
def test_phi_update_plain_and_dispatch_match_reference(R, N):
    jdiff = pytest.importorskip("repro.core.diffusive")
    phi, F, adj, dtx = _update(R, N)
    want = np.asarray(jdiff.phi_update_op(phi, F, adj, dtx))
    args = _t(phi, F, adj, dtx)
    got = ref.phi_update(*args).numpy()
    np.testing.assert_allclose(got, want, **TOL)
    np.testing.assert_allclose(ops.phi_update(*args).numpy(), want, **TOL)
    np.testing.assert_array_equal(got[:, 0], F[:, 0])      # no neighbour
    # unbatched [N] operands, through the plain twin and the core op
    one = _t(phi[0], F[0], adj[0], dtx[0])
    want_one = np.asarray(jdiff.phi_update_op(phi[0], F[0], adj[0], dtx[0]))
    np.testing.assert_allclose(ref.phi_update(*one).numpy(), want_one, **TOL)
    np.testing.assert_allclose(tdiff.phi_update_op(*one).numpy(), want_one,
                               **TOL)
    np.testing.assert_array_equal(tdiff.phi_update_op(*one).numpy(), got[0])


@pytest.mark.parametrize("R,N", [(50, 30), (4, 37), (2, 200), (1, 1)])
def test_phi_update_on_cpu_equals_core_and_the_old_chain(R, N):
    args = _t(*_update(R, N, seed=3))
    before = dict(kbuild.LAUNCHES)
    got = ops.phi_update(*args)
    assert torch.equal(got, tdiff.phi_update(*args))
    assert torch.equal(got, tdiff.phi_update_op(*args))
    assert torch.equal(got, seven_op_chain(*args))
    with ops.reference():
        assert torch.equal(ops.phi_update(*args), got)
    assert kbuild.LAUNCHES == before


@pytest.mark.parametrize("R,N,sms", [(50, 30, 132), (8, 4096, 132),
                                     (4, 1024, 132), (1, 58112, 132),
                                     (3, 7, 1), (10_000, 30, 132)])
def test_update_chunk_sizes_the_grid(R, N, sms):
    chunk = cuda_phi.update_chunk(R, N, sms)
    assert chunk % 8 == 0 and 8 <= chunk <= 64
    blocks = R * -(-N // chunk)
    # about eight blocks an SM where there are rows enough
    assert blocks >= min(8 * sms, R * -(-N // 64)) or chunk == 8
    if (R, N) == (8, 4096):
        assert chunk == 32 and blocks == 1024


def test_cuda_wrappers_refuse_cpu_tensors():
    inv_phi, F, dtx = _t(*_dense(1, 8))
    with pytest.raises(ValueError, match="CUDA"):
        cuda_phi.diffusive_phi(inv_phi, F, dtx)
    inv_phi, F, dtx, nbr = _t(*_sparse(1, 8, 4))
    with pytest.raises(ValueError, match="CUDA"):
        cuda_phi.diffusive_phi_sparse(inv_phi, F, dtx, nbr)


def test_phi_update_wrapper_refuses_cpu_tensors():
    with pytest.raises(ValueError, match="CUDA"):
        cuda_phi.phi_update(*_t(*_update(1, 8)))
    assert "phi_update" in kbuild.LAUNCHES


def test_library_path_follows_the_source():
    path = cuda_phi.library_path()
    assert path.parent == cuda_phi.BUILD_DIR and path.suffix == ".so"
    assert "-use_fast_math" not in " ".join(cuda_phi.NVCC_FLAGS)
    assert "arch=compute_90a,code=sm_90a" in cuda_phi.NVCC_FLAGS


# ---------------------------------------------------------------------------
# on the card
# ---------------------------------------------------------------------------


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    return torch.device("cuda")


@pytest.mark.cuda
@pytest.mark.parametrize("R,N", [(50, 30), (4, 37), (2, 200), (4, 1024),
                                 (1, 4096)])
def test_dense_kernel_equals_plain_on_card(cuda, R, N):
    args = [t.to(cuda) for t in _t(*_dense(R, N))]
    assert torch.equal(cuda_phi.diffusive_phi(*args),
                       ref.diffusive_phi(*args))


@pytest.mark.cuda
@pytest.mark.parametrize("R,N,K", [(50, 30, 16), (2, 1000, 200),
                                   (1, 40, 130), (1, 100, 1)])
def test_sparse_kernel_equals_plain_on_card(cuda, R, N, K):
    args = [t.to(cuda) for t in _t(*_sparse(R, N, K))]
    assert torch.equal(cuda_phi.diffusive_phi_sparse(*args),
                       ref.diffusive_phi_sparse(*args))


@pytest.mark.cuda
def test_sparse_kernel_equals_dense_kernel_on_card(cuda):
    inv_phi, F, dtx = _dense(3, 50, seed=4)
    d_e, nbr = _dense_as_lists(dtx)
    a = cuda_phi.diffusive_phi(*[t.to(cuda) for t in _t(inv_phi, F, dtx)])
    b = cuda_phi.diffusive_phi_sparse(
        *[t.to(cuda) for t in _t(inv_phi, F, d_e, nbr)])
    assert torch.equal(a, b)


UPDATE_SHAPES = [(50, 30), (4, 37), (2, 200), (8, 4096), (4, 1024),
                 (3, 201)]


@pytest.mark.cuda
@pytest.mark.parametrize("R,N", UPDATE_SHAPES)
def test_fused_update_equals_plain_and_chain_on_card(cuda, R, N):
    args = [t.to(cuda) for t in _t(*_update(R, N))]
    kbuild.reset_launches()
    got = cuda_phi.phi_update(*args)
    assert kbuild.LAUNCHES["phi_update"] == 1
    assert torch.equal(got, ref.phi_update(*args))
    assert torch.equal(got, seven_op_chain(*args))     # the kernel chain
    with ops.reference():
        assert torch.equal(got, seven_op_chain(*args))
    assert torch.equal(got[:, 0], args[1][:, 0])        # no neighbour: F
    assert torch.equal(got, cuda_phi.phi_update(*args))


@pytest.mark.cuda
def test_phi_update_op_is_one_launch_on_card(cuda):
    """The simulator's op: one launch, [N] operands too, and a delay row
    that is not 16-byte aligned takes the element-wise loads, same bits."""
    phi, F, adj, dtx = (t.to(cuda) for t in _t(*_update(4, 64)))
    kbuild.reset_launches()
    got = tdiff.phi_update_op(phi, F, adj, dtx)
    one = tdiff.phi_update_op(phi[2], F[2], adj[2], dtx[2])
    assert kbuild.LAUNCHES["phi_update"] == 2
    assert kbuild.LAUNCHES["diffusive_phi"] == 0
    assert torch.equal(one, got[2])
    buf = torch.empty(dtx.numel() + 1, device=cuda)
    shifted = buf[1:].view(dtx.shape)
    shifted.copy_(dtx)
    assert torch.equal(cuda_phi.phi_update(phi, F, adj, shifted), got)
    wide = torch.ones(1, cuda_phi.MAX_UPDATE_N + 1, device=cuda)
    with pytest.raises(ValueError, match="sparse path"):
        cuda_phi.phi_update(wide, wide, adj, dtx)
