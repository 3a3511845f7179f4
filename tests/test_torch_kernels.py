"""The φ kernels of the port (Eq. 10, dense and sparse).

* On the CPU: the plain PyTorch versions (``repro_torch.kernels.ref``) are
  held against the JAX package's oracles (``repro.kernels.ref``) and its
  Pallas kernels in interpret mode, at the shapes of tests/test_kernels.py
  and tests/test_sparse.py, at rtol 1e-5 / atol 1e-7 as test_kernels.py
  holds the Pallas kernel.  (They come out bit-identical.)
* On the card (marker ``cuda``, skipped without one): the CUDA kernels
  must be ``torch.equal`` to the plain versions, and sparse equal to dense
  where the lists cover every neighbour.  The JAX package is imported only
  by the CPU tests that compare with it, so ``pytest -m cuda`` runs on a
  machine without jax.
"""
import numpy as np
import pytest

torch = pytest.importorskip("torch")

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


def test_cuda_wrappers_refuse_cpu_tensors():
    inv_phi, F, dtx = _t(*_dense(1, 8))
    with pytest.raises(ValueError, match="CUDA"):
        cuda_phi.diffusive_phi(inv_phi, F, dtx)
    inv_phi, F, dtx, nbr = _t(*_sparse(1, 8, 4))
    with pytest.raises(ValueError, match="CUDA"):
        cuda_phi.diffusive_phi_sparse(inv_phi, F, dtx, nbr)


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
