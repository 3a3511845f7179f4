"""The port's RMSNorm, RG-LRU scan and Mamba scan kernels, and the model
layers around the two scans.

* On the CPU: the plain versions (``repro_torch.kernels.ref``) against the
  JAX package's oracles (``repro.kernels.ref``) and its Pallas kernels run
  with ``interpret=True``, at the shapes and tolerances of
  tests/test_kernels.py: 3e-5 (rglru, rmsnorm in f32), rtol 2e-4 / atol
  3e-5 (mamba), 2e-2 (rmsnorm in bf16).  The model-layer scans against the
  kernel oracles, as test_kernels.py holds the reference's
  (``test_model_ref_consistency_*``), and against the JAX package's own
  model functions at rtol 1e-5 / atol 1e-6 in f32 (the associative scan
  pairs elements as ``lax.associative_scan`` does; the rest is elementwise
  arithmetic whose exp, log1p and sigmoid differ in the last bits).
* On the card (marker ``cuda``, skipped without one): each CUDA kernel
  against its plain version at the same tolerances, at the test shapes,
  the main path's shapes and ragged ones; the scans' state updates round
  as the plain loop's do, so their h and h_last must be equal.
"""
import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro_torch.kernels import build as kbuild  # noqa: E402
from repro_torch.kernels import mamba_scan as cuda_mamba  # noqa: E402
from repro_torch.kernels import ops, ref  # noqa: E402
from repro_torch.kernels import rglru_scan as cuda_rglru  # noqa: E402
from repro_torch.kernels import rmsnorm as cuda_rmsnorm  # noqa: E402
from repro_torch.models import mamba as tmamba  # noqa: E402
from repro_torch.models import rglru as trglru  # noqa: E402

torch.set_num_threads(1)
SCAN_TOL = dict(rtol=3e-5, atol=3e-5)
MAMBA_TOL = dict(rtol=2e-4, atol=3e-5)
MODEL_TOL = dict(rtol=1e-5, atol=1e-6)
RGLRU_SHAPES = [(2, 128, 128, 64), (1, 512, 256, 128), (3, 64, 128, 64)]
MAMBA_SHAPES = [(2, 64, 128, 16, 32), (1, 128, 256, 8, 64)]
RMSNORM_SHAPES = [((4, 64, 256), "float32"), ((8, 128), "bfloat16"),
                  ((3, 7, 512), "float32")]


def norm_tol(dtype: str) -> dict:
    return dict(rtol=2e-2, atol=2e-2) if dtype == "bfloat16" else SCAN_TOL


def _scan_inputs(shape, seed=0, c_shape=None):
    """a ~ U[0.5, 0.999], b ~ N(0, 1) (x 0.1 with C), C ~ N(0, 1), float32
    numpy, as test_kernels.py draws them."""
    g = np.random.default_rng(seed)
    a = g.uniform(0.5, 0.999, shape).astype(np.float32)
    b = g.standard_normal(shape).astype(np.float32)
    if c_shape is None:
        return a, b
    return a, (b * 0.1).astype(np.float32), \
        g.standard_normal(c_shape).astype(np.float32)


def _norm_inputs(shape, dtype, seed=0):
    g = np.random.default_rng(seed)
    x = torch.from_numpy(g.standard_normal(shape).astype(np.float32)).to(
        getattr(torch, dtype))
    s = torch.from_numpy(g.standard_normal(shape[-1]).astype(np.float32))
    return x, s


def _t(*arrays):
    return [torch.from_numpy(np.ascontiguousarray(a)) for a in arrays]


def _f32(x) -> np.ndarray:
    if torch.is_tensor(x):
        return x.float().cpu().numpy()
    return np.asarray(x, np.float32)


@pytest.fixture(scope="module")
def jax_side():
    """(jax.numpy, repro.kernels.ref, Pallas rglru, mamba and rmsnorm,
    repro.models.rglru, repro.models.mamba)."""
    jnp = pytest.importorskip("jax.numpy")
    from repro.kernels import ref as jref
    from repro.kernels.mamba_scan import mamba_scan
    from repro.kernels.rglru_scan import rglru_scan
    from repro.kernels.rmsnorm import rmsnorm
    from repro.models import mamba as jmamba
    from repro.models import rglru as jrglru
    return jnp, jref, rglru_scan, mamba_scan, rmsnorm, jrglru, jmamba


# ---------------------------------------------------------------------------
# plain versions against the JAX package (CPU)
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("B,S,W,bs", RGLRU_SHAPES)
def test_rglru_plain_matches_reference_and_pallas(jax_side, B, S, W, bs):
    jnp, jref, pl_rglru, _, _, _, _ = jax_side
    a, b = _scan_inputs((B, S, W))
    got = ref.rglru_scan(*_t(a, b)).numpy()
    want = np.asarray(jref.rglru_scan(jnp.asarray(a), jnp.asarray(b)))
    pallas = np.asarray(pl_rglru(jnp.asarray(a), jnp.asarray(b), bw=128,
                                 bs=bs, interpret=True))
    np.testing.assert_allclose(got, want, **SCAN_TOL)
    np.testing.assert_allclose(got, pallas, **SCAN_TOL)


@pytest.mark.parametrize("B,S,D,N,bs", MAMBA_SHAPES)
def test_mamba_plain_matches_reference_and_pallas(jax_side, B, S, D, N, bs):
    jnp, jref, _, pl_mamba, _, _, jmamba = jax_side
    a, b, C = _scan_inputs((B, S, D, N), c_shape=(B, S, N))
    y, h_last = ref.mamba_scan_with_state(*_t(a, b, C))
    ja, jb, jC = jnp.asarray(a), jnp.asarray(b), jnp.asarray(C)
    want = np.asarray(jref.mamba_scan(ja, jb, jC))
    pallas = np.asarray(pl_mamba(ja, jb, jC, bd=128, bs=bs, interpret=True))
    np.testing.assert_allclose(y.numpy(), want, **MAMBA_TOL)
    np.testing.assert_allclose(y.numpy(), pallas, **MAMBA_TOL)
    _, jh = jmamba.selective_scan_ref(ja, jb, jC, chunk=S)
    np.testing.assert_allclose(h_last.numpy(), np.asarray(jh), **MAMBA_TOL)
    assert torch.equal(ref.mamba_scan(*_t(a, b, C)), y)


@pytest.mark.parametrize("shape,dt", RMSNORM_SHAPES)
def test_rmsnorm_plain_matches_reference_and_pallas(jax_side, shape, dt):
    jnp, jref, _, _, pl_rmsnorm, _, _ = jax_side
    x, s = _norm_inputs(shape, dt)
    got = ref.rmsnorm(x, s)
    jx = jnp.asarray(_f32(x)).astype(getattr(jnp, dt))
    js = jnp.asarray(s.numpy())
    want = _f32(jref.rmsnorm(jx, js))
    pallas = _f32(pl_rmsnorm(jx, js, interpret=True))
    assert got.dtype == x.dtype and got.shape == x.shape
    np.testing.assert_allclose(_f32(got), want, **norm_tol(dt))
    np.testing.assert_allclose(_f32(got), pallas, **norm_tol(dt))


# ---------------------------------------------------------------------------
# the model layers (CPU)
# ---------------------------------------------------------------------------


def test_model_ref_consistency_rglru():
    """The model-layer associative scan equals the kernel oracle
    (test_kernels.py::test_model_ref_consistency_rglru)."""
    a, b = _t(*_scan_inputs((2, 64, 32)))
    h_model, h_last = trglru.rglru_scan_ref(a, b)
    h_ref = ref.rglru_scan(a, b)
    np.testing.assert_allclose(h_model.numpy(), h_ref.numpy(), **SCAN_TOL)
    np.testing.assert_allclose(h_last.numpy(), h_ref[:, -1].numpy(),
                               **SCAN_TOL)


def test_model_ref_consistency_mamba():
    """The model-layer chunked scan equals the sequential oracle
    (test_kernels.py::test_model_ref_consistency_mamba)."""
    a, b, C = _t(*_scan_inputs((2, 64, 32, 8), c_shape=(2, 64, 8)))
    y_model, h_model = tmamba.selective_scan_ref(a, b, C, chunk=16)
    y_ref, h_ref = ref.mamba_scan_with_state(a, b, C)
    np.testing.assert_allclose(y_model.numpy(), y_ref.numpy(), **MAMBA_TOL)
    np.testing.assert_allclose(h_model.numpy(), h_ref.numpy(), **MAMBA_TOL)


@pytest.mark.parametrize("with_h0", [False, True])
def test_rglru_scan_ref_matches_jax(jax_side, with_h0):
    jnp, _, _, _, _, jrglru, _ = jax_side
    a, b = _scan_inputs((2, 37, 24), seed=1)
    h0 = np.random.default_rng(2).standard_normal((2, 24)).astype(
        np.float32) if with_h0 else None
    got, got_last = trglru.rglru_scan_ref(
        *_t(a, b), None if h0 is None else torch.from_numpy(h0))
    want, want_last = jrglru.rglru_scan_ref(
        jnp.asarray(a), jnp.asarray(b), None if h0 is None else
        jnp.asarray(h0))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **MODEL_TOL)
    np.testing.assert_allclose(got_last.numpy(), np.asarray(want_last),
                               **MODEL_TOL)


@pytest.mark.parametrize("S,chunk,with_h0", [(64, 16, False), (64, 16, True),
                                             (20, 8, True)])
def test_selective_scan_ref_matches_jax(jax_side, S, chunk, with_h0):
    """Several chunks with the carry, and the one-chunk fallback when S is
    not a multiple of the chunk."""
    jnp, _, _, _, _, _, jmamba = jax_side
    a, b, C = _scan_inputs((2, S, 16, 4), seed=3, c_shape=(2, S, 4))
    h0 = np.random.default_rng(4).standard_normal((2, 16, 4)).astype(
        np.float32) if with_h0 else None
    got = tmamba.selective_scan_ref(
        *_t(a, b, C), None if h0 is None else torch.from_numpy(h0),
        chunk=chunk)
    want = jmamba.selective_scan_ref(
        jnp.asarray(a), jnp.asarray(b), jnp.asarray(C),
        None if h0 is None else jnp.asarray(h0), chunk=chunk)
    for g, w in zip(got, want, strict=True):
        np.testing.assert_allclose(g.numpy(), np.asarray(w), **MODEL_TOL)


@pytest.mark.parametrize("dt,with_state", [("float32", False),
                                           ("float32", True),
                                           ("bfloat16", True)])
def test_causal_conv1d_matches_jax(jax_side, dt, with_state):
    """The cw shifted products summed in x's dtype in the reference's order:
    exact in bf16 as in f32."""
    jnp, _, _, _, _, jrglru, _ = jax_side
    g = np.random.default_rng(5)
    x = g.standard_normal((2, 9, 12)).astype(np.float32)
    w = g.standard_normal((4, 12)).astype(np.float32)
    bias = g.standard_normal(12).astype(np.float32)
    st = g.standard_normal((2, 3, 12)).astype(np.float32)
    tx = torch.from_numpy(x).to(getattr(torch, dt))
    tst = torch.from_numpy(st).to(getattr(torch, dt)) if with_state else None
    y, new = trglru.causal_conv1d(tx, *_t(w, bias), tst)
    jx = jnp.asarray(x).astype(getattr(jnp, dt))
    jst = jnp.asarray(st).astype(getattr(jnp, dt)) if with_state else None
    jy, jnew = jrglru.causal_conv1d(jx, jnp.asarray(w), jnp.asarray(bias),
                                    jst)
    assert y.dtype == tx.dtype
    np.testing.assert_array_equal(_f32(y), _f32(jy))
    np.testing.assert_array_equal(_f32(new), _f32(jnew))


@pytest.fixture(scope="module")
def block_params(jax_side):
    """Reduced recurrentgemma and falcon-mamba configs with one JAX init of
    a recurrent and of a mamba block, bridged as torch parameter dicts."""
    import jax

    from repro.configs import get_config as jget_config
    from repro.configs import reduced as jreduced
    from repro_torch.configs import get_config, reduced
    from repro_torch.models.common import param_dict
    jnp = jax_side[0]
    out = {}
    for arch, init in (("recurrentgemma-9b", jax_side[5].init_rec_block),
                       ("falcon-mamba-7b", jax_side[6].init_mamba_block)):
        jcfg = jreduced(jget_config(arch))
        jp = init(jax.random.PRNGKey(1), jcfg, jnp.float32)
        tp = param_dict(**{k: torch.from_numpy(np.array(v))
                           for k, v in jp.items()})
        out[arch] = (jcfg, jp, reduced(get_config(arch)), tp)
    return out


def test_rglru_coeffs_and_block_match_jax(jax_side, block_params):
    jnp, jrglru = jax_side[0], jax_side[5]
    jcfg, jp, tcfg, tp = block_params["recurrentgemma-9b"]
    x = np.random.default_rng(6).standard_normal((2, 12, 64)).astype(
        np.float32)
    a, b = trglru.rglru_coeffs(tp, torch.from_numpy(x), tcfg)
    ja, jb = jrglru.rglru_coeffs(jp, jnp.asarray(x), jcfg)
    np.testing.assert_allclose(a.numpy(), np.asarray(ja), **MODEL_TOL)
    np.testing.assert_allclose(b.numpy(), np.asarray(jb), **MODEL_TOL)
    got = trglru.apply_rec_block(tp, tcfg, torch.from_numpy(x),
                                 return_state=True)
    want = jrglru.apply_rec_block(jp, jcfg, jnp.asarray(x),
                                  return_state=True)
    for g, w in zip(got, want, strict=True):
        np.testing.assert_allclose(g.numpy(), np.asarray(w), rtol=1e-4,
                                   atol=1e-5)


@pytest.mark.parametrize("S", [16, 20])
def test_ssm_coeffs_and_fused_scan_match_jax(jax_side, block_params, S):
    """The fused chunked scan (two chunks of 8, and the one-chunk fallback
    at S = 20) and the coefficient expansion the kernel path uses."""
    jnp, jmamba = jax_side[0], jax_side[6]
    jcfg, jp, tcfg, tp = block_params["falcon-mamba-7b"]
    x = np.random.default_rng(7).standard_normal((2, S, 128)).astype(
        np.float32)
    for g, w in zip(tmamba.ssm_coeffs(tp, tcfg, torch.from_numpy(x)),
                    jmamba.ssm_coeffs(jp, jcfg, jnp.asarray(x)),
                    strict=True):
        np.testing.assert_allclose(g.numpy(), np.asarray(w), rtol=1e-4,
                                   atol=1e-6)
    got = tmamba.selective_scan_fused(tp, tcfg, torch.from_numpy(x))
    want = jmamba.selective_scan_fused(jp, jcfg, jnp.asarray(x))
    for g, w in zip(got, want, strict=True):
        np.testing.assert_allclose(g.numpy(), np.asarray(w), rtol=1e-4,
                                   atol=1e-5)
    u = np.random.default_rng(8).standard_normal((2, S, 64)).astype(
        np.float32)
    got = tmamba.apply_mamba_block(tp, tcfg, torch.from_numpy(u),
                                   return_state=True)
    want = jmamba.apply_mamba_block(jp, jcfg, jnp.asarray(u),
                                    return_state=True)
    for g, w in zip(got, want, strict=True):
        np.testing.assert_allclose(g.numpy(), np.asarray(w), rtol=1e-4,
                                   atol=1e-5)


# ---------------------------------------------------------------------------
# dispatch and wrappers (CPU)
# ---------------------------------------------------------------------------


def test_cpu_tensors_take_the_plain_versions():
    before = dict(kbuild.LAUNCHES)
    x, s = _norm_inputs((3, 7, 512), "bfloat16")
    assert torch.equal(ops.rmsnorm(x, s), ref.rmsnorm(x, s))
    a, b = _t(*_scan_inputs((2, 9, 8)))
    assert torch.equal(ops.rglru_scan(a, b), ref.rglru_scan(a, b))
    a, b, C = _t(*_scan_inputs((2, 9, 8, 4), c_shape=(2, 9, 4)))
    y, h = ops.mamba_scan_with_state(a, b, C)
    assert torch.equal(ops.mamba_scan(a, b, C), y)
    assert torch.equal(h, ref.mamba_scan_with_state(a, b, C)[1])
    assert kbuild.LAUNCHES == before
    assert {"rmsnorm", "rglru_scan", "mamba_scan"} <= set(kbuild.LAUNCHES)


def test_apply_norm_keeps_the_reference_arithmetic_on_cpu():
    """The models' rmsnorm now goes through ops.rmsnorm; on the CPU it is
    the reference's inline arithmetic, bit for bit."""
    from repro_torch.models.common import apply_norm, rms_head_norm
    x, s = _norm_inputs((2, 5, 64), "bfloat16", seed=9)
    xf = x.float()
    want = (xf * torch.rsqrt(xf.square().mean(-1, keepdim=True) + 1e-6)
            * s).to(x.dtype)
    assert torch.equal(apply_norm({"scale": s}, x), want)
    assert torch.equal(rms_head_norm(s, x), want)


def test_cuda_wrappers_refuse_cpu_tensors():
    x, s = _norm_inputs((2, 64), "float32")
    with pytest.raises(ValueError, match="CUDA"):
        cuda_rmsnorm.rmsnorm(x, s)
    a, b = _t(*_scan_inputs((1, 4, 8)))
    with pytest.raises(ValueError, match="CUDA"):
        cuda_rglru.rglru_scan(a, b)
    a, b, C = _t(*_scan_inputs((1, 4, 8, 4), c_shape=(1, 4, 4)))
    with pytest.raises(ValueError, match="CUDA"):
        cuda_mamba.mamba_scan_with_state(a, b, C)


# what the C launcher instantiates: (threads a row, chunks a thread)
ROWS_LAYOUTS = {(16, 1), (32, 1), (32, 2), (32, 4), (32, 8)}
BLOCK_CHUNKS = {2, 4, 8, 0}


@pytest.mark.parametrize("dt", ["float32", "bfloat16"])
@pytest.mark.parametrize("d", [1, 8, 64, 100, 128, 256, 512, 1000, 1024,
                               1025, 2048, 4096, 6000, 8192, 16384, 40000,
                               70000])
def test_rmsnorm_launch_plan_is_one_the_kernel_has(d, dt):
    dtype = getattr(torch, dt)
    threads, nv = cuda_rmsnorm.launch_plan(d, dtype)
    vec = 16 // torch.empty((), dtype=dtype).element_size()
    chunks = -(-d // vec)
    if d <= 1024:
        assert (threads, nv) in ROWS_LAYOUTS
        assert threads * nv >= chunks > threads * nv // 2 or nv == 1
    else:
        assert threads % 32 == 0 and 64 <= threads <= 1024
        assert nv in BLOCK_CHUNKS
        assert nv == 0 or threads * nv >= chunks
        if nv == 2:                # as few threads as hold two chunks each
            assert threads - 32 < -(-chunks // 2) <= threads
    # qwen3's qk-norm takes a half-warp a row; a 4096-wide bf16 row takes
    # 256 threads with two 16-byte chunks each
    if (d, dt) == (128, "bfloat16"):
        assert (threads, nv) == (16, 1)
    if (d, dt) == (4096, "bfloat16"):
        assert (threads, nv) == (256, 2)


def test_libraries_are_one_per_source():
    libs = (cuda_rmsnorm.LIB, cuda_rglru.LIB, cuda_mamba.LIB)
    assert len({lib.path() for lib in libs}) == 3
    for lib, name in zip(libs, ("rmsnorm.cu", "rglru_scan.cu",
                                "mamba_scan.cu"), strict=True):
        assert lib.source.name == name and lib.source.exists()
        assert lib.path().parent == kbuild.BUILD_DIR


# ---------------------------------------------------------------------------
# on the card
# ---------------------------------------------------------------------------


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    torch.backends.cuda.matmul.allow_tf32 = False
    return torch.device("cuda")


CARD_RMSNORM = RMSNORM_SHAPES + [
    ((2048, 4096), "bfloat16"),        # falcon-mamba / recurrentgemma prefill
    ((4, 1, 4096), "bfloat16"),        # their decode
    ((4, 512, 16, 128), "bfloat16"),   # qwen3 qk-norm at prefill
    ((4, 512, 2048), "bfloat16"),      # qwen3 layer norm at prefill
    ((5, 100), "float32"),             # d not a multiple of 32
    ((3, 1000), "bfloat16"),
    ((7, 4096), "float32"),
    ((2, 6000), "float32"),            # more than 8 elements a thread
    ((32768, 128), "bfloat16"),        # qwen3 qk-norm, flattened
    ((4, 4096), "bfloat16"),           # a recurrent decode step
    # every other layout the launcher has: a warp with 8 chunks a lane,
    # element-wise loads (d % 8 != 0 in bf16), 4 and 8 chunks a thread of
    # a 1024-thread block, and the streaming block past 8
    ((3, 1000), "float32"),
    ((5, 100), "bfloat16"),
    ((2, 20000), "bfloat16"),
    ((2, 50000), "bfloat16"),
    ((3, 70001), "float32"),
    ((2, 70000), "float32"),
]


@pytest.mark.cuda
@pytest.mark.parametrize("shape,dt", CARD_RMSNORM)
def test_rmsnorm_kernel_matches_plain_on_card(cuda, shape, dt):
    x, s = (t.to(cuda) for t in _norm_inputs(shape, dt))
    got = cuda_rmsnorm.rmsnorm(x, s)
    want = ref.rmsnorm(x, s)
    torch.cuda.synchronize()
    assert got.dtype == x.dtype and got.shape == x.shape
    np.testing.assert_allclose(_f32(got), _f32(want), **norm_tol(dt))


@pytest.mark.cuda
@pytest.mark.parametrize("d,dt", [(128, "bfloat16"), (2048, "bfloat16"),
                                  (4096, "bfloat16"), (4096, "float32"),
                                  (1000, "bfloat16"), (6000, "float32")])
def test_rmsnorm_row_has_the_same_bits_alone_and_in_2048_rows(cuda, d, dt):
    """The order of the sum depends on (d, dtype) alone: a row normalises
    to the same bits in a 2048-row prefill and a one-row decode step, and
    through the element-wise loads of a row that is not 16-byte aligned."""
    x, s = (t.to(cuda) for t in _norm_inputs((2048, d), dt, seed=5))
    many = cuda_rmsnorm.rmsnorm(x, s)
    for i in (0, 1, 1023, 2047):
        assert torch.equal(cuda_rmsnorm.rmsnorm(x[i:i + 1].clone(), s),
                           many[i:i + 1])
    buf = torch.empty(4 * d + 1, dtype=x.dtype, device=cuda)
    shifted = buf[1:].view(4, d)
    shifted.copy_(x[:4])
    assert torch.equal(cuda_rmsnorm.rmsnorm(shifted, s), many[:4])


CARD_RGLRU = [s[:3] for s in RGLRU_SHAPES] + [
    (4, 512, 4096),                    # recurrentgemma prefill
    (1, 512, 4096),                    # one sequence: 32-channel blocks
    (2, 37, 100),                      # ragged S and W
    (3, 37, 200),
    (2, 1000, 4100),
    (1, 1, 64),
    (2, 50, 36),                       # W below a block's 64 channels
    (1, 3, 4),
    (2, 37, 101)]                      # W % 4 != 0: the row-wise kernel


@pytest.mark.cuda
@pytest.mark.parametrize("B,S,W", CARD_RGLRU)
def test_rglru_kernel_matches_plain_on_card(cuda, B, S, W):
    a, b = (t.to(cuda) for t in _t(*_scan_inputs((B, S, W))))
    got = cuda_rglru.rglru_scan(a, b)
    want = ref.rglru_scan(a, b)
    torch.cuda.synchronize()
    np.testing.assert_allclose(_f32(got), _f32(want), **SCAN_TOL)
    assert torch.equal(got, want)


@pytest.mark.cuda
@pytest.mark.parametrize("B,S,W", [(4, 512, 4096), (3, 37, 200)])
def test_rglru_tma_and_rowwise_kernels_agree_on_card(cuda, B, S, W):
    """Operands that are not 16-byte aligned take the row-wise kernel: the
    same arithmetic, so the same bits as the TMA-fed one."""
    a, b = (t.to(cuda) for t in _t(*_scan_inputs((B, S, W), seed=3)))
    buf = torch.empty(2, a.numel() + 1, device=cuda)
    a1, b1 = (buf[i, 1:].view(a.shape) for i in range(2))
    a1.copy_(a)
    b1.copy_(b)
    got = cuda_rglru.rglru_scan(a, b)
    assert torch.equal(cuda_rglru.rglru_scan(a1, b1), got)
    assert torch.equal(got, ref.rglru_scan(a, b))


CARD_MAMBA = [s[:4] for s in MAMBA_SHAPES] + [
    (4, 512, 8192, 16),                # falcon-mamba prefill
    (2, 37, 100, 4),                   # ragged, reduced() state size
    (1, 20, 64, 12),
    (2, 1, 128, 16)]


@pytest.mark.cuda
@pytest.mark.parametrize("B,S,D,N", CARD_MAMBA)
def test_mamba_kernel_matches_plain_on_card(cuda, B, S, D, N):
    a, b, C = (t.to(cuda) for t in _t(*_scan_inputs(
        (B, S, D, N), c_shape=(B, S, N))))
    y, h = cuda_mamba.mamba_scan_with_state(a, b, C)
    want_y, want_h = ref.mamba_scan_with_state(a, b, C)
    torch.cuda.synchronize()
    np.testing.assert_allclose(_f32(y), _f32(want_y), **MAMBA_TOL)
    np.testing.assert_allclose(_f32(h), _f32(want_h), **MAMBA_TOL)
    assert torch.equal(h, want_h)
    assert torch.equal(ops.mamba_scan(a, b, C), y)


@pytest.mark.cuda
def test_kernel_wrappers_refuse_what_they_do_not_take(cuda):
    a, b, C = (t.to(cuda) for t in _t(*_scan_inputs(
        (1, 4, 8, 5), c_shape=(1, 4, 5))))
    with pytest.raises(ValueError, match="state size"):
        cuda_mamba.mamba_scan_with_state(a, b, C)
    a, b = (t.to(cuda) for t in _t(*_scan_inputs((1, 4, 8))))
    with pytest.raises(TypeError):
        cuda_rglru.rglru_scan(a.double(), b.double())
    with pytest.raises(ValueError, match="contiguous"):
        cuda_rglru.rglru_scan(a.transpose(1, 2), b.transpose(1, 2))
    x = torch.ones(4, 64, device=cuda)
    with pytest.raises(TypeError):
        cuda_rmsnorm.rmsnorm(x, torch.ones(64, device=cuda).double())


@pytest.mark.cuda
def test_model_scans_launch_the_kernels(cuda):
    """From a zero state the model layers launch the kernels, and under
    ops.reference() they run the reference's associative scans."""
    a, b = (t.to(cuda) for t in _t(*_scan_inputs((2, 64, 32))))
    a4, b4, C = (t.to(cuda) for t in _t(*_scan_inputs(
        (2, 64, 32, 8), c_shape=(2, 64, 8))))
    kbuild.reset_launches()
    h, h_last = trglru.rglru_scan_ref(a, b)
    y, hm = ops.mamba_scan_with_state(a4, b4, C)
    assert kbuild.LAUNCHES["rglru_scan"] == 1
    assert kbuild.LAUNCHES["mamba_scan"] == 1
    with ops.reference():
        h_plain, last_plain = trglru.rglru_scan_ref(a, b)
        y_plain, hm_plain = tmamba.selective_scan_ref(a4, b4, C, chunk=16)
    assert kbuild.LAUNCHES["rglru_scan"] == 1
    np.testing.assert_allclose(_f32(h), _f32(h_plain), **SCAN_TOL)
    np.testing.assert_allclose(_f32(h_last), _f32(last_plain), **SCAN_TOL)
    np.testing.assert_allclose(_f32(y), _f32(y_plain), **MAMBA_TOL)
    np.testing.assert_allclose(_f32(hm), _f32(hm_plain), **MAMBA_TOL)
