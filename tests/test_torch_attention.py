"""The attention kernels of the port (flash and decode) and the model's
attention paths.

* On the CPU: the plain versions (``repro_torch.kernels.ref``) against the
  JAX package's oracles (``repro.kernels.ref``) and its Pallas kernels run
  with ``interpret=True``, at every shape of tests/test_kernels.py and at
  its tolerances: 3e-5 in float32, 2e-2 in bfloat16 (the bf16 score
  product rounds where the Pallas kernel keeps f32).  The model's
  ``chunked_attention`` and ``decode_attention_ref`` against the JAX
  package's, with G = Hq/Hkv > 1 and more than one q chunk, at rtol/atol
  1e-5 in f32 (one summation order apart) and 2e-2 in bf16.
* On the card (marker ``cuda``, skipped without one): the CUDA kernels
  against the plain versions at the same tolerances, at the test shapes,
  the serving path's shapes and lengths that are not multiples of 128.
"""
import math

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro_torch.kernels import build as kbuild  # noqa: E402
from repro_torch.kernels import decode_attention as cuda_decode  # noqa: E402
from repro_torch.kernels import flash_attention as cuda_flash  # noqa: E402
from repro_torch.kernels import ops, ref  # noqa: E402
from repro_torch.models import attention as tattn  # noqa: E402

torch.set_num_threads(1)

FLASH_SHAPES = [  # B, S, Hq, Hkv, hd, causal, window, dtype (test_kernels.py)
    (2, 128, 4, 2, 64, True, 0, "float32"),
    (1, 256, 8, 1, 128, True, 0, "bfloat16"),
    (2, 128, 4, 4, 64, False, 0, "float32"),
    (1, 256, 4, 2, 64, True, 64, "float32"),
    (1, 128, 2, 2, 256, True, 0, "bfloat16"),
]
DECODE_SHAPES = [  # B, S, Hq, Hkv, hd, pos, window, dtype (test_kernels.py)
    (2, 256, 8, 2, 64, 100, 0, "float32"),
    (1, 512, 4, 1, 128, 511, 0, "bfloat16"),
    (2, 256, 4, 4, 64, 200, 64, "float32"),
]


def tol(dtype: str) -> dict:
    return dict(rtol=2e-2, atol=2e-2) if dtype == "bfloat16" \
        else dict(rtol=3e-5, atol=3e-5)


def _normal(shape, dtype, seed, device="cpu"):
    """Seeded standard normal in ``dtype``; returns (torch tensor, the same
    values as float32 numpy)."""
    x = np.random.default_rng(seed).standard_normal(shape).astype(np.float32)
    t = torch.from_numpy(x).to(getattr(torch, dtype)).to(device)
    return t, t.float().cpu().numpy()


def _qkv(q_shape, kv_shape, dtype, seed=0, device="cpu"):
    return [_normal(s, dtype, seed + i, device)
            for i, s in enumerate((q_shape, kv_shape, kv_shape))]


def _f32(x) -> np.ndarray:
    if torch.is_tensor(x):
        return x.float().cpu().numpy()
    return np.asarray(x, np.float32)


@pytest.fixture(scope="module")
def jax_side():
    """(jax.numpy, repro.kernels.ref, Pallas flash, Pallas decode,
    repro.models.attention)."""
    jnp = pytest.importorskip("jax.numpy")
    from repro.kernels import ref as jref
    from repro.kernels.decode_attention import decode_attention
    from repro.kernels.flash_attention import flash_attention
    from repro.models import attention as jattn
    return jnp, jref, flash_attention, decode_attention, jattn


def _jx(jnp, x32, dtype):
    return jnp.asarray(x32).astype(getattr(jnp, dtype))


# ---------------------------------------------------------------------------
# plain versions against the JAX package (CPU)
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("B,S,Hq,Hkv,hd,causal,win,dt", FLASH_SHAPES)
def test_flash_plain_matches_reference_and_pallas(jax_side, B, S, Hq, Hkv,
                                                  hd, causal, win, dt):
    jnp, jref, pl_flash, _, _ = jax_side
    (q, q32), (k, k32), (v, v32) = _qkv((B, S, Hq, hd), (B, S, Hkv, hd), dt)
    got = _f32(ref.flash_attention(q, k, v, causal=causal, window=win))
    jq, jk, jv = (_jx(jnp, a, dt) for a in (q32, k32, v32))
    want = _f32(jref.flash_attention(jq, jk, jv, causal=causal, window=win))
    pallas = _f32(pl_flash(jq, jk, jv, causal=causal, window=win, bq=64,
                           bk=64, interpret=True))
    np.testing.assert_allclose(got, want, **tol(dt))
    np.testing.assert_allclose(got, pallas, **tol(dt))


@pytest.mark.parametrize("B,S,Hq,Hkv,hd,pos,win,dt", DECODE_SHAPES)
def test_decode_plain_matches_reference_and_pallas(jax_side, B, S, Hq, Hkv,
                                                   hd, pos, win, dt):
    jnp, jref, _, pl_decode, _ = jax_side
    (q, q32), (k, k32), (v, v32) = _qkv((B, Hq, hd), (B, S, Hkv, hd), dt)
    got = _f32(ref.decode_attention(q, k, v, pos, window=win))
    jq, jk, jv = (_jx(jnp, a, dt) for a in (q32, k32, v32))
    want = _f32(jref.decode_attention(jq, jk, jv, pos, window=win))
    pallas = _f32(pl_decode(jq, jk, jv, jnp.int32(pos), window=win, bk=128,
                            interpret=True))
    np.testing.assert_allclose(got, want, **tol(dt))
    np.testing.assert_allclose(got, pallas, **tol(dt))


MODEL_TOL = {"float32": dict(rtol=1e-5, atol=1e-5),
             "bfloat16": dict(rtol=2e-2, atol=2e-2)}


@pytest.mark.parametrize("B,S,Hq,Hkv,hd,chunk,window,dt", [
    (2, 64, 4, 2, 16, 32, 0, "float32"),      # G = 2, two chunks
    (1, 96, 8, 2, 32, 32, 0, "bfloat16"),     # G = 4, three chunks
    (2, 48, 4, 4, 16, 1024, 0, "float32"),    # one chunk
    (1, 64, 4, 1, 16, 16, 24, "float32"),     # window, G = 4
])
def test_chunked_attention_matches_jax(jax_side, B, S, Hq, Hkv, hd, chunk,
                                       window, dt):
    jnp, _, _, _, jattn = jax_side
    (q, q32), (k, k32), (v, v32) = _qkv((B, S, Hq, hd), (B, S, Hkv, hd), dt,
                                        seed=3)
    pos = np.broadcast_to(np.arange(S, dtype=np.int32), (B, S))
    got = tattn.chunked_attention(
        q, k, v, q_positions=torch.from_numpy(pos.copy()),
        k_positions=torch.from_numpy(pos.copy()), window=window,
        chunk=chunk)
    jq, jk, jv = (_jx(jnp, a, dt) for a in (q32, k32, v32))
    want = jattn.chunked_attention(
        jq, jk, jv, q_positions=jnp.asarray(pos), k_positions=jnp.asarray(pos),
        window=window, chunk=chunk)
    assert got.dtype == getattr(torch, dt)
    np.testing.assert_allclose(_f32(got), _f32(want), **MODEL_TOL[dt])


@pytest.mark.parametrize("B,S,Hq,Hkv,hd,pos,window,dt", [
    (2, 32, 4, 2, 16, 17, 0, "float32"),
    (1, 64, 8, 2, 32, 63, 0, "bfloat16"),
    (2, 32, 4, 1, 16, 20, 8, "float32"),
])
def test_decode_attention_ref_matches_jax(jax_side, B, S, Hq, Hkv, hd, pos,
                                          window, dt):
    jnp, _, _, _, jattn = jax_side
    (q, q32), (k, k32), (v, v32) = _qkv((B, 1, Hq, hd), (B, S, Hkv, hd), dt,
                                        seed=5)
    kpos = np.broadcast_to(np.arange(S, dtype=np.int32), (B, S)).copy()
    qpos = np.full((B,), pos, np.int32)
    got = tattn.decode_attention_ref(
        q, k, v, q_position=torch.from_numpy(qpos),
        k_positions=torch.from_numpy(kpos), window=window)
    as_int = tattn.decode_attention_ref(
        q, k, v, q_position=pos, k_positions=torch.from_numpy(kpos),
        window=window)
    jq, jk, jv = (_jx(jnp, a, dt) for a in (q32, k32, v32))
    want = jattn.decode_attention_ref(
        jq, jk, jv, q_position=jnp.asarray(qpos),
        k_positions=jnp.asarray(kpos), window=window)
    assert torch.equal(got, as_int)
    np.testing.assert_allclose(_f32(got), _f32(want), **MODEL_TOL[dt])


# ---------------------------------------------------------------------------
# dispatch and wrappers (CPU)
# ---------------------------------------------------------------------------


def test_cpu_tensors_take_the_plain_versions():
    (q, _), (k, _), (v, _) = _qkv((1, 64, 4, 64), (1, 64, 2, 64), "float32")
    before = dict(kbuild.LAUNCHES)
    assert not ops.takes_kernel(q)
    assert torch.equal(ops.flash_attention(q, k, v),
                       ref.flash_attention(q, k, v))
    assert torch.equal(ops.decode_attention(q[:, 0], k, v, 10),
                       ref.decode_attention(q[:, 0], k, v, 10))
    with ops.reference():
        assert not ops.takes_kernel(q)
    assert kbuild.LAUNCHES == before
    assert {"flash_attention", "decode_attention", "diffusive_phi",
            "diffusive_phi_sparse"} <= set(kbuild.LAUNCHES)


def test_cuda_wrappers_refuse_cpu_tensors():
    (q, _), (k, _), (v, _) = _qkv((1, 64, 4, 64), (1, 64, 2, 64), "float32")
    with pytest.raises(ValueError, match="CUDA"):
        cuda_flash.flash_attention(q, k, v)
    with pytest.raises(ValueError, match="CUDA"):
        cuda_decode.decode_attention(q[:, 0], k, v, 3)


def test_libraries_are_one_per_source():
    paths = {cuda_flash.LIB.path(), cuda_decode.LIB.path()}
    assert len(paths) == 2
    for p in paths:
        assert p.parent == kbuild.BUILD_DIR and p.suffix == ".so"
    assert cuda_flash.LIB.source.name == "flash_attention.cu"
    assert cuda_decode.LIB.source.name == "decode_attention.cu"


# ---------------------------------------------------------------------------
# on the card
# ---------------------------------------------------------------------------


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    torch.backends.cuda.matmul.allow_tf32 = False
    return torch.device("cuda")


CARD_FLASH = FLASH_SHAPES + [
    (4, 512, 16, 8, 128, True, 0, "bfloat16"),    # the serving path
    (4, 200, 16, 8, 128, True, 0, "bfloat16"),    # ragged lengths
    (2, 1000, 16, 8, 128, True, 0, "bfloat16"),
    (1, 200, 4, 2, 64, True, 48, "float32"),
    (2, 77, 4, 1, 256, False, 0, "float32"),
    (2, 64, 4, 2, 16, True, 0, "bfloat16"),       # reduced() head_dim
    (2, 96, 4, 2, 32, True, 0, "float32"),
]


@pytest.mark.cuda
@pytest.mark.parametrize("B,S,Hq,Hkv,hd,causal,win,dt", CARD_FLASH)
def test_flash_kernel_matches_plain_on_card(cuda, B, S, Hq, Hkv, hd, causal,
                                            win, dt):
    (q, _), (k, _), (v, _) = _qkv((B, S, Hq, hd), (B, S, Hkv, hd), dt,
                                  device=cuda)
    got = cuda_flash.flash_attention(q, k, v, causal=causal, window=win)
    want = ref.flash_attention(q, k, v, causal=causal, window=win)
    torch.cuda.synchronize()
    assert got.dtype == q.dtype and got.shape == q.shape
    np.testing.assert_allclose(_f32(got), _f32(want), **tol(dt))


CARD_DECODE = DECODE_SHAPES + [
    (4, 1024, 16, 8, 128, p, 0, "bfloat16") for p in (0, 511, 575, 1023)
] + [(2, 300, 12, 4, 128, 299, 0, "float32"),
     (1, 100, 16, 1, 64, 2000, 0, "float32"),
     (2, 64, 4, 2, 16, 40, 0, "bfloat16"),
     (2, 64, 4, 2, 32, 63, 0, "float32")]


@pytest.mark.cuda
@pytest.mark.parametrize("B,S,Hq,Hkv,hd,pos,win,dt", CARD_DECODE)
def test_decode_kernel_matches_plain_on_card(cuda, B, S, Hq, Hkv, hd, pos,
                                             win, dt):
    (q, _), (k, _), (v, _) = _qkv((B, Hq, hd), (B, S, Hkv, hd), dt,
                                  device=cuda)
    got = cuda_decode.decode_attention(q, k, v, pos, window=win)
    want = ref.decode_attention(q, k, v, pos, window=win)
    torch.cuda.synchronize()
    np.testing.assert_allclose(_f32(got), _f32(want), **tol(dt))


@pytest.mark.cuda
def test_model_paths_launch_the_kernels_at_ragged_lengths(cuda):
    B, S, Hq, Hkv, hd = 2, 200, 8, 4, 64
    (q, _), (k, _), (v, _) = _qkv((B, S, Hq, hd), (B, S, Hkv, hd),
                                  "bfloat16", device=cuda)
    pos = torch.arange(S, dtype=torch.int32, device=cuda).expand(B, S)
    kbuild.reset_launches()
    got = tattn.chunked_attention(q, k, v, q_positions=pos, k_positions=pos,
                                  chunk=64)
    q1 = q[:, 5:6].contiguous()
    dec = tattn.decode_attention_ref(q1, k, v, q_position=5,
                                     k_positions=pos)
    assert kbuild.LAUNCHES["flash_attention"] == 1
    assert kbuild.LAUNCHES["decode_attention"] == 1
    with ops.reference():
        want = tattn.chunked_attention(q, k, v, q_positions=pos,
                                       k_positions=pos, chunk=64)
        dwant = tattn.decode_attention_ref(q1, k, v, q_position=5,
                                           k_positions=pos)
    assert kbuild.LAUNCHES["flash_attention"] == 1
    np.testing.assert_allclose(_f32(got), _f32(want), **tol("bfloat16"))
    np.testing.assert_allclose(_f32(dec), _f32(dwant), **tol("bfloat16"))
    assert math.isfinite(float(got.float().abs().max()))


@pytest.mark.cuda
def test_reduced_model_on_card_matches_cpu(cuda):
    """The reduced qwen3 (head_dim 16) on the card, through both kernels,
    against the same weights on the CPU (plain paths): prefill, then decode
    steps, at the bf16 tolerance of tests/test_models_smoke.py."""
    from repro_torch.configs import get_config, reduced
    from repro_torch.models import build_model
    cfg = reduced(get_config("qwen3-1.7b"))
    m = build_model(cfg)
    cpu = m.init(torch.Generator().manual_seed(0), device="cpu")
    card = m.init(torch.Generator(device=cuda).manual_seed(0), device=cuda)
    card.load_state_dict(cpu.state_dict())
    toks = torch.from_numpy(np.random.default_rng(0).integers(
        0, cfg.vocab_size, (2, 40)))
    kbuild.reset_launches()
    outs = {}
    for name, p, dev in (("cpu", cpu, "cpu"), ("card", card, cuda)):
        last, pc = m.prefill(p, {"tokens": toks.to(dev)})
        caches = m.init_cache(2, 48, device=dev)
        for k in ("k", "v"):
            caches[k][:, :, :40] = pc[k]
        steps = [last]
        for t in range(8):
            logits, caches = m.decode_step(p, caches, {
                "token": toks[:, t:t + 1].to(dev), "pos": 40 + t})
            steps.append(logits)
        outs[name] = torch.stack(steps, 1).float().cpu()
    assert kbuild.LAUNCHES["flash_attention"] == cfg.num_layers
    assert kbuild.LAUNCHES["decode_attention"] == 8 * cfg.num_layers
    np.testing.assert_allclose(outs["card"].numpy(), outs["cpu"].numpy(),
                               rtol=2e-2, atol=2e-2)


@pytest.mark.cuda
def test_serve_cli_runs_on_card(cuda, capsys):
    from repro_torch.launch import serve as tserve
    tserve.main(["--requests", "3", "--seq", "64", "--burst", "2"])
    assert "served 20 sequences" in capsys.readouterr().out
