"""The distributed flash-decode's pieces: the decode kernel's partial entry
point (``kernels/decode_attention.py::decode_attention_partial``), its
plain twin (``ref.decode_attention_partial``) and the combine across ranks
(``combine_partials``).

* On the CPU: the plain partial over each of m ∈ {1, 2, 4, 8} contiguous
  slices of the cache, combined in rank order, against the port's
  whole-cache ``models.attention.decode_attention_ref`` and the JAX
  package's ``repro.models.attention.decode_attention_ref`` on the same
  numpy-seeded inputs, at rtol 1e-5 and atol 1e-6 (float32: the partials
  and their combine sum in another order than one softmax), with G = Hq /
  Hkv ∈ {1, 2, 6}, with a window, and at positions where some slices keep
  no slot (their m is -inf and l 0, never NaN).  The ring-buffer path's
  masked partial (``ref.decode_partial_masked``) against the one-process
  ring decode likewise.
* On the card (marker ``cuda``, skipped without one): the partial kernel
  against its plain twin at the tolerances of the whole-cache kernel
  (3e-5 in float32, 2e-2 in bfloat16), with slices that keep none.
"""
import math

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro_torch.kernels import decode_attention as DA  # noqa: E402
from repro_torch.kernels import ref  # noqa: E402
from repro_torch.models import attention as tattn  # noqa: E402

TOL = dict(rtol=1e-5, atol=1e-6)
# (B, S, Hq, Hkv, hd, pos, window)
CASES = [(2, 64, 4, 4, 16, 63, 0),      # G = 1, every slot
         (2, 64, 4, 2, 16, 20, 0),      # G = 2, the last slices keep none
         (1, 48, 12, 2, 32, 47, 0),     # G = 6
         (2, 64, 6, 1, 16, 40, 12),     # G = 6, a window: early slices none
         (1, 64, 4, 2, 16, 3, 0)]       # one slice keeps four slots


def _inputs(B, S, Hq, Hkv, hd, seed=0):
    rng = np.random.default_rng(seed)
    return [rng.standard_normal(s).astype(np.float32)
            for s in ((B, 1, Hq, hd), (B, S, Hkv, hd), (B, S, Hkv, hd))]


def _split(q, k, v, pos, window, m):
    """The plain partials of m contiguous slices, combined in rank
    order."""
    n = k.shape[1] // m
    parts = [ref.decode_attention_partial(
        q[:, 0], k[:, r * n:(r + 1) * n], v[:, r * n:(r + 1) * n],
        *DA.slice_range(pos, window, r * n, n)) for r in range(m)]
    return parts, DA.combine_partials(parts)


@pytest.mark.parametrize("m", [1, 2, 4, 8])
@pytest.mark.parametrize("B,S,Hq,Hkv,hd,pos,win", CASES)
def test_split_decode_matches_whole_cache(B, S, Hq, Hkv, hd, pos, win, m):
    jnp = pytest.importorskip("jax.numpy")
    from repro.models import attention as jattn
    q, k, v = _inputs(B, S, Hq, Hkv, hd)
    tq, tk, tv = map(torch.from_numpy, (q, k, v))
    parts, got = _split(tq, tk, tv, pos, win, m)
    kpos = np.broadcast_to(np.arange(S, dtype=np.int32), (B, S))
    whole = tattn.decode_attention_ref(
        tq, tk, tv, q_position=pos, k_positions=torch.from_numpy(
            kpos.copy()), window=win)[:, 0]
    want = np.asarray(jattn.decode_attention_ref(
        jnp.asarray(q), jnp.asarray(k), jnp.asarray(v),
        q_position=jnp.full((B,), pos, jnp.int32),
        k_positions=jnp.asarray(kpos), window=win,
        standard_layout=False))[:, 0]
    np.testing.assert_allclose(got.numpy(), whole.numpy(), **TOL)
    np.testing.assert_allclose(got.numpy(), want, **TOL)
    for r, p in enumerate(parts):
        assert not torch.isnan(p).any(), r
        lo, hi = DA.slice_range(pos, win, r * (S // m), S // m)
        if hi < lo:
            assert bool((p[..., hd] == -math.inf).all())
            assert bool((p[..., hd + 1] == 0).all())
            assert bool((p[..., :hd] == 0).all())


def test_combine_of_nothing_kept_is_zero():
    """Every rank empty: the combine's weights are all zero, not
    exp(-inf - -inf), and the output is zero."""
    q, k, v = map(torch.from_numpy, _inputs(1, 16, 4, 2, 16))
    parts = [ref.decode_attention_partial(q[:, 0], k, v, 0, -1)
             for _ in range(3)]
    out = DA.combine_partials(parts)
    assert not torch.isnan(out).any() and bool((out == 0).all())


@pytest.mark.parametrize("m", [2, 4])
def test_ring_partials_match_the_ring_decode(m):
    """A ring buffer of W slots split over m ranks, written past its end
    (pos >= W): the masked partials combined equal the one-process ring
    decode (``standard_layout=False``)."""
    B, W, Hq, Hkv, hd, pos = 2, 16, 4, 1, 16, 37
    q, k, v = map(torch.from_numpy, _inputs(B, W, Hq, Hkv, hd, seed=3))
    sl = torch.arange(W)
    kp = pos - torch.remainder(pos - sl, W)
    whole = tattn.decode_attention_ref(
        q, k, v, q_position=torch.full((B,), pos, dtype=torch.int32),
        k_positions=kp[None].expand(B, W), window=W,
        standard_layout=False)[:, 0]
    n = W // m
    parts = [ref.decode_partial_masked(
        q[:, 0], k[:, r * n:(r + 1) * n], v[:, r * n:(r + 1) * n],
        (kp[r * n:(r + 1) * n] >= 0) & (pos - kp[r * n:(r + 1) * n] < W))
        for r in range(m)]
    np.testing.assert_allclose(DA.combine_partials(parts).numpy(),
                               whole.numpy(), **TOL)


def test_partial_wrapper_refuses_cpu_tensors():
    q, k, v = map(torch.from_numpy, _inputs(1, 16, 4, 2, 16))
    with pytest.raises(ValueError):
        DA.decode_attention_partial(q[:, 0], k, v, 0, 15)


# ---------------------------------------------------------------------------
# on the card
# ---------------------------------------------------------------------------


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    torch.backends.cuda.matmul.allow_tf32 = False
    return torch.device("cuda")


CARD = [(4, 1024, 16, 8, 128, lo, hi, dt)
        for lo, hi in ((0, 1023), (0, 511), (100, 900), (0, -1), (0, 31))
        for dt in ("bfloat16", "float32")] + [
    (2, 64, 4, 2, 16, 0, 40, "bfloat16"),
    (2, 128, 12, 2, 64, 5, 127, "float32"),
    (8, 2048, 16, 8, 128, 0, 2047, "bfloat16")]


@pytest.mark.cuda
@pytest.mark.parametrize("B,S,Hq,Hkv,hd,lo,hi,dt", CARD)
def test_partial_kernel_matches_plain_on_card(cuda, B, S, Hq, Hkv, hd, lo,
                                              hi, dt):
    g = torch.Generator(device=cuda).manual_seed(0)
    dtype = getattr(torch, dt)
    q, k, v = (torch.randn(s, generator=g, device=cuda).to(dtype)
               for s in ((B, Hq, hd), (B, S, Hkv, hd), (B, S, Hkv, hd)))
    got = DA.decode_attention_partial(q, k, v, lo, hi)
    want = ref.decode_attention_partial(q, k, v, lo, hi)
    torch.cuda.synchronize()
    assert not torch.isnan(got).any()
    t = 3e-5 if dt == "float32" else 2e-2
    np.testing.assert_allclose(got.cpu().numpy(), want.cpu().numpy(),
                               rtol=t, atol=t)
