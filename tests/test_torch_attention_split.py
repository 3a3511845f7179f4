"""The Hopper designs of the two attention kernels, held on the CPU.

* ``split_plan`` (the decode kernel's split of the kept cache range over
  the card): every kept slot in exactly one split, no split empty, at least
  two blocks an SM where the range allows, one split at tiny ranges.
* The decode kernel's split-S combine, emulated in plain torch from each
  split's partial (m, l, acc) in f32, against ``repro.kernels.ref`` and the
  Pallas kernel in interpret mode at the shapes of tests/test_kernels.py,
  for 1 to 8 splits: 3e-5 in float32, 2e-2 in bfloat16 (the reference
  rounds p to bf16 before p·v, the kernel keeps it in f32).
* The flash kernel's tensor-core numerics, emulated in plain torch (the
  online softmax over 64-key tiles, causal tiles skipped, the unnormalised
  p rounded to bf16 before p·v, f32 accumulation), against the Pallas
  kernel in interpret mode at the bf16 shapes of tests/test_kernels.py and
  at recurrentgemma's head_dim with MQA, within the bf16 tolerance (2e-2):
  the rounding the kernel adds stays inside the reference's tolerance.
"""
import math

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro_torch.kernels import decode_attention as cuda_decode  # noqa: E402

torch.set_num_threads(1)

SMS = 132                      # an H100 SXM's SMs
SERVE = dict(B=4, Hkv=8, G=2)  # qwen3-1.7b's decode: 16 query, 8 kv heads


def _normal(shape, dtype, seed):
    x = np.random.default_rng(seed).standard_normal(shape).astype(np.float32)
    t = torch.from_numpy(x).to(getattr(torch, dtype))
    return t, t.float().numpy()


def _qkv(q_shape, kv_shape, dtype, seed=0):
    return [_normal(s, dtype, seed + i)
            for i, s in enumerate((q_shape, kv_shape, kv_shape))]


def tol(dtype: str) -> dict:
    return dict(rtol=2e-2, atol=2e-2) if dtype == "bfloat16" \
        else dict(rtol=3e-5, atol=3e-5)


@pytest.fixture(scope="module")
def jax_side():
    """(jax.numpy, repro.kernels.ref, Pallas flash, Pallas decode)."""
    jnp = pytest.importorskip("jax.numpy")
    from repro.kernels import ref as jref
    from repro.kernels.decode_attention import decode_attention
    from repro.kernels.flash_attention import flash_attention
    return jnp, jref, flash_attention, decode_attention


def _jx(jnp, x32, dtype):
    return jnp.asarray(x32).astype(getattr(jnp, dtype))


# ---------------------------------------------------------------------------
# split_plan
# ---------------------------------------------------------------------------


def _kept_range(pos, window, S=1024):
    hi = min(pos, S - 1)
    lo = max(0, pos - window + 1) if window > 0 else 0
    return lo, hi


@pytest.mark.parametrize("window", [0, 256])
@pytest.mark.parametrize("pos", [0, 1, 63, 64, 65, 575, 1023])
def test_split_plan_covers_the_kept_range(pos, window):
    lo, hi = _kept_range(pos, window)
    kept = hi - lo + 1
    groups = -(-SERVE["G"] // cuda_decode.query_group(SERVE["G"]))
    splits, chunk = cuda_decode.split_plan(kept, SERVE["B"], SERVE["Hkv"],
                                           groups, SMS)
    firsts = [lo + s * chunk for s in range(splits)]
    lasts = [min(hi, f + chunk - 1) for f in firsts]
    assert all(f <= last for f, last in zip(firsts, lasts)), "empty split"
    covered = np.concatenate([np.arange(f, last + 1)
                              for f, last in zip(firsts, lasts)])
    np.testing.assert_array_equal(covered, np.arange(lo, hi + 1))
    blocks = SERVE["B"] * SERVE["Hkv"] * groups * splits
    base = SERVE["B"] * SERVE["Hkv"] * groups
    # two blocks an SM, unless the range has fewer SPLIT_ROWS pieces
    assert blocks >= min(2 * SMS, base * (kept // cuda_decode.SPLIT_ROWS))
    assert splits <= cuda_decode.MAX_SPLITS
    if kept <= cuda_decode.SPLIT_ROWS:
        assert splits == 1
    else:
        assert chunk % cuda_decode.SPLIT_ROWS == 0


@pytest.mark.parametrize("pos", [575, 1023])
def test_split_plan_fills_the_card_at_the_serving_shape(pos):
    splits, _ = cuda_decode.split_plan(pos + 1, SERVE["B"], SERVE["Hkv"], 1,
                                       SMS)
    assert SERVE["B"] * SERVE["Hkv"] * splits >= 2 * SMS


@pytest.mark.parametrize("kept", [2048, 10_000, 1 << 20])
@pytest.mark.parametrize("B,Hkv,groups", [(1, 1, 1), (4, 8, 1), (8, 2, 4)])
def test_split_plan_stays_within_the_kernels_limit(kept, B, Hkv, groups):
    splits, chunk = cuda_decode.split_plan(kept, B, Hkv, groups, SMS)
    assert splits <= cuda_decode.MAX_SPLITS
    assert (splits - 1) * chunk < kept <= splits * chunk


@pytest.mark.parametrize("err,what", [(2, "cudaError_t 2"),
                                      (-1, "CUresult 1")])
def test_failed_launches_raise_and_are_not_counted(err, what):
    from repro_torch.kernels import build as kbuild
    before = kbuild.LAUNCHES["decode_attention"]
    with pytest.raises(RuntimeError, match=what):
        kbuild.launched(err, "decode_attention")
    assert kbuild.LAUNCHES["decode_attention"] == before


@pytest.mark.parametrize("G,gm", [(1, 1), (2, 2), (3, 4), (4, 4), (5, 8),
                                  (8, 8), (12, 8)])
def test_query_group(G, gm):
    assert cuda_decode.query_group(G) == gm


# ---------------------------------------------------------------------------
# the decode kernel's split-S combine
# ---------------------------------------------------------------------------


def split_decode(q, k, v, pos, window, splits):
    """The decode kernel's arithmetic in plain torch, f32: each of
    ``splits`` contiguous chunks of the kept range gives its (m, l, acc);
    the chunks are then combined in split order."""
    B, Hq, hd = q.shape
    Hkv = k.shape[2]
    lo, hi = _kept_range(pos, window, S=k.shape[1])
    chunk = -(-(hi - lo + 1) // splits)
    qg = q.float().reshape(B, Hkv, Hq // Hkv, hd)
    parts = []
    for first in range(lo, hi + 1, chunk):
        ks = k[:, first:min(hi, first + chunk - 1) + 1].float()
        vs = v[:, first:min(hi, first + chunk - 1) + 1].float()
        s = torch.einsum("bkgd,bskd->bkgs", qg, ks) * (1.0 / math.sqrt(hd))
        m = s.amax(-1)
        p = torch.exp(s - m[..., None])
        parts.append((m, p.sum(-1), torch.einsum("bkgs,bskd->bkgd", p, vs)))
    M = parts[0][0]
    for m, _, _ in parts[1:]:
        M = torch.maximum(M, m)
    L = torch.zeros_like(M)
    A = torch.zeros_like(parts[0][2])
    for m, l, acc in parts:
        c = torch.exp(m - M)
        L = L + l * c
        A = A + acc * c[..., None]
    return (A / torch.where(L == 0, 1.0, L)[..., None]).reshape(B, Hq, hd)


DECODE_SHAPES = [  # B, S, Hq, Hkv, hd, pos, window, dtype (test_kernels.py)
    (2, 256, 8, 2, 64, 100, 0, "float32"),
    (1, 512, 4, 1, 128, 511, 0, "bfloat16"),
    (2, 256, 4, 4, 64, 200, 64, "float32"),
]


@pytest.mark.parametrize("splits", range(1, 9))
@pytest.mark.parametrize("B,S,Hq,Hkv,hd,pos,win,dt", DECODE_SHAPES)
def test_split_combine_matches_reference_and_pallas(jax_side, B, S, Hq, Hkv,
                                                    hd, pos, win, dt,
                                                    splits):
    jnp, jref, _, pl_decode = jax_side
    (q, q32), (k, k32), (v, v32) = _qkv((B, Hq, hd), (B, S, Hkv, hd), dt)
    got = split_decode(q, k, v, pos, win, splits).numpy()
    jq, jk, jv = (_jx(jnp, a, dt) for a in (q32, k32, v32))
    want = np.asarray(jref.decode_attention(jq, jk, jv, pos, window=win),
                      np.float32)
    pallas = np.asarray(pl_decode(jq, jk, jv, jnp.int32(pos), window=win,
                                  bk=128, interpret=True), np.float32)
    np.testing.assert_allclose(got, want, **tol(dt))
    np.testing.assert_allclose(got, pallas, **tol(dt))


# ---------------------------------------------------------------------------
# the flash kernel's tensor-core numerics
# ---------------------------------------------------------------------------


def tensor_core_flash(q, k, v, causal, window, bq=64, bk=64):
    """The bf16 flash kernel's arithmetic in plain torch: scores exact in
    f32, the online softmax over ``bk``-key tiles (tiles wholly above the
    diagonal or outside the window skipped), the unnormalised p rounded to
    bf16 before p·v with f32 accumulation, l the sum of the f32 p."""
    B, Sq, Hq, hd = q.shape
    Sk, Hkv = k.shape[1], k.shape[2]
    G = Hq // Hkv
    scale = 1.0 / math.sqrt(hd)
    out = torch.empty(B, Sq, Hq, hd)
    kf = k.float().repeat_interleave(G, dim=2)
    vf = v.float().repeat_interleave(G, dim=2)
    for q0 in range(0, Sq, bq):
        qt = q[:, q0:q0 + bq].float()
        rows = qt.shape[1]
        qpos = torch.arange(q0, q0 + rows)[:, None]
        kt_end = -(-Sk // bk)
        if causal:
            kt_end = min(kt_end, (q0 + bq - 1) // bk + 1)
        kt_begin = 0
        if window > 0 and q0 - window + 1 > 0:
            kt_begin = (q0 - window + 1) // bk
        m = torch.full((B, Hq, rows), -1e30)
        l = torch.zeros(B, Hq, rows)
        acc = torch.zeros(B, Hq, rows, hd)
        for kt in range(kt_begin, kt_end):
            k0 = kt * bk
            ks, vs = kf[:, k0:k0 + bk], vf[:, k0:k0 + bk]
            s = torch.einsum("bqhd,bkhd->bhqk", qt, ks) * scale
            kpos = torch.arange(k0, k0 + ks.shape[1])[None, :]
            keep = torch.ones(rows, ks.shape[1], dtype=torch.bool)
            if causal:
                keep &= qpos >= kpos
            if window > 0:
                keep &= (qpos - kpos) < window
            s = torch.where(keep, s, -1e30)
            m_new = torch.maximum(m, s.amax(-1))
            alpha = torch.exp(m - m_new)
            p = torch.exp(s - m_new[..., None])
            l = l * alpha + p.sum(-1)
            pv = torch.einsum("bhqk,bkhd->bhqd",
                              p.to(torch.bfloat16).float(), vs)
            acc = acc * alpha[..., None] + pv
            m = m_new
        o = acc / torch.where(l == 0, 1.0, l)[..., None]
        out[:, q0:q0 + rows] = o.permute(0, 2, 1, 3)
    return out.to(q.dtype)


@pytest.mark.parametrize("B,S,Hq,Hkv,hd,causal,win", [
    (1, 256, 8, 1, 128, True, 0),     # test_kernels.py's bf16 shapes
    (1, 128, 2, 2, 256, True, 0),
    (1, 128, 2, 1, 256, True, 0),     # recurrentgemma: head_dim 256, MQA
    (1, 256, 4, 1, 64, True, 96),     # a window that bites
])
def test_tensor_core_numerics_match_pallas(jax_side, B, S, Hq, Hkv, hd,
                                           causal, win):
    jnp, jref, pl_flash, _ = jax_side
    dt = "bfloat16"
    (q, q32), (k, k32), (v, v32) = _qkv((B, S, Hq, hd), (B, S, Hkv, hd), dt,
                                        seed=7)
    got = tensor_core_flash(q, k, v, causal, win).float().numpy()
    jq, jk, jv = (_jx(jnp, a, dt) for a in (q32, k32, v32))
    pallas = np.asarray(pl_flash(jq, jk, jv, causal=causal, window=win,
                                 bq=64, bk=64, interpret=True), np.float32)
    want = np.asarray(jref.flash_attention(jq, jk, jv, causal=causal,
                                           window=win), np.float32)
    np.testing.assert_allclose(got, pallas, **tol(dt))
    np.testing.assert_allclose(got, want, **tol(dt))
