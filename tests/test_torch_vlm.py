"""The port's vlm family (M-RoPE in ``repro_torch.models.common`` and the
embeds/positions inputs of ``repro_torch.models.transformer``) against the
JAX package's, on the reduced qwen2-vl-2b (sections (2, 3, 3)) with the
reference's init bridged across, on the CPU.

* ``rope_angles`` with sections against the reference's, at rtol 1e-6 /
  atol 1e-5 (the two libraries' f32 pow, cos and sin differ in the last
  bits), and exactly against the port's own standard RoPE of each
  section's position stream (the section split is a gather).
* Forward and prefill from ``embeds`` with distinct per-section positions
  (text, then an image block sharing one temporal index over a 4 x 6
  height/width grid, then text again), and decode from tokens, at the
  ``TOL`` of tests/test_torch_models.py; in bfloat16 the reference runs its
  layers op by op, as in tests/test_torch_hybrid.py.  The plain path masks
  by the temporal row ``positions[0]``, so the image block attends within
  itself, in both packages.
"""
import numpy as np
import pytest

torch = pytest.importorskip("torch")
import jax.numpy as jnp  # noqa: E402
from test_torch_ssm import assert_close, build_pair, f32, tokens  # noqa: E402

from repro.models import common as jcommon  # noqa: E402
from repro_torch.models import common as tcommon  # noqa: E402

torch.set_num_threads(1)
ARCH = "qwen2-vl-2b"
B, S, D = 2, 48, 64


def vlm_positions(b=B, s=S) -> np.ndarray:
    """[3, b, s] int32: text 0..7, an image of 24 patches at temporal
    index 8 on a 4 x 6 grid, then text from 14 on."""
    t, h, w = (np.arange(s) for _ in range(3))
    img = slice(8, 32)
    t[img] = 8
    h[img] = 8 + np.arange(24) // 6
    w[img] = 8 + np.arange(24) % 6
    for row in (t, h, w):
        row[32:] = np.arange(s - 32) + 14
    return np.broadcast_to(np.stack([t, h, w])[:, None, :],
                           (3, b, s)).astype(np.int32)


def embeds(seed=0, b=B, s=S) -> np.ndarray:
    return (np.random.default_rng(seed).standard_normal((b, s, D))
            * 0.5).astype(np.float32)


@pytest.mark.parametrize("head_dim,sections,theta", [
    (16, (2, 3, 3), 1e6),           # the reduced config
    (128, (16, 24, 24), 1e6),       # qwen2-vl-2b
    (32, (4, 8, 4), 1e4),
])
def test_mrope_angles_match_reference(head_dim, sections, theta):
    rng = np.random.default_rng(head_dim)
    pos = rng.integers(0, 64, (len(sections), 2, 20)).astype(np.int32)
    jc, js = jcommon.rope_angles(jnp.asarray(pos), head_dim, theta,
                                 sections)
    tc, ts = tcommon.rope_angles(torch.from_numpy(pos), head_dim, theta,
                                 sections)
    for got, want in ((tc, jc), (ts, js)):
        assert got.shape == (2, 20, head_dim)
        np.testing.assert_allclose(got.numpy(), np.asarray(want),
                                   rtol=1e-6, atol=1e-5)
    # frequency f takes section sec_id[f]'s positions, bit for bit
    sec_id = np.repeat(np.arange(len(sections)), sections)
    half = head_dim // 2
    for r in range(len(sections)):
        c, s = tcommon.rope_angles(torch.from_numpy(pos[r]), head_dim,
                                   theta)
        cols = np.flatnonzero(sec_id == r)
        for got, want in ((tc, c), (ts, s)):
            for f in cols:
                assert torch.equal(got[..., f], want[..., f])
                assert torch.equal(got[..., half + f], want[..., half + f])


def test_mrope_needs_one_stream_per_section():
    with pytest.raises(ValueError, match="M-RoPE"):
        tcommon.rope_angles(torch.zeros(2, 4, dtype=torch.int32), 16, 1e6,
                            (2, 3, 3))


@pytest.fixture(scope="module", params=["float32", "bfloat16"])
def pair(request):
    cd = request.param
    return (cd, *build_pair(ARCH, cd, scan_layers=cd == "float32"))


def test_forward_from_embeds_matches_jax(pair):
    cd, _, jm, jp, _, tm, tp = pair
    e, pos = embeds(), vlm_positions()
    want = jm.forward(jp, {"embeds": jnp.asarray(e),
                           "positions": jnp.asarray(pos)})[0]
    got, caches, aux = tm.forward(tp, {"embeds": torch.from_numpy(e),
                                       "positions": torch.from_numpy(
                                           pos.copy())})
    assert caches is None and aux == {}
    assert got.dtype == getattr(torch, cd)
    assert_close(got, want, cd)
    # the sections matter: the same embeds at the default positions differ
    plain = tm.forward(tp, {"embeds": torch.from_numpy(e)})[0]
    assert not np.allclose(f32(plain), f32(got), rtol=1e-2, atol=1e-2)


def test_prefill_from_embeds_matches_jax(pair):
    cd, _, jm, jp, _, tm, tp = pair
    e, pos = embeds(1), vlm_positions()
    jlast, jc = jm.prefill(jp, {"embeds": jnp.asarray(e),
                                "positions": jnp.asarray(pos)})
    tlast, tc = tm.prefill(tp, {"embeds": torch.from_numpy(e),
                                "positions": torch.from_numpy(pos.copy())})
    assert_close(tlast, jlast, cd)
    for name in ("k", "v"):
        assert tuple(tc[name].shape) == tuple(jc[name].shape)
        assert_close(tc[name], jc[name], cd)


def test_prefill_from_embeds_then_decode_tokens_matches_jax(pair):
    """Prefill a prompt of embeds at the default M-RoPE positions, copy its
    k/v into a longer cache, then decode tokens (every section at the
    step's position), and the last step from embeds."""
    cd, _, jm, jp, _, tm, tp = pair
    P, n = 16, 6
    e = embeds(2, s=P)
    _, jpc = jm.prefill(jp, {"embeds": jnp.asarray(e)})
    _, tpc = tm.prefill(tp, {"embeds": torch.from_numpy(e)})
    jc = jm.init_cache(B, P + n)
    tc = tm.init_cache(B, P + n, device="cpu")
    jc = {k: jc[k].at[:, :, :P].set(jpc[k]) for k in ("k", "v")}
    for k in ("k", "v"):
        tc[k][:, :, :P] = tpc[k]
    toks = tokens(3, B, n)
    for t in range(n):
        if t < n - 1:
            jb = {"token": jnp.asarray(toks[:, t:t + 1])}
            tb = {"token": torch.from_numpy(toks[:, t:t + 1]).long()}
        else:
            x = embeds(4, s=1)
            jb = {"embeds": jnp.asarray(x)}
            tb = {"embeds": torch.from_numpy(x)}
        jl, jc = jm.decode_step(jp, jc, {**jb, "pos": jnp.int32(P + t)})
        tl, tc = tm.decode_step(tp, tc, {**tb, "pos": P + t})
        assert_close(tl, jl, cd, what=f"decode step {t}")
