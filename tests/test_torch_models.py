"""The port's dense LM (``repro_torch.models``) against the JAX package's,
on the reduced qwen3-1.7b with the reference's own init bridged across
(``repro_torch.bridge.params_from_numpy``), on the CPU.

Tolerances: forward logits in float32 compute at rtol 1e-4 / atol 1e-5
(the two libraries sum the products in another order and their rsqrt, exp,
pow, sin and cos differ in the last bits); in the default bfloat16 compute
at 2e-2, the tolerance tests/test_models_smoke.py holds bf16 logits to
(rounding to bf16 at other places of a sum moves a value by a bf16 ulp).
Caches and decode logits at the same two tolerances, the bf16 atol scaled
by max(1, max|x|) of the reference tensor: the k/v caches are normalised
per head (qk-norm), so their entries reach 3, where one bf16 ulp is 0.016,
while the logits stay below 1.  Within the port: prefill-then-decode
equals forward and stage composition equals the full forward at 2e-2 in
bf16, as the reference's tests hold it.
"""
import dataclasses

import numpy as np
import pytest

torch = pytest.importorskip("torch")
import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from repro.configs import get_config as jget_config  # noqa: E402
from repro.configs import reduced as jreduced  # noqa: E402
from repro.models import build_model as jbuild_model  # noqa: E402
from repro_torch import bridge  # noqa: E402
from repro_torch.configs import get_config, reduced  # noqa: E402
from repro_torch.models import build_model  # noqa: E402
from repro_torch.models.common import count_params, slice_layers  # noqa: E402
from repro_torch.models.transformer import (embed_in, head_out,  # noqa: E402
                                            run_layers)

torch.set_num_threads(1)
TOL = {"float32": dict(rtol=1e-4, atol=1e-5),
       "bfloat16": dict(rtol=2e-2, atol=2e-2)}
B, S = 2, 64          # two q chunks of reduced()'s attn_chunk = 32


def _f32(x) -> np.ndarray:
    if torch.is_tensor(x):
        return x.float().cpu().numpy()
    return np.asarray(x, np.float32)


def assert_close(got, want, cd: str) -> None:
    got, want = _f32(got), _f32(want)
    tol = dict(TOL[cd])
    if cd == "bfloat16":
        tol["atol"] *= max(1.0, float(np.abs(want).max()))
    np.testing.assert_allclose(got, want, **tol)


@pytest.fixture(scope="module")
def jax_init():
    jcfg = jreduced(jget_config("qwen3-1.7b"))
    params = jbuild_model(jcfg).init(jax.random.PRNGKey(0))
    return jcfg, params, jax.tree.map(np.asarray, params)


@pytest.fixture(scope="module", params=["float32", "bfloat16"])
def pair(request, jax_init):
    """(dtype, JAX cfg, JAX model, JAX params, port cfg, port model, port
    params) in one compute dtype, on the same weights."""
    cd = request.param
    jcfg0, jparams, tree = jax_init
    jcfg = dataclasses.replace(jcfg0, compute_dtype=cd)
    tcfg = dataclasses.replace(reduced(get_config("qwen3-1.7b")),
                               compute_dtype=cd)
    return (cd, jcfg, jbuild_model(jcfg), jparams, tcfg, build_model(tcfg),
            bridge.params_from_numpy(tree, tcfg, device="cpu"))


def _tokens(seed=0, b=B, s=S):
    return np.random.default_rng(seed).integers(0, 256, (b, s)).astype(
        np.int32)


def _t(toks):
    return torch.from_numpy(toks).long()


def test_reduced_config_matches_reference():
    j = dataclasses.asdict(jreduced(jget_config("qwen3-1.7b")))
    t = dataclasses.asdict(reduced(get_config("qwen3-1.7b")))
    assert t == j
    full = get_config("qwen3-1.7b")
    assert full.param_count() == jget_config("qwen3-1.7b").param_count()
    assert (full.head_dim_, full.q_groups, full.exit_layers_) == (128, 2,
                                                                  (7, 14))


def test_unported_architectures_raise():
    """The encdec family (whisper-medium) is the one not ported yet."""
    with pytest.raises(NotImplementedError, match="ROADMAP"):
        get_config("whisper-medium")
    with pytest.raises(KeyError):
        get_config("no-such-arch")
    encdec = dataclasses.replace(reduced(get_config("qwen3-1.7b")),
                                 family="encdec")
    with pytest.raises(NotImplementedError):
        build_model(encdec)


def test_params_round_trip_is_exact(jax_init):
    jcfg, _, tree = jax_init
    cfg = reduced(get_config("qwen3-1.7b"))
    lm = bridge.params_from_numpy(tree, cfg, device="cpu")
    back = bridge.params_to_numpy(lm)
    flat_a = jax.tree_util.tree_leaves_with_path(tree)
    flat_b = dict(jax.tree_util.tree_leaves_with_path(back))
    assert len(flat_a) == len(flat_b)
    for path, a in flat_a:
        np.testing.assert_array_equal(flat_b[path], a)
        assert flat_b[path].dtype == a.dtype
    assert count_params(lm) == sum(a.size for _, a in flat_a)
    assert lm.layers[0]["attn"]["wq"].shape == (64, 4, 16)     # [d,Hq,hd]
    assert lm.layers[1]["attn"]["wo"].shape == (4, 16, 64)     # [Hq,hd,d]


def test_forward_logits_match_jax(pair):
    cd, _, jm, jp, _, tm, tp = pair
    toks = _tokens()
    want = jm.forward(jp, {"tokens": jnp.asarray(toks)})[0]
    got, caches, aux = tm.forward(tp, {"tokens": _t(toks)})
    assert got.dtype == getattr(torch, cd) and caches is None and aux == {}
    assert_close(got, want, cd)


def test_prefill_caches_match_jax(pair):
    cd, _, jm, jp, _, tm, tp = pair
    toks = _tokens(1)
    jlast, jc = jm.prefill(jp, {"tokens": jnp.asarray(toks)})
    tlast, tc = tm.prefill(tp, {"tokens": _t(toks)})
    assert tuple(tc["k"].shape) == tuple(jc["k"].shape) == (2, B, S, 2, 16)
    assert_close(tlast, jlast, cd)
    for name in ("k", "v"):
        assert_close(tc[name], jc[name], cd)


def test_decode_replay_matches_jax(pair):
    cd, _, jm, jp, _, tm, tp = pair
    n = 12
    toks = _tokens(2, s=n)
    jc, tc = jm.init_cache(B, n), tm.init_cache(B, n, device="cpu")
    for t in range(n):
        jl, jc = jm.decode_step(jp, jc, {"token": jnp.asarray(toks[:, t:t + 1]),
                                         "pos": jnp.int32(t)})
        tl, tc2 = tm.decode_step(tp, tc, {"token": _t(toks[:, t:t + 1]),
                                          "pos": t})
        assert tc2["k"] is tc["k"]        # written in place
        assert_close(tl, jl, cd)
    for name in ("k", "v"):
        assert_close(tc[name], jc[name], cd)


def test_prefill_then_decode_matches_forward():
    """Replay every token through decode_step; the last logits equal the
    full forward's at that position (test_models_smoke.py:73)."""
    cfg = reduced(get_config("qwen3-1.7b"))
    m = build_model(cfg)
    p = m.init(torch.Generator().manual_seed(0), device="cpu")
    toks = _t(_tokens(3, s=8))
    full = m.forward(p, {"tokens": toks})[0]
    caches = m.init_cache(B, 8, device="cpu")
    for t in range(8):
        logits, caches = m.decode_step(p, caches, {"token": toks[:, t:t + 1],
                                                   "pos": t})
    np.testing.assert_allclose(_f32(logits), _f32(full[:, -1]),
                               **TOL["bfloat16"])


def test_prefill_into_longer_cache_then_greedy_decode_matches_forward():
    """The serving flow of chip_smoke.py at small size: prefill a prompt,
    copy its k/v into a longer cache, decode greedily, and hold each step's
    logits against forward over prompt + generated tokens."""
    cfg = reduced(get_config("qwen3-1.7b"))
    m = build_model(cfg)
    p = m.init(torch.Generator().manual_seed(1), device="cpu")
    P, T = 40, 6
    prompt = _t(_tokens(4, s=P))
    last, pc = m.prefill(p, {"tokens": prompt})
    caches = m.init_cache(B, P + T, device="cpu")
    for name in ("k", "v"):
        caches[name][:, :, :P] = pc[name]
    seq, steps = [prompt], [last]
    logits = last
    for t in range(T):
        nxt = logits.argmax(-1)[:, None]
        seq.append(nxt)
        logits, caches = m.decode_step(p, caches, {"token": nxt,
                                                   "pos": P + t})
        steps.append(logits)
    full = m.forward(p, {"tokens": torch.cat(seq, 1)})[0]
    for t, lg in enumerate(steps):
        np.testing.assert_allclose(_f32(lg), _f32(full[:, P - 1 + t]),
                                   **TOL["bfloat16"])


def test_stage_composition_equals_full_forward():
    """Layers [0, 1) then [1, L) reproduce the full forward
    (test_splitcompute.py:15)."""
    cfg = reduced(get_config("qwen3-1.7b"))
    m = build_model(cfg)
    p = m.init(torch.Generator().manual_seed(0), device="cpu")
    batch = {"tokens": _t(_tokens(5, s=16))}
    full = m.forward(p, batch)[0]
    h, positions = embed_in(p, cfg, batch)
    for a, b in [(0, 1), (1, cfg.num_layers)]:
        h, _, _ = run_layers(slice_layers(p.layers, a, b), cfg, h, positions)
    np.testing.assert_allclose(_f32(head_out(p, cfg, h)), _f32(full),
                               **TOL["bfloat16"])


def test_init_follows_the_reference_distributions():
    cfg = reduced(get_config("qwen3-1.7b"))
    p = build_model(cfg).init(torch.Generator().manual_seed(0), device="cpu")
    wq = p.layers[0]["attn"]["wq"]
    assert wq.dtype == torch.float32
    assert float(wq.abs().max()) <= 2.0 / 64 ** 0.5 + 1e-7    # trunc at ±2σ
    assert abs(float(p.embed.std()) - 0.02) < 2e-3
    assert torch.equal(p.layers[1]["attn"]["q_norm"], torch.ones(16))


def test_model_init_needs_cuda_by_default():
    if torch.cuda.is_available():
        pytest.skip("this machine has CUDA: the default device is valid")
    m = build_model(reduced(get_config("qwen3-1.7b")))
    with pytest.raises(RuntimeError, match="CUDA"):
        m.init(torch.Generator().manual_seed(0))
    with pytest.raises(RuntimeError, match="CUDA"):
        m.init_cache(1, 8)
