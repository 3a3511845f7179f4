"""The port's ssm family (``repro_torch.models.ssm_lm`` + ``mamba``) against
the JAX package's, on the reduced falcon-mamba-7b with the reference's own
init bridged across, on the CPU; and on the card (marker ``cuda``) the
kernel path against the CPU's plain path.

Tolerances: float32 compute at rtol 1e-4 / atol 1e-5 (the two libraries
sum products in another order and their exp, log1p, sigmoid, rsqrt, sin
and cos differ in the last bits); bfloat16 compute at 2e-2, the tolerance
tests/test_models_smoke.py holds bf16 logits to, with atol scaled by
max(1, max|want|) because caches (ring-buffered keys after RoPE, conv
states) reach several units, where one bf16 ulp is 0.016 or more.  Within
the port, prefill-then-decode against forward at the same bf16 2e-2.  The
helpers above the tests are shared with tests/test_torch_hybrid.py.
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
from repro_torch.kernels import build as kbuild  # noqa: E402
from repro_torch.models import build_model  # noqa: E402
from repro_torch.models.common import count_params  # noqa: E402
from repro_torch.models.mamba import dt_rank_of  # noqa: E402
from repro_torch.models.transformer import LM  # noqa: E402

torch.set_num_threads(1)
ARCH = "falcon-mamba-7b"
B = 2
TOL = {"float32": dict(rtol=1e-4, atol=1e-5),
       "bfloat16": dict(rtol=2e-2, atol=2e-2)}


def f32(x) -> np.ndarray:
    if torch.is_tensor(x):
        return x.detach().float().cpu().numpy()
    return np.asarray(x, np.float32)


def assert_close(got, want, cd: str, what: str = "") -> None:
    got, want = f32(got), f32(want)
    tol = dict(TOL[cd])
    if cd == "bfloat16":
        tol["atol"] *= max(1.0, float(np.abs(want).max()))
    np.testing.assert_allclose(got, want, err_msg=what, **tol)


def assert_trees_close(got, want, cd: str) -> None:
    """Leaf by leaf, in order, over two pytrees of the same structure (the
    port's caches through ``bridge.caches_to_numpy`` against JAX's)."""
    gl = jax.tree_util.tree_leaves_with_path(got)
    wl = jax.tree_util.tree_leaves_with_path(want)
    assert [p for p, _ in gl] == [p for p, _ in wl]
    for (path, g), (_, w) in zip(gl, wl, strict=True):
        assert g.shape == w.shape, path
        assert_close(g, w, cd, what=jax.tree_util.keystr(path))


def tokens(seed: int, b: int, s: int, vocab: int = 256) -> np.ndarray:
    return np.random.default_rng(seed).integers(0, vocab, (b, s)).astype(
        np.int32)


def build_pair(arch: str, cd: str, jax_params=None,
               scan_layers: bool = True):
    """(JAX cfg, JAX model, JAX params, port cfg, port model, port params)
    of the reduced ``arch`` in compute dtype ``cd``, on the same weights
    (``jax_params``, or the JAX init from key 0).  ``scan_layers=False``
    runs the reference's layers as a Python loop (its ``unrolled_scan``),
    op by op as the port runs them; under ``lax.scan`` XLA fuses the layer
    body and keeps bfloat16 intermediates in float32."""
    jcfg = dataclasses.replace(jreduced(jget_config(arch)), compute_dtype=cd,
                               scan_layers=scan_layers)
    tcfg = dataclasses.replace(reduced(get_config(arch)), compute_dtype=cd)
    jm = jbuild_model(jcfg)
    jp = jax_params if jax_params is not None else jm.init(
        jax.random.PRNGKey(0))
    tp = bridge.params_from_numpy(jax.tree.map(np.asarray, jp), tcfg,
                                  device="cpu")
    return jcfg, jm, jp, tcfg, build_model(tcfg), tp


@pytest.fixture(scope="module")
def jax_params():
    return jbuild_model(jreduced(jget_config(ARCH))).init(
        jax.random.PRNGKey(0))


@pytest.fixture(scope="module", params=["float32", "bfloat16"])
def pair(request, jax_params):
    return (request.param, *build_pair(ARCH, request.param, jax_params))


def _t(toks):
    return torch.from_numpy(toks).long()


def test_config_reduced_and_param_count_match_reference():
    """No allocation: the full config, its analytic count and reduced()."""
    full, jfull = get_config(ARCH), jget_config(ARCH)
    assert dataclasses.asdict(full) == dataclasses.asdict(jfull)
    assert full.param_count() == jfull.param_count() == 7_271_612_416
    assert dataclasses.asdict(reduced(full)) == dataclasses.asdict(
        jreduced(jfull))
    r = reduced(full)
    assert (r.num_layers, r.d_model, r.ssm.d_state, r.ssm.chunk) == (2, 64,
                                                                   4, 8)
    assert r.param_count() == jreduced(jfull).param_count()
    assert dt_rank_of(full) == 256 and dt_rank_of(r) == 4


def test_params_round_trip_is_exact(jax_params):
    tree = jax.tree.map(np.asarray, jax_params)
    cfg = reduced(get_config(ARCH))
    lm = bridge.params_from_numpy(tree, cfg, device="cpu")
    back = bridge.params_to_numpy(lm)
    flat = jax.tree_util.tree_leaves_with_path(tree)
    got = dict(jax.tree_util.tree_leaves_with_path(back))
    assert len(flat) == len(got)
    for path, a in flat:
        np.testing.assert_array_equal(got[path], a)
    assert count_params(lm) == sum(a.size for _, a in flat)
    assert lm.layers[1]["mamba"]["A_log"].shape == (128, 4)   # [d_in, N]
    assert lm.lm_head.shape == (64, 256)                       # untied


def test_forward_logits_match_jax(pair):
    cd, _, jm, jp, _, tm, tp = pair
    toks = tokens(0, B, 24)
    want = jm.forward(jp, {"tokens": jnp.asarray(toks)})[0]
    got, caches, aux = tm.forward(tp, {"tokens": _t(toks)})
    assert got.dtype == getattr(torch, cd) and caches is None and aux == {}
    assert_close(got, want, cd)


@pytest.mark.parametrize("S", [24, 20])
def test_prefill_logits_and_caches_match_jax(pair, S):
    """Three chunks of 8 with the carry, and the one-chunk fallback (20 is
    not a multiple of 8)."""
    cd, jcfg, jm, jp, tcfg, tm, tp = pair
    toks = tokens(1, B, S)
    jlast, jc = jm.prefill(jp, {"tokens": jnp.asarray(toks)})
    tlast, tc = tm.prefill(tp, {"tokens": _t(toks)})
    assert len(tc) == tcfg.num_layers
    assert tc[0][0].dtype == getattr(torch, cd)
    assert tc[0][1].dtype == torch.float32
    assert_close(tlast, jlast, cd)
    assert_trees_close(bridge.caches_to_numpy(tc, tcfg),
                       jax.tree.map(f32, jc), cd)


def test_decode_steps_match_jax(pair):
    """Four decode steps in both packages from the JAX prefill's caches
    (bridged): logits and every cache after each step."""
    cd, jcfg, jm, jp, tcfg, tm, tp = pair
    S = 16
    _, jc = jm.prefill(jp, {"tokens": jnp.asarray(tokens(2, B, S))})
    tc = bridge.caches_from_numpy(jax.tree.map(np.asarray, jc), tcfg,
                                 device="cpu")
    nxt = tokens(3, B, 4)
    for t in range(4):
        tok = nxt[:, t:t + 1]
        jl, jc = jm.decode_step(jp, jc, {"token": jnp.asarray(tok),
                                         "pos": jnp.int32(S + t)})
        tl, tc2 = tm.decode_step(tp, tc, {"token": _t(tok), "pos": S + t})
        assert tc2 is tc and tc2[0][1] is tc[0][1]        # in place
        assert_close(tl, jl, cd, what=f"step {t}")
        assert_trees_close(bridge.caches_to_numpy(tc, tcfg),
                           jax.tree.map(f32, jc), cd)


def test_caches_round_trip_is_exact(pair):
    cd, jcfg, jm, jp, tcfg, _, _ = pair
    jc = jax.tree.map(np.asarray, jm.prefill(
        jp, {"tokens": jnp.asarray(tokens(4, B, 8))})[1])
    back = bridge.caches_to_numpy(
        bridge.caches_from_numpy(jc, tcfg, device="cpu"), tcfg)
    for a, b in zip(jax.tree.leaves(back), jax.tree.leaves(jc),
                    strict=True):
        np.testing.assert_array_equal(a, np.asarray(b, np.float32))


def test_prefill_then_decode_matches_forward():
    """Prefill a prompt, decode the next tokens one by one; each step's
    logits equal forward's over the whole sequence at that position."""
    cfg = reduced(get_config(ARCH))
    m = build_model(cfg)
    p = m.init(torch.Generator().manual_seed(0), device="cpu")
    P, T = 16, 6
    seq = _t(tokens(5, B, P + T))
    last, caches = m.prefill(p, {"tokens": seq[:, :P]})
    full = m.forward(p, {"tokens": seq})[0]
    steps = [last]
    for t in range(T - 1):
        logits, caches = m.decode_step(p, caches, {
            "token": seq[:, P + t:P + t + 1], "pos": P + t})
        steps.append(logits)
    for t, lg in enumerate(steps):
        assert_close(lg, full[:, P - 1 + t], "bfloat16", what=f"step {t}")


def test_init_follows_the_reference_formulas():
    cfg = reduced(get_config(ARCH))
    p = build_model(cfg).init(torch.Generator().manual_seed(0), device="cpu")
    assert isinstance(p, LM) and len(p.layers) == 2
    blk = p.layers[0]["mamba"]
    N, d_in = cfg.ssm.d_state, cfg.ssm.expand * cfg.d_model
    A = torch.arange(1, N + 1, dtype=torch.float32).repeat(d_in, 1)
    assert torch.equal(blk["A_log"], torch.log(A))
    assert torch.equal(blk["D"], torch.ones(d_in))
    dt = torch.nn.functional.softplus(blk["dt_bias"])
    assert float(dt.min()) >= 1e-3 * (1 - 1e-5)
    assert float(dt.max()) <= 0.1 * (1 + 1e-5)
    assert torch.equal(blk["conv_b"], torch.zeros(d_in))
    assert float(blk["in_proj"].abs().max()) <= 2.0 / 64 ** 0.5 + 1e-7


def test_model_init_needs_cuda_by_default():
    if torch.cuda.is_available():
        pytest.skip("this machine has CUDA: the default device is valid")
    m = build_model(reduced(get_config(ARCH)))
    with pytest.raises(RuntimeError, match="CUDA"):
        m.init(torch.Generator().manual_seed(0))
    with pytest.raises(RuntimeError, match="CUDA"):
        m.init_cache(1, 8)


@pytest.mark.cuda
def test_reduced_model_on_card_matches_cpu():
    """The reduced falcon-mamba on the card, through the rmsnorm and
    mamba_scan kernels, against the same weights on the CPU (plain paths):
    prefill, then decode steps, at the bf16 tolerance; one mamba_scan per
    layer and one rmsnorm per norm."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    torch.backends.cuda.matmul.allow_tf32 = False
    cfg = reduced(get_config(ARCH))
    m = build_model(cfg)
    cpu = m.init(torch.Generator().manual_seed(0), device="cpu")
    card = m.init(torch.Generator(device="cuda").manual_seed(0))
    card.load_state_dict(cpu.state_dict())
    toks = _t(tokens(6, B, 40))
    outs, launches = {}, {}
    for name, p, dev in (("cpu", cpu, "cpu"), ("card", card, "cuda")):
        kbuild.reset_launches()
        last, caches = m.prefill(p, {"tokens": toks[:, :32].to(dev)})
        launches[name] = dict(kbuild.LAUNCHES)
        steps = [last]
        for t in range(8):
            logits, caches = m.decode_step(p, caches, {
                "token": toks[:, 32 + t:33 + t].to(dev), "pos": 32 + t})
            steps.append(logits)
        outs[name] = torch.stack(steps, 1)
    L = cfg.num_layers
    assert launches["cpu"]["mamba_scan"] == launches["cpu"]["rmsnorm"] == 0
    assert launches["card"]["mamba_scan"] == L
    assert launches["card"]["rmsnorm"] == L + 1             # ln + final
    assert_close(outs["card"], outs["cpu"], "bfloat16")
