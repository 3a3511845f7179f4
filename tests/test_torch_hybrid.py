"""The port's hybrid family (``repro_torch.models.hybrid`` + ``rglru``)
against the JAX package's, on the reduced recurrentgemma-9b (rec, rec,
attn, rec, rec; window 16) with the reference's own init bridged across,
on the CPU; and on the card (marker ``cuda``) the kernel path against the
CPU's plain path.

Tolerances and helpers are those of tests/test_torch_ssm.py: rtol 1e-4 /
atol 1e-5 in float32 compute, 2e-2 (atol scaled by max(1, max|want|)) in
bfloat16.
Prompts of 10 and 24 tokens put the attention's ring buffer before and
after its first wrap.
"""
import dataclasses

import numpy as np
import pytest

torch = pytest.importorskip("torch")
import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402
from test_torch_ssm import (assert_close, assert_trees_close,  # noqa: E402
                            build_pair, f32, tokens)

from repro.configs import get_config as jget_config  # noqa: E402
from repro.configs import reduced as jreduced  # noqa: E402
from repro.models import build_model as jbuild_model  # noqa: E402
from repro_torch import bridge  # noqa: E402
from repro_torch.configs import get_config, reduced  # noqa: E402
from repro_torch.kernels import build as kbuild  # noqa: E402
from repro_torch.models import build_model  # noqa: E402
from repro_torch.models.common import count_params  # noqa: E402
from repro_torch.models.hybrid import _pattern, layer_kinds  # noqa: E402

torch.set_num_threads(1)
ARCH = "recurrentgemma-9b"
B = 2


@pytest.fixture(scope="module")
def jax_params():
    return jbuild_model(jreduced(jget_config(ARCH))).init(
        jax.random.PRNGKey(0))


@pytest.fixture(scope="module", params=["float32", "bfloat16"])
def pair(request, jax_params):
    """In bfloat16 the reference runs its layers unrolled (op by op, as the
    port does): under ``lax.scan`` XLA keeps the fused layer body's bf16
    intermediates in f32, which moves the reduced model's logits from the
    same reference run op by op by more than the bf16 tolerance."""
    cd = request.param
    return (cd, *build_pair(ARCH, cd, jax_params,
                            scan_layers=cd == "float32"))


def _t(toks):
    return torch.from_numpy(toks).long()


def test_config_reduced_and_param_count_match_reference():
    """No allocation: the full config, its analytic count, its layer
    pattern (38 = 12 x 3 + a tail of 2 rec layers) and reduced()."""
    full, jfull = get_config(ARCH), jget_config(ARCH)
    assert dataclasses.asdict(full) == dataclasses.asdict(jfull)
    assert full.param_count() == jfull.param_count()
    assert _pattern(full) == (("rec", "rec", "attn"), 12, 2, "rec")
    kinds = layer_kinds(full)
    assert kinds.count("attn") == 12 and kinds[36:] == ["rec", "rec"]
    r = reduced(full)
    assert dataclasses.asdict(r) == dataclasses.asdict(jreduced(jfull))
    assert layer_kinds(r) == ["rec", "rec", "attn", "rec", "rec"]
    assert (r.hybrid.lru_width, r.hybrid.window) == (64, 16)
    assert r.param_count() == jreduced(jfull).param_count()


def test_params_round_trip_is_exact_and_flat(jax_params):
    """Super i, sublayer j is layer 3i + j; tail t is layer 3·n_super + t."""
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
    np.testing.assert_array_equal(
        lm.layers[2]["mixer"]["wq"].numpy(),
        tree["super"]["s2_attn"]["mixer"]["wq"][0])
    np.testing.assert_array_equal(lm.layers[4]["mixer"]["lam"].numpy(),
                                  tree["tail"]["mixer"]["lam"][1])
    assert lm.lm_head is None                                  # tied


def test_forward_logits_match_jax(pair):
    cd, _, jm, jp, _, tm, tp = pair
    toks = tokens(0, B, 24)
    want = jm.forward(jp, {"tokens": jnp.asarray(toks)})[0]
    got, caches, aux = tm.forward(tp, {"tokens": _t(toks)})
    assert got.dtype == getattr(torch, cd) and caches is None and aux == {}
    assert_close(got, want, cd)


@pytest.mark.parametrize("S", [10, 24])
def test_prefill_logits_and_caches_match_jax(pair, S):
    cd, jcfg, jm, jp, tcfg, tm, tp = pair
    toks = tokens(1, B, S)
    jlast, jc = jm.prefill(jp, {"tokens": jnp.asarray(toks)})
    tlast, tc = tm.prefill(tp, {"tokens": _t(toks)})
    assert len(tc) == tcfg.num_layers
    assert tc[2][0].shape == (B, 16, 1, 16)                    # ring buffer
    assert tc[0][1].dtype == torch.float32
    assert_close(tlast, jlast, cd)
    assert_trees_close(bridge.caches_to_numpy(tc, tcfg),
                       jax.tree.map(f32, jc), cd)


@pytest.mark.parametrize("S", [10, 24])
def test_decode_steps_match_jax(pair, S):
    """Four decode steps in both packages from the JAX prefill's caches
    (bridged): logits and every cache after each step."""
    cd, jcfg, jm, jp, tcfg, tm, tp = pair
    _, jc = jm.prefill(jp, {"tokens": jnp.asarray(tokens(2, B, S))})
    tc = bridge.caches_from_numpy(jax.tree.map(np.asarray, jc), tcfg,
                                 device="cpu")
    nxt = tokens(3, B, 4)
    for t in range(4):
        tok = nxt[:, t:t + 1]
        jl, jc = jm.decode_step(jp, jc, {"token": jnp.asarray(tok),
                                         "pos": jnp.int32(S + t)})
        tl, tc2 = tm.decode_step(tp, tc, {"token": _t(tok), "pos": S + t})
        assert tc2 is tc and tc2[2][0] is tc[2][0]        # in place
        assert_close(tl, jl, cd, what=f"step {t}")
        assert_trees_close(bridge.caches_to_numpy(tc, tcfg),
                           jax.tree.map(f32, jc), cd)


def test_caches_round_trip_is_exact(pair):
    cd, jcfg, jm, jp, tcfg, _, _ = pair
    jc = jax.tree.map(np.asarray, jm.prefill(
        jp, {"tokens": jnp.asarray(tokens(4, B, 20))})[1])
    back = bridge.caches_to_numpy(
        bridge.caches_from_numpy(jc, tcfg, device="cpu"), tcfg)
    for a, b in zip(jax.tree.leaves(back), jax.tree.leaves(jc),
                    strict=True):
        np.testing.assert_array_equal(a, np.asarray(b, np.float32))


@pytest.mark.parametrize("P", [8, 20])
def test_prefill_then_decode_matches_forward(P):
    """Prefill a prompt, decode the next tokens one by one (across the
    window's wrap at P = 20); each step's logits equal forward's over the
    whole sequence at that position."""
    cfg = reduced(get_config(ARCH))
    m = build_model(cfg)
    p = m.init(torch.Generator().manual_seed(0), device="cpu")
    T = 6
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


def test_stage_composition_equals_full_forward():
    """Layers [0, 2) then [2, L) (a stage that starts on an attention
    layer) reproduce the full forward (test_splitcompute.py:15)."""
    from repro_torch.models.hybrid import run_layers
    from repro_torch.models.transformer import head_out
    cfg = reduced(get_config(ARCH))
    m = build_model(cfg)
    p = m.init(torch.Generator().manual_seed(0), device="cpu")
    toks = _t(tokens(7, B, 16))
    full = m.forward(p, {"tokens": toks})[0]
    h = p.embed[toks].to(torch.bfloat16)
    pos = torch.arange(16, dtype=torch.int32)[None].expand(B, 16)
    for a, b in [(0, 2), (2, cfg.num_layers)]:
        h, _ = run_layers(p.layers[a:b], cfg, h, pos, mode="train", start=a)
    assert torch.equal(head_out(p, cfg, h), full)


def test_init_follows_the_reference_formulas():
    cfg = reduced(get_config(ARCH))
    p = build_model(cfg).init(torch.Generator().manual_seed(0), device="cpu")
    assert len(p.layers) == 5 and p.lm_head is None
    rec = p.layers[0]["mixer"]
    u = torch.sigmoid(rec["lam"]) ** cfg.hybrid.c      # a^c = u
    assert float(u.min()) >= 0.9 - 1e-5 and float(u.max()) <= 0.999 + 1e-5
    assert rec["gate_a"].shape == (16, 4, 4)
    assert torch.equal(rec["conv_b"], torch.zeros(64))
    assert set(p.layers[2]["mixer"].keys()) == {"wq", "wk", "wv", "wo"}


def test_model_init_needs_cuda_by_default():
    if torch.cuda.is_available():
        pytest.skip("this machine has CUDA: the default device is valid")
    m = build_model(reduced(get_config(ARCH)))
    with pytest.raises(RuntimeError, match="CUDA"):
        m.init(torch.Generator().manual_seed(0))
    with pytest.raises(RuntimeError, match="CUDA"):
        m.init_cache(1, 8)


def test_unported_families_still_raise():
    """Every family of the JAX package is ported (whisper-medium's encdec
    since); a family that no package has still raises."""
    other = dataclasses.replace(reduced(get_config(ARCH)), family="nope")
    with pytest.raises(NotImplementedError, match="no model family"):
        build_model(other)
    assert build_model(get_config("whisper-medium")).cfg.family == "encdec"


@pytest.mark.cuda
def test_reduced_model_on_card_matches_cpu():
    """The reduced recurrentgemma on the card, through the rmsnorm,
    rglru_scan and flash-attention kernels, against the same weights on the
    CPU (plain paths): prefill, then decode steps across the window's wrap,
    at the bf16 tolerance; one rglru_scan per recurrent layer, one flash
    launch per attention layer, one rmsnorm per norm."""
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
    kinds = layer_kinds(cfg)
    assert sum(launches["cpu"].values()) == 0
    assert launches["card"]["rglru_scan"] == kinds.count("rec")
    assert launches["card"]["flash_attention"] == kinds.count("attn")
    assert launches["card"]["rmsnorm"] == 2 * cfg.num_layers + 1
    assert_close(outs["card"], outs["cpu"], "bfloat16")
