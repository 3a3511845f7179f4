"""The ``cast_weights_bf16`` lever (``repro_torch.models.transformer.
cast_weights``) against the reference's ``cast_weights``, on the CPU.

* Leaf selection at full width equals the reference's, leaf for leaf: the
  reference's from ``jax.eval_shape`` of its init, the port's from an init
  on the meta device (nothing is allocated).  The reference judges its
  *stacked* leaves (``[L, ...]``, or ``[n_super, ...]`` and ``[tail,
  ...]`` for the hybrid), so the port counts the stack depth of its
  per-layer tensors.
* On widened reduced configs whose stacked leaves cross the 1M threshold
  while each layer's tensor does not, the port with the lever on matches
  JAX with the lever on, at the bf16 tolerance of tests/test_torch_ssm.py
  (the hybrid's reference runs with ``scan_layers=False``, as in
  tests/test_torch_hybrid.py).
* qwen3 and recurrentgemma read every cast leaf through ``.to(cd)``, so
  their logits are ``torch.equal`` with the lever on and off;
  falcon-mamba reads ``x_proj``, ``dt_proj`` and ``A_log`` in float32
  (``ssm_coeffs``), so a cast there changes its numbers, in the reference
  too, and only its parity with JAX is held.
* ``cast_weights`` twice is once, with no new tensors; the split-serve
  engine, which never casts (as the reference's), gives the same outputs
  with the lever on and off.
"""
import dataclasses

import numpy as np
import pytest

torch = pytest.importorskip("torch")
import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402
from test_torch_ssm import assert_close, tokens  # noqa: E402

from repro.configs import get_config as jget_config  # noqa: E402
from repro.configs import reduced as jreduced  # noqa: E402
from repro.models import build_model as jbuild_model  # noqa: E402
from repro.models.transformer import cast_weights as jcast  # noqa: E402
from repro_torch import bridge  # noqa: E402
from repro_torch.configs import get_config, reduced  # noqa: E402
from repro_torch.launch import serve as tserve  # noqa: E402
from repro_torch.models import build_model  # noqa: E402
from repro_torch.models.transformer import cast_weights  # noqa: E402

torch.set_num_threads(1)
ARCHS = ("qwen3-1.7b", "falcon-mamba-7b", "recurrentgemma-9b")
FULL_CAST = {"qwen3-1.7b": 8, "falcon-mamba-7b": 8, "recurrentgemma-9b": 32}
B = 2

# Widened reduced configs: each stacked leaf named here crosses 1M
# elements only with its stack depth (per layer it is below).
WIDE = {
    # w_gate/w_up/w_down: 512 x 1024 = 524,288 a layer, 2 layers
    "qwen3-1.7b": dict(d_model=512, d_ff=1024, num_layers=2),
    # x_proj 4096 x 160 = 655,360 and dt_proj 128 x 4096 = 524,288 a
    # layer, 2 layers: both read in float32
    "falcon-mamba-7b": dict(d_model=2048, num_layers=2),
    # the MLP, 524,288 a layer, stacked over n_super = 2 and tail = 2
    "recurrentgemma-9b": dict(d_model=512, d_ff=1024, num_layers=8),
}
STACK_ONLY = {"qwen3-1.7b": ("layers/mlp/w_gate",),
              "falcon-mamba-7b": ("layers/mamba/x_proj",
                                  "layers/mamba/dt_proj"),
              "recurrentgemma-9b": ("super/s0_rec/mlp/w_up",
                                    "tail/mlp/w_down")}


def _ref_cast_set(shapes) -> set:
    """Paths of the leaves the reference's ``cast_weights`` casts."""
    out = set()
    for path, x in jax.tree_util.tree_leaves_with_path(shapes):
        if (jnp.issubdtype(x.dtype, jnp.floating) and len(x.shape) >= 2
                and int(np.prod(x.shape)) >= 1_000_000):
            out.add("/".join(str(getattr(k, "key", k)) for k in path))
    return out


def _ref_paths(shapes) -> set:
    return {"/".join(str(getattr(k, "key", k)) for k in path)
            for path, _ in jax.tree_util.tree_leaves_with_path(shapes)}


def _port_path(name: str, cfg) -> str:
    """A port parameter name (``layers.7.mixer.w_in_x``) as the reference
    leaf path that holds it (``super/s1_rec/mixer/w_in_x``)."""
    parts = name.split(".")
    if parts[0] != "layers":
        return "/".join(parts)
    i, rest = int(parts[1]), parts[2:]
    if cfg.family != "hybrid":
        return "/".join(["layers"] + rest)
    pat = cfg.hybrid.pattern
    n_super = cfg.num_layers // len(pat)
    if i < n_super * len(pat):
        j = i % len(pat)
        return "/".join(["super", f"s{j}_{pat[j]}"] + rest)
    return "/".join(["tail"] + rest)


def _port_cast_sets(params, cast, cfg):
    """(paths some of whose tensors were cast, paths some of whose tensors
    were not), over the reference's leaf paths."""
    orig = dict(params.named_parameters())
    done, kept = set(), set()
    for name, x in cast.named_parameters():
        path = _port_path(name, cfg)
        if x is orig[name]:
            kept.add(path)
        else:
            assert x.dtype == torch.bfloat16 and orig[name].dtype == \
                torch.float32 and x.shape == orig[name].shape, name
            done.add(path)
    return done, kept


@pytest.mark.parametrize("arch", ARCHS)
def test_full_width_leaf_selection_equals_reference(arch):
    """No allocation: the reference's leaf shapes by ``jax.eval_shape``,
    the port's on the meta device."""
    jcfg = dataclasses.replace(jget_config(arch), cast_weights_bf16=True)
    shapes = jax.eval_shape(jbuild_model(jcfg).init, jax.random.PRNGKey(0))
    want = _ref_cast_set(shapes)
    assert len(want) == FULL_CAST[arch]
    cfg = dataclasses.replace(get_config(arch), cast_weights_bf16=True)
    params = build_model(cfg).init(torch.Generator(), device="meta")
    done, kept = _port_cast_sets(params, cast_weights(params, cfg), cfg)
    assert done == want and not done & kept
    assert done | kept == _ref_paths(shapes)
    if arch == "falcon-mamba-7b":
        # per layer each is below 1M; the reference casts them stacked
        assert {"layers/mamba/A_log", "layers/mamba/conv_w"} <= done
    if arch == "recurrentgemma-9b":
        assert "super/s0_rec/mixer/conv_w" in kept


def test_lever_off_returns_params_itself():
    cfg = reduced(get_config("qwen3-1.7b"))
    params = build_model(cfg).init(torch.Generator(), device="meta")
    assert cast_weights(params, cfg) is params
    assert build_model(cfg).cast_weights(params) is params


def _pair(arch: str, lever: bool):
    """(JAX cfg, JAX model, JAX params, port cfg, port model, port params)
    of the widened reduced ``arch`` in bf16 on the same weights."""
    jcfg = dataclasses.replace(jreduced(jget_config(arch)), **WIDE[arch],
                               cast_weights_bf16=lever,
                               scan_layers=arch != "recurrentgemma-9b")
    tcfg = dataclasses.replace(reduced(get_config(arch)), **WIDE[arch],
                               cast_weights_bf16=lever)
    jm = jbuild_model(jcfg)
    jp = jm.init(jax.random.PRNGKey(0))
    tp = bridge.params_from_numpy(jax.tree.map(np.asarray, jp), tcfg,
                                  device="cpu")
    return jcfg, jm, jp, tcfg, build_model(tcfg), tp


@pytest.fixture(scope="module", params=ARCHS)
def wide(request):
    return (request.param, *_pair(request.param, True))


def _t(toks):
    return torch.from_numpy(toks).long()


def test_widened_configs_cross_the_threshold_only_stacked(wide):
    arch, jcfg, _, jp, tcfg, _, tp = wide
    want = _ref_cast_set(jp)
    for path in STACK_ONLY[arch]:
        assert path in want, path
    done, _ = _port_cast_sets(tp, cast_weights(tp, tcfg), tcfg)
    assert done == want
    for name, x in tp.named_parameters():
        if _port_path(name, tcfg) in STACK_ONLY[arch]:
            assert x.numel() < 1_000_000, name


def test_lever_on_forward_and_prefill_match_jax(wide):
    arch, jcfg, jm, jp, tcfg, tm, tp = wide
    toks = tokens(0, B, 24)
    want = jm.forward(jp, {"tokens": jnp.asarray(toks)})[0]
    got = tm.forward(tp, {"tokens": _t(toks)})[0]
    assert got.dtype == torch.bfloat16
    assert_close(got, want, "bfloat16", what=f"{arch} forward")
    jlast, _ = jm.prefill(jp, {"tokens": jnp.asarray(toks)})
    tlast, _ = tm.prefill(tp, {"tokens": _t(toks)})
    assert_close(tlast, jlast, "bfloat16", what=f"{arch} prefill")


def test_lever_on_decode_with_cast_weights_matches_jax(wide):
    """Decode, which casts nothing itself in either package, on weights
    cast once: the port's ``Model.cast_weights`` against the reference's
    ``cast_weights``."""
    arch, jcfg, jm, jp, tcfg, tm, tp = wide
    jpc, tpc = jcast(jp, jcfg), tm.cast_weights(tp)
    if tcfg.family == "dense":          # replay from an empty cache
        S = 0
        jc, tc = jm.init_cache(B, 3), tm.init_cache(B, 3, device="cpu")
    else:                               # from the reference's prefill
        S = 16
        jl, jc = jm.prefill(jpc, {"tokens": jnp.asarray(tokens(2, B, S))})
        tl, _ = tm.prefill(tpc, {"tokens": _t(tokens(2, B, S))})
        assert_close(tl, jl, "bfloat16", what=f"{arch} prefill")
        tc = bridge.caches_from_numpy(jax.tree.map(np.asarray, jc), tcfg,
                                      device="cpu")
    nxt = tokens(3, B, 3)
    for t in range(3):
        tok = nxt[:, t:t + 1]
        jl, jc = jm.decode_step(jpc, jc, {"token": jnp.asarray(tok),
                                          "pos": jnp.int32(S + t)})
        tl, tc = tm.decode_step(tpc, tc, {"token": _t(tok), "pos": S + t})
        assert_close(tl, jl, "bfloat16", what=f"{arch} decode step {t}")


def _decode_caches(model, params, toks):
    """The prefill's caches, the dense k/v in a cache one slot longer."""
    _, caches = model.prefill(params, toks)
    if model.cfg.family != "dense":
        return caches
    S = toks["tokens"].shape[1]
    out = model.init_cache(B, S + 1, device="cpu")
    for name in ("k", "v"):
        out[name][:, :, :S] = caches[name]
    return out


@pytest.mark.parametrize("arch", ("qwen3-1.7b", "recurrentgemma-9b"))
def test_lever_on_equals_off_bit_for_bit(arch):
    """Every cast leaf is read through ``.to(cd)``, and one round-to-nearest
    cast gives the same bits whenever it happens: forward with the lever
    on, with the weights cast once, and with the lever off are equal."""
    _, _, _, on_cfg, on_model, params = _pair(arch, True)
    off_cfg = dataclasses.replace(on_cfg, cast_weights_bf16=False)
    off_model = build_model(off_cfg)
    toks = {"tokens": _t(tokens(4, B, 20))}
    off = off_model.forward(params, toks)[0]
    on = on_model.forward(params, toks)[0]
    once = on_model.cast_weights(params)
    assert torch.equal(on, off)
    assert torch.equal(on_model.forward(once, toks)[0], off)
    # decode reads the leaves it is given: cast once or not, same logits
    caches, caches2 = (_decode_caches(m, p, toks)
                       for m, p in ((off_model, params), (on_model, once)))
    step = {"token": _t(tokens(5, B, 1)), "pos": 20}
    assert torch.equal(on_model.decode_step(once, caches2, step)[0],
                       off_model.decode_step(params, caches, step)[0])


def test_falcon_mamba_lever_moves_its_numbers_as_in_jax():
    """Not an equality: falcon-mamba's float32 reads of the cast x_proj
    and dt_proj round them to bf16, in both packages alike."""
    jcfg, jm, jp, tcfg, tm, tp = _pair("falcon-mamba-7b", True)
    off_cfg = dataclasses.replace(tcfg, cast_weights_bf16=False)
    toks = tokens(6, B, 16)
    on = tm.forward(tp, {"tokens": _t(toks)})[0]
    off = build_model(off_cfg).forward(tp, {"tokens": _t(toks)})[0]
    jon = jm.forward(jp, {"tokens": jnp.asarray(toks)})[0]
    joff = jbuild_model(dataclasses.replace(
        jcfg, cast_weights_bf16=False)).forward(
            jp, {"tokens": jnp.asarray(toks)})[0]
    assert not torch.equal(on, off)
    assert not np.array_equal(np.asarray(jon.astype(jnp.float32)),
                              np.asarray(joff.astype(jnp.float32)))
    assert_close(on, jon, "bfloat16")
    assert_close(off, joff, "bfloat16")


def test_cast_twice_is_once_with_no_new_tensors(wide):
    arch, _, _, _, tcfg, tm, tp = wide
    once = cast_weights(tp, tcfg)
    assert cast_weights(once, tcfg) is once
    assert tm.cast_weights(once) is once
    orig = dict(tp.named_parameters())
    for name, x in once.named_parameters():
        if x.dtype == torch.float32:
            assert x is orig[name], name          # shared, not copied
        else:
            assert torch.equal(x, orig[name].to(torch.bfloat16)), name
    # the original tree is untouched
    assert all(x.dtype == torch.float32 for x in tp.parameters())


def test_split_serve_ignores_the_lever():
    """The reference's split-serve engine never calls ``cast_weights``, nor
    does the port's: counters, records and logits do not depend on it."""
    cfg = reduced(get_config("qwen3-1.7b"))
    params = build_model(cfg).init(torch.Generator().manual_seed(0),
                                   device="cpu")
    args = dict(requests=3, batch=2, seq=16, executors=3, burst=2,
                device="cpu", params=params)
    off = tserve.serve(cfg, **args)
    on = tserve.serve(dataclasses.replace(cfg, cast_weights_bf16=True),
                      **args)
    assert on.engine.stats.exit_counts == off.engine.stats.exit_counts
    assert np.array_equal(on.engine.stats.records, off.engine.stats.records)
    assert sorted(on.engine.results) == sorted(off.engine.results)
    for rid, lg in off.engine.results.items():
        assert torch.equal(on.engine.results[rid], lg), rid
