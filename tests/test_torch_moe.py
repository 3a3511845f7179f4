"""The port's moe family (``repro_torch.models.moe`` and the moe layers of
``repro_torch.models.transformer``) against the JAX package's, on the CPU.

* ``_moe_shard`` on the same inputs (numpy, from a seed) and the same
  weights: the routing's integers and booleans (``gate_idx``, ``keep``,
  the slots, the inverse slot maps, ``moe_dropped``) equal, the floats at
  tests/test_torch_models.py's ``TOL``; in float32 and bfloat16,
  ``router_norm_topk`` on and off, with and without drops, at a prefill's
  and a decode step's token counts, and on inputs whose router logits tie
  on purpose (small multiples of powers of two, so every product and sum
  is exact in both libraries and the ties are exact ties).
* The reduced granite-moe and qwen3-moe forward, prefill and decode logits
  against JAX on the reference's bridged init.  In float32 every routing
  decision is equal and the logits within ``TOL``.  In bfloat16 the two
  libraries round some activations a bf16 ulp apart (as for the dense
  family), and a token whose k-th and (k+1)-th router logits lie within a
  few ulps of each other may then take another expert: a discontinuity of
  top-k routing, not a fault of either side.  The bf16 tests hold every
  token whose routes agree in every layer to ``TOL``, and require of every
  token whose routes differ that its reference top-(k+1) logits lie within
  ``FLIP_MARGIN`` of each other (4 bf16 ulps of the row's largest logit)
  and that such tokens stay few.  The reference runs its layers op by op
  (``scan_layers=False``, as tests/test_torch_hybrid.py does in bf16), so
  that the test can record its routing.
* ``param_count`` and ``active_param_count`` of all ten configurations,
  and the reference's ``cast_weights`` rule on the full-width moe leaves.
"""
import dataclasses

import numpy as np
import pytest

torch = pytest.importorskip("torch")
import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402
from test_torch_ssm import assert_close, build_pair, f32, tokens  # noqa: E402

from repro.configs import ARCHS as JARCHS  # noqa: E402
from repro.configs import get_config as jget_config  # noqa: E402
from repro.configs import reduced as jreduced  # noqa: E402
from repro.models import build_model as jbuild_model  # noqa: E402
from repro.models import moe as jmoe  # noqa: E402
from repro.models import transformer as jtf  # noqa: E402
from repro_torch.configs import get_config, reduced  # noqa: E402
from repro_torch.models import moe as tmoe  # noqa: E402
from repro_torch.models import transformer as ttf  # noqa: E402

torch.set_num_threads(1)
MOE_ARCHS = ("granite-moe-1b-a400m", "qwen3-moe-30b-a3b")
FLIP_MARGIN = 4 * 2.0 ** -7          # 4 bf16 ulps, relative to max |logit|
B, S = 2, 64


# ---------------------------------------------------------------------------
# configurations
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("arch", sorted(JARCHS))
def test_param_counts_match_reference(arch):
    want = jget_config(arch)
    if want.family == "encdec":
        with pytest.raises(NotImplementedError, match="ROADMAP"):
            get_config(arch)
        return
    got = get_config(arch)
    assert dataclasses.asdict(got) == dataclasses.asdict(want)
    assert got.param_count() == want.param_count()
    assert got.active_param_count() == want.active_param_count()
    assert dataclasses.asdict(reduced(got)) == dataclasses.asdict(
        jreduced(want))


def _meta_lm(tree, cfg):
    """The port's LM of the reference's parameter shapes ``tree`` (a
    pytree of ShapeDtypeStructs), on the meta device: no memory."""
    def leaf(s):
        return torch.empty(s.shape, dtype=torch.float32, device="meta")

    layers = [torch.nn.ModuleDict({
        name: torch.nn.ParameterDict({
            k: torch.nn.Parameter(leaf(v)[0], requires_grad=False)
            for k, v in sub.items()})
        for name, sub in tree["layers"].items()})
        for _ in range(cfg.num_layers)]
    return ttf.LM(cfg, leaf(tree["embed"]), layers, torch.nn.ParameterDict({
        k: torch.nn.Parameter(leaf(v), requires_grad=False)
        for k, v in tree["final_norm"].items()}))


@pytest.mark.parametrize("arch", MOE_ARCHS)
def test_cast_weights_rule_on_full_width_moe_leaves(arch):
    """The reference casts a stacked leaf of >= 1M elements: granite's
    router ([24, 1024, 32], 786,432) stays f32 while qwen3-moe's ([48,
    2048, 128]) is cast, and the experts of both are cast; the port casts
    the same leaves."""
    jcfg = dataclasses.replace(jget_config(arch), cast_weights_bf16=True)
    shapes = jax.eval_shape(jbuild_model(jcfg).init, jax.random.PRNGKey(0))
    want = jax.eval_shape(lambda p: jtf.cast_weights(p, jcfg), shapes)
    tcfg = dataclasses.replace(get_config(arch), cast_weights_bf16=True)
    got = ttf.cast_weights(_meta_lm(shapes, tcfg), tcfg)
    for name, sub in want["layers"].items():
        for k, v in sub.items():
            assert got.layers[0][name][k].dtype == (
                torch.bfloat16 if v.dtype == jnp.bfloat16
                else torch.float32), (name, k)
    router = want["layers"]["moe"]["router"].dtype
    assert router == (jnp.float32 if arch.startswith("granite")
                      else jnp.bfloat16)
    assert want["layers"]["moe"]["w_up"].dtype == jnp.bfloat16


# ---------------------------------------------------------------------------
# the MoE block
# ---------------------------------------------------------------------------


def _jax_routing(x2d, router_w, cfg):
    """The routing and slot lines of the reference's ``_moe_shard``
    (``repro/models/moe.py:70-103``, one shard), returning what that
    function keeps to itself."""
    m = cfg.moe
    T = x2d.shape[0]
    E, k = m.num_experts, m.experts_per_token
    logits = (x2d @ router_w.astype(x2d.dtype)).astype(jnp.float32)
    probs = jax.nn.softmax(logits, axis=-1)
    gate_vals, gate_idx = jax.lax.top_k(probs, k)
    if m.router_norm_topk:
        gate_vals = gate_vals / jnp.sum(gate_vals, axis=-1, keepdims=True)
    A = T * k
    eid = gate_idx.reshape(A)
    tok = jnp.repeat(jnp.arange(T, dtype=jnp.int32), k)
    oh = eid[:, None] == jnp.arange(E, dtype=jnp.int32)[None, :]
    pos = jnp.take_along_axis(jnp.cumsum(oh.astype(jnp.int32), axis=0) - 1,
                              eid[:, None], axis=1)[:, 0]
    C = max(1, int(np.ceil(A / E * m.capacity_factor)))
    keep = pos < C
    slot = jnp.where(keep, eid * C + pos, E * C)
    slot_tok = jnp.zeros((E * C + 1,), jnp.int32).at[slot].set(tok)[:E * C]
    slot_ok = jnp.zeros((E * C + 1,), jnp.bool_).at[slot].set(True)[:E * C]
    return dict(logits=logits, probs=probs, gate_vals=gate_vals,
                gate_idx=gate_idx, keep=keep, slot=slot, slot_tok=slot_tok,
                slot_ok=slot_ok, C=C)


def _block_inputs(case, T, cfg, seed=0):
    """(x2d [T, d], {router, w_gate, w_up, w_down}) as float32 numpy."""
    rng = np.random.default_rng(seed)
    m, d = cfg.moe, cfg.d_model
    E, ff = m.num_experts, m.d_ff_expert
    w = {"w_gate": rng.standard_normal((E, d, ff)) / np.sqrt(d),
         "w_up": rng.standard_normal((E, d, ff)) / np.sqrt(d),
         "w_down": rng.standard_normal((E, ff, d)) / np.sqrt(ff)}
    if case == "ties":
        # multiples of 1/8 up to 16 in magnitude: exact in bf16 and f32,
        # whatever order a matmul sums in, so equal logits are equal
        x = rng.integers(-2, 3, (T, d)) * 0.5
        w["router"] = rng.integers(-1, 2, (d, E)) * 0.25
    else:
        x = rng.standard_normal((T, d))
        w["router"] = rng.standard_normal((d, E)) / np.sqrt(d)
    return x.astype(np.float32), {k: v.astype(np.float32)
                                  for k, v in w.items()}


def _moe_cfg(arch, cd, norm_topk, case):
    """The reduced config with E = 8 experts and top-3 (so ties inside and
    at the edge of the top k both occur); capacity factor 0.5 where the
    case drops, E (never drops) otherwise."""
    jcfg = jreduced(jget_config(arch))
    moe = dataclasses.replace(
        jcfg.moe, num_experts=8, experts_per_token=3,
        router_norm_topk=norm_topk,
        capacity_factor=0.5 if case == "drops" else 8.0)
    jcfg = dataclasses.replace(jcfg, moe=moe, compute_dtype=cd)
    tcfg = dataclasses.replace(reduced(get_config(arch)),
                               moe=dataclasses.replace(
                                   reduced(get_config(arch)).moe,
                                   **dataclasses.asdict(moe)),
                               compute_dtype=cd)
    return jcfg, tcfg


@pytest.mark.parametrize("case", ["random", "drops", "ties"])
@pytest.mark.parametrize("norm_topk", [True, False])
@pytest.mark.parametrize("cd", ["float32", "bfloat16"])
@pytest.mark.parametrize("T", [128, 4])
def test_moe_block_matches_reference(T, cd, norm_topk, case):
    jcfg, tcfg = _moe_cfg("granite-moe-1b-a400m", cd, norm_topk, case)
    x, w = _block_inputs(case, T, tcfg, seed=T)
    jdt = jnp.bfloat16 if cd == "bfloat16" else jnp.float32
    tdt = getattr(torch, cd)
    xj, xt = jnp.asarray(x).astype(jdt), torch.from_numpy(x).to(tdt)
    names = ("router", "w_gate", "w_up", "w_down")
    wj = [jnp.asarray(w[n]) for n in names]
    wt = [torch.from_numpy(w[n]) for n in names]

    want = _jax_routing(xj, wj[0], jcfg)
    probs, gate_vals, gate_idx = tmoe.route(xt, wt[0], tcfg)
    C = tmoe.capacity(tcfg, T)
    keep, slot = tmoe.slots(gate_idx, tcfg, C)
    E = tcfg.moe.num_experts
    slot_tok, slot_ok = tmoe.inverse_maps(slot, tcfg.moe.experts_per_token,
                                          E * C)
    assert C == want["C"]
    np.testing.assert_array_equal(gate_idx.numpy(), want["gate_idx"])
    np.testing.assert_array_equal(keep.numpy(), want["keep"])
    np.testing.assert_array_equal(slot.numpy(), want["slot"])
    np.testing.assert_array_equal(slot_tok.numpy(), want["slot_tok"])
    np.testing.assert_array_equal(slot_ok.numpy(), want["slot_ok"])
    assert_close(probs, want["probs"], "float32")
    assert_close(gate_vals, want["gate_vals"], "float32")
    if case == "ties" and T > 4:
        # the case does what it is for: ties inside the top k and at its
        # edge, resolved lower expert first
        lg = np.asarray(want["logits"])
        srt = -np.sort(-lg, axis=-1)
        k = tcfg.moe.experts_per_token
        assert (srt[:, :k - 1] == srt[:, 1:k]).any()
        assert (srt[:, k - 1] == srt[:, k]).any()
    if case == "drops":
        assert not want["keep"].all()

    yj, auxj, dropj = jmoe._moe_shard(xj, *wj, jcfg, shard_id=0, n_shards=1)
    yt, auxt, dropt = tmoe._moe_shard(xt, *wt, tcfg)
    assert yt.dtype == tdt
    assert float(dropt) == float(dropj)
    assert_close(auxt, auxj, "float32")
    assert_close(yt, yj, cd)


def test_combine_is_the_same_from_call_to_call():
    """The combine sums each token's contributions in expert order: two
    calls give equal bits (on the card this is what index_add_ would not
    give)."""
    _, tcfg = _moe_cfg("granite-moe-1b-a400m", "float32", True, "drops")
    x, w = _block_inputs("random", 96, tcfg, seed=3)
    args = [torch.from_numpy(x)] + [torch.from_numpy(w[n]) for n in (
        "router", "w_gate", "w_up", "w_down")]
    a = tmoe._moe_shard(*args, tcfg)
    b = tmoe._moe_shard(*args, tcfg)
    for u, v in zip(a, b, strict=True):
        assert torch.equal(u, v)


# ---------------------------------------------------------------------------
# the reduced models
# ---------------------------------------------------------------------------


class Routes:
    """Records every routing decision of a forward, prefill or decode step
    of both packages: the port's ``moe.route``, and the reference's routing
    recomputed from the arguments of each ``_moe_shard`` call."""

    def __init__(self, monkeypatch, jcfg):
        self.j, self.t = [], []
        j_shard, t_route = jmoe._moe_shard, tmoe.route

        def j_rec(x2d, router_w, *a, **kw):
            r = _jax_routing(x2d, router_w, jcfg)
            self.j.append((np.asarray(r["gate_idx"]),
                           np.asarray(r["logits"])))
            return j_shard(x2d, router_w, *a, **kw)

        def t_rec(x2d, router_w, cfg):
            out = t_route(x2d, router_w, cfg)
            self.t.append(out[2].numpy())
            return out

        monkeypatch.setattr(jmoe, "_moe_shard", j_rec)
        monkeypatch.setattr(tmoe, "route", t_rec)

    def take(self, rows: int):
        """(flipped [rows] bool, reference margins of the flipped rows)
        over the calls recorded since the last take; clears them."""
        assert len(self.j) == len(self.t) > 0
        flip = np.zeros(rows, bool)
        margins = []
        for (jidx, lg), tidx in zip(self.j, self.t, strict=True):
            assert jidx.shape == tidx.shape == (rows, jidx.shape[1])
            f = (jidx != tidx).any(-1)
            k = jidx.shape[1]
            top = -np.sort(-lg[f], axis=-1)[:, :k + 1]
            gap = np.diff(-top, axis=-1).min(-1) if f.any() else top[:, 0]
            margins.extend(gap / np.abs(lg[f]).max(-1))
            flip |= f
        self.j.clear()
        self.t.clear()
        return flip, np.asarray(margins)


def check_logits(got, want, routes: Routes, cd: str) -> None:
    """Logits [..., V] against the reference's under the rule of the module
    docstring: in float32 every route equal, in bfloat16 flips only at
    near-ties, few, and every other token within ``TOL``."""
    got, want = f32(got), f32(want)
    rows = int(np.prod(want.shape[:-1]))
    flip, margins = routes.take(rows)
    if cd == "float32":
        assert not flip.any()
    else:
        assert (margins <= FLIP_MARGIN).all(), margins
        assert flip.sum() <= max(1, rows // 20), flip.sum()
    keep = ~flip
    assert_close(got.reshape(rows, -1)[keep], want.reshape(rows, -1)[keep],
                 cd)


@pytest.fixture(scope="module", params=[(a, cd) for a in MOE_ARCHS
                                        for cd in ("float32", "bfloat16")],
                ids=lambda p: f"{p[0]}-{p[1]}")
def pair(request):
    """The reference runs op by op (``scan_layers=False``, no remat), so
    that its routing decisions are concrete arrays the test can record."""
    arch, cd = request.param
    jcfg, _, jp, tcfg, tm, tp = build_pair(arch, cd, scan_layers=False)
    jcfg = dataclasses.replace(jcfg, remat_policy="none")
    return cd, jcfg, jbuild_model(jcfg), jp, tcfg, tm, tp


def test_forward_logits_and_aux_match_jax(pair, monkeypatch):
    cd, jcfg, jm, jp, tcfg, tm, tp = pair
    routes = Routes(monkeypatch, jcfg)
    toks = tokens(0, B, S)
    want, _, jaux = jm.forward(jp, {"tokens": jnp.asarray(toks)})
    got, caches, aux = tm.forward(tp, {"tokens": torch.from_numpy(
        toks).long()})
    assert caches is None and set(aux) == {"moe_aux", "moe_dropped"}
    # the reduced configs never drop (capacity factor = E)
    assert float(aux["moe_dropped"]) == float(jaux["moe_dropped"]) == 0.0
    if cd == "float32":
        assert_close(aux["moe_aux"], jaux["moe_aux"], cd)
    check_logits(got, want, routes, cd)


def test_prefill_matches_jax(pair, monkeypatch):
    cd, jcfg, jm, jp, tcfg, tm, tp = pair
    routes = Routes(monkeypatch, jcfg)
    toks = tokens(1, B, S)
    jlast, jc = jm.prefill(jp, {"tokens": jnp.asarray(toks)})
    tlast, tc = tm.prefill(tp, {"tokens": torch.from_numpy(toks).long()})
    assert tuple(tc["k"].shape) == tuple(jc["k"].shape)
    flip, _ = routes.take(B * S)
    if not flip.any():
        for name in ("k", "v"):
            assert_close(tc[name], jc[name], cd)
    last = flip.reshape(B, S)[:, -1]
    assert_close(f32(tlast)[~last], f32(jlast)[~last], cd)


def test_decode_replay_matches_jax(pair, monkeypatch):
    cd, jcfg, jm, jp, tcfg, tm, tp = pair
    routes = Routes(monkeypatch, jcfg)
    n = 10
    toks = tokens(2, B, n)
    jc, tc = jm.init_cache(B, n), tm.init_cache(B, n, device="cpu")
    for t in range(n):
        jl, jc = jm.decode_step(jp, jc, {"token": jnp.asarray(
            toks[:, t:t + 1]), "pos": jnp.int32(t)})
        tl, tc = tm.decode_step(tp, tc, {"token": torch.from_numpy(
            toks[:, t:t + 1]).long(), "pos": t})
        check_logits(tl, jl, routes, cd)
