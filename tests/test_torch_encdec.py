"""The port's encoder-decoder (``repro_torch.models.encdec``, whisper-medium)
against the JAX package's, on the CPU, on ``reduced(whisper-medium)`` (2 +
2 layers, 24 source frames) with the reference's own init bridged across.

Tolerances, the repo's rules: in float32 compute the logits at rtol 1e-4
/ atol 1e-5, the loss at rtol 1e-5 and every gradient leaf within 1e-4 of
its largest entry (the two libraries sum products in other orders, and
their exp, tanh and rsqrt differ in the last bits); in bfloat16 compute
rtol 2e-2 and atol 2e-2 scaled by max(1, max|x|) of the reference value
(tests/test_torch_models.py's ``TOL``).  Decode runs from the reference's
prefill caches bridged across, the self K/V padded into a longer cache
(the reference's own test never decodes after an encdec prefill; its
``decode_step`` would clamp a position past its cache, the port's
raises).
"""
import dataclasses

import numpy as np
import pytest

torch = pytest.importorskip("torch")
import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from repro.configs import get_config as jget_config  # noqa: E402
from repro.configs import reduced as jreduced  # noqa: E402
from repro.launch.step import init_train_state as jinit_train_state  # noqa: E402,E501
from repro.launch.step import make_train_step as jmake_train_step  # noqa: E402
from repro.models import build_model as jbuild_model  # noqa: E402
from repro.models.transformer import cast_weights as jcast_weights  # noqa: E402
from repro.optim import OptConfig as JOptConfig  # noqa: E402
from repro_torch import bridge  # noqa: E402
from repro_torch.configs import get_config, reduced  # noqa: E402
from repro_torch.launch.step import make_train_step, trainable  # noqa: E402
from repro_torch.models import build_model  # noqa: E402
from repro_torch.models.encdec import EncDec  # noqa: E402
from repro_torch.optim import OptConfig  # noqa: E402

torch.set_num_threads(1)
ARCH = "whisper-medium"
TOL = {"float32": dict(rtol=1e-4, atol=1e-5),
       "bfloat16": dict(rtol=2e-2, atol=2e-2)}
B, S = 2, 16
PAD = 8            # decode slots past the prompt


def _f32(x) -> np.ndarray:
    if torch.is_tensor(x):
        return x.detach().float().cpu().numpy()
    return np.asarray(x, np.float32)


def assert_close(got, want, cd: str, what: str = "") -> None:
    got, want = _f32(got), _f32(want)
    tol = dict(TOL[cd])
    if cd == "bfloat16":
        tol["atol"] *= max(1.0, float(np.abs(want).max()))
    np.testing.assert_allclose(got, want, **tol, err_msg=what)


def _leaves_close(got: dict, want: dict, cd: str, frac=1e-4) -> None:
    """Each leaf within ``frac`` of the reference leaf's largest entry
    (float32), or the bf16 rule.  The key biases' exact gradient is zero
    (a bias on every key of a row shifts its scores by one constant, which
    the softmax drops), so both packages return rounding noise there:
    those leaves are held within ``frac`` of the largest gradient entry of
    their attention's key weights instead."""
    flat_g = jax.tree_util.tree_flatten_with_path(got)[0]
    flat_w = dict(jax.tree_util.tree_flatten_with_path(want)[0])
    by_name = {jax.tree_util.keystr(p): v for p, v in flat_w.items()}
    assert len(flat_g) == len(flat_w)
    for path, g in flat_g:
        w, g = np.asarray(flat_w[path], np.float32), np.asarray(g, np.float32)
        what = jax.tree_util.keystr(path)
        if cd == "float32":
            ref = w
            if what.endswith("['bk']"):
                ref = np.asarray(by_name[what[:-6] + "['wk']"], np.float32)
                assert np.abs(w).max() <= frac * np.abs(ref).max(), what
            scale = float(np.abs(ref).max())
            assert np.abs(g - w).max() <= frac * scale + 1e-12, (
                f"{what}: {np.abs(g - w).max()} > {frac} of {scale}")
        else:
            assert_close(g, w, cd, what)


@pytest.fixture(scope="module")
def tree():
    jcfg = jreduced(jget_config(ARCH))
    return jax.tree.map(np.asarray, jbuild_model(jcfg).init(
        jax.random.PRNGKey(0)))


def _cfgs(cd: str, **kw):
    return (dataclasses.replace(jreduced(jget_config(ARCH)),
                                compute_dtype=cd, **kw),
            dataclasses.replace(reduced(get_config(ARCH)), compute_dtype=cd,
                                **kw))


def _batch(cfg, seed=0, s=S):
    g = np.random.default_rng(seed)
    F = cfg.encdec.source_positions
    toks = g.integers(0, cfg.vocab_size, (B, s + 1)).astype(np.int32)
    return {"enc_embeds": g.standard_normal((B, F, cfg.d_model)).astype(
        np.float32), "tokens": toks[:, :-1], "labels": toks[:, 1:]}


def _jb(batch):
    return {k: jnp.asarray(v) for k, v in batch.items()}


def _tb(batch):
    return {k: torch.from_numpy(v) for k, v in batch.items()}


def test_configs_and_param_count_match_reference():
    for t, j in ((get_config(ARCH), jget_config(ARCH)),
                 (reduced(get_config(ARCH)), jreduced(jget_config(ARCH)))):
        assert dataclasses.asdict(t) == dataclasses.asdict(j)
        assert t.param_count() == j.param_count()
    assert reduced(get_config(ARCH)).encdec.encoder_layers == 2
    assert build_model(get_config(ARCH)).cfg.family == "encdec"


def test_params_round_trip_and_init_layout(tree):
    """The reference's tree through the bridge and back is exact; the
    port's own init has the reference's leaves, names and shapes."""
    cfg = reduced(get_config(ARCH))
    params = bridge.params_from_numpy(tree, cfg, device="cpu")
    assert isinstance(params, EncDec)
    back = bridge.params_to_numpy(params)
    flat = dict(jax.tree_util.tree_flatten_with_path(tree)[0])
    got = jax.tree_util.tree_flatten_with_path(back)[0]
    assert len(got) == len(flat)
    for path, a in got:
        assert np.array_equal(a, flat[path]), jax.tree_util.keystr(path)
    own = build_model(cfg).init(torch.Generator().manual_seed(0),
                                device="cpu")
    mine = jax.tree.map(np.shape, bridge.params_to_numpy(own))
    assert mine == jax.tree.map(np.shape, tree)


@pytest.mark.parametrize("cd", ["float32", "bfloat16"])
def test_forward_logits_match_jax(tree, cd):
    jcfg, tcfg = _cfgs(cd)
    batch = _batch(tcfg)
    jlogits = jbuild_model(jcfg).forward(jax.tree.map(jnp.asarray, tree),
                                         _jb(batch))[0]
    params = bridge.params_from_numpy(tree, tcfg, device="cpu")
    with torch.no_grad():
        logits = build_model(tcfg).forward(params, _tb(batch))[0]
    assert logits.dtype == (torch.float32 if cd == "float32"
                            else torch.bfloat16)
    assert_close(logits, jlogits, cd)


@pytest.mark.parametrize("cd", ["float32", "bfloat16"])
def test_loss_and_grads_match_jax(tree, cd):
    """``Model.loss`` and every gradient leaf against
    ``jax.value_and_grad(model.loss)``, through the reference's remat."""
    jcfg, tcfg = _cfgs(cd)
    batch = _batch(tcfg, seed=1)
    (jloss, _), jgrads = jax.value_and_grad(
        jbuild_model(jcfg).loss, has_aux=True)(
            jax.tree.map(jnp.asarray, tree), _jb(batch))
    params = trainable(bridge.params_from_numpy(tree, tcfg, device="cpu"))
    names, leaves = zip(*params.named_parameters())
    loss, met = build_model(tcfg).loss(params, _tb(batch))
    grads = torch.autograd.grad(loss, leaves, allow_unused=True)
    grads = {n: torch.zeros_like(p) if g is None else g
             for n, p, g in zip(names, leaves, grads)}
    loss = loss.detach()
    np.testing.assert_allclose(float(loss), float(jloss),
                               rtol=1e-5 if cd == "float32" else 2e-2)
    assert float(met["loss"].detach()) == float(loss)
    _leaves_close(bridge.grads_to_numpy(grads, tcfg),
                  jax.tree.map(np.asarray, jgrads), cd)


def _prefills(tree, cd):
    jcfg, tcfg = _cfgs(cd)
    batch = _batch(tcfg, seed=2)
    jb = _jb(batch)
    del jb["labels"]
    jlast, jcaches = jbuild_model(jcfg).prefill(
        jax.tree.map(jnp.asarray, tree), jb)
    params = bridge.params_from_numpy(tree, tcfg, device="cpu")
    tb = _tb(batch)
    del tb["labels"]
    with torch.no_grad():
        last, caches = build_model(tcfg).prefill(params, tb)
    return jcfg, tcfg, params, batch, (jlast, jcaches), (last, caches)


@pytest.mark.parametrize("cd", ["float32", "bfloat16"])
def test_prefill_last_logits_and_caches_match_jax(tree, cd):
    _, tcfg, _, _, (jlast, jcaches), (last, caches) = _prefills(tree, cd)
    L, F = tcfg.num_layers, tcfg.encdec.source_positions
    assert [tuple(c.shape) for c in caches] == [
        (L, B, S, tcfg.num_kv_heads, tcfg.head_dim_)] * 2 + [
        (L, B, F, tcfg.num_kv_heads, tcfg.head_dim_)] * 2
    assert_close(last, jlast, cd, "last logits")
    for i, (c, j) in enumerate(zip(bridge.caches_to_numpy(caches, tcfg),
                                   jcaches)):
        assert_close(c, j, cd, f"cache {i}")


@pytest.mark.parametrize("cd", ["float32", "bfloat16"])
def test_decode_steps_match_jax_from_bridged_caches(tree, cd):
    """The reference's prefill caches, the self K/V padded into S + PAD
    slots, bridged to the port; then greedy decode steps at S, S + 1, ...
    in both packages from the same tokens: each step's logits and the
    updated caches."""
    jcfg, tcfg, params, batch, (jlast, jcaches), _ = _prefills(tree, cd)
    padded = tuple(np.asarray(c.astype(jnp.float32)) for c in jcaches)
    padded = tuple(np.pad(c, ((0, 0), (0, 0), (0, PAD), (0, 0), (0, 0)))
                   if i < 2 else c for i, c in enumerate(padded))
    jc = tuple(jnp.asarray(c).astype(jcaches[0].dtype) for c in padded)
    caches = bridge.caches_from_numpy(padded, tcfg, device="cpu")
    assert all(c.dtype == caches[0].dtype for c in caches)
    jmodel, model = jbuild_model(jcfg), build_model(tcfg)
    jparams = jax.tree.map(jnp.asarray, tree)
    tok = np.argmax(np.asarray(jlast, np.float32), -1).astype(np.int32)
    for pos in range(S, S + 3):
        jlog, jc = jmodel.decode_step(jparams, jc, {
            "token": jnp.asarray(tok[:, None]), "pos": jnp.int32(pos)})
        with torch.no_grad():
            log, caches = model.decode_step(params, caches, {
                "token": torch.from_numpy(tok[:, None]), "pos": pos})
        assert_close(log, jlog, cd, f"logits at {pos}")
        tok = np.argmax(np.asarray(jlog, np.float32), -1).astype(np.int32)
    for i, (c, j) in enumerate(zip(bridge.caches_to_numpy(caches, tcfg),
                                   jc)):
        assert_close(c, j, cd, f"cache {i} after decoding")


def test_decode_past_the_cache_raises(tree):
    cfg = reduced(get_config(ARCH))
    model = build_model(cfg)
    params = bridge.params_from_numpy(tree, cfg, device="cpu")
    caches = model.init_cache(B, 4, device="cpu")
    tok = torch.zeros((B, 1), dtype=torch.int64)
    with torch.no_grad():
        model.decode_step(params, caches, {"token": tok, "pos": 3})
        with pytest.raises(IndexError, match="clamp"):
            model.decode_step(params, caches, {"token": tok, "pos": 4})
    assert [tuple(c.shape) for c in caches] == [
        (cfg.num_layers, B, 4, cfg.num_kv_heads, cfg.head_dim_)] * 2 + [
        (cfg.num_layers, B, cfg.encdec.source_positions, cfg.num_kv_heads,
         cfg.head_dim_)] * 2


def test_cast_weights_follow_the_reference_rule():
    """With the lever on, on a reduced whisper widened so that stacked
    leaves pass the reference's 1M-element rule while one layer's slice
    does not (the MLP weights: 2 x 256 x 2048): the port casts exactly
    the leaves the reference's ``cast_weights`` casts, to the same values,
    and the forward on the cast leaves equals the lever-off forward (one
    round-to-nearest cast, whenever it happens)."""
    wide = dict(d_model=256, d_ff=2048, vocab_size=4096)
    jcfg, tcfg = _cfgs("bfloat16", cast_weights_bf16=True, **wide)
    jtree = jbuild_model(jcfg).init(jax.random.PRNGKey(1))
    jcast = jcast_weights(jtree, jcfg)
    tree = jax.tree.map(np.asarray, jtree)
    params = bridge.params_from_numpy(tree, tcfg, device="cpu")
    model = build_model(tcfg)
    cast = model.cast_weights(params)
    got = {n: p for n, p in cast.named_parameters()}
    want = bridge.named_from_tree(jax.tree.map(
        lambda x: np.asarray(x.astype(jnp.float32)), jcast), tcfg,
        device="cpu")
    jdt = dict(zip(
        (n for n, _ in params.named_parameters()),
        (x.dtype for x in _named_leaves_ordered(jcast, tcfg))))
    n_cast = 0
    for n, p in got.items():
        is_bf16 = jdt[n] == jnp.bfloat16
        assert (p.dtype == torch.bfloat16) == is_bf16, n
        n_cast += is_bf16
        assert torch.equal(p.float(), want[n]), n
    assert n_cast >= 3 and got["enc_layers.0.mlp.w_up"].dtype == \
        torch.bfloat16
    assert model.cast_weights(cast) is cast
    batch = _tb(_batch(tcfg, seed=3))
    with torch.no_grad():
        on = model.forward(cast, batch)[0]
        off = model.forward(params, batch)[0]
    assert torch.equal(on, off)


def _named_leaves_ordered(jtree, cfg):
    """The reference tree's leaves in the port's parameter order."""
    named = bridge.named_from_tree(jax.tree.map(
        lambda x: np.zeros(x.shape, np.float32), jtree), cfg, device="cpu")
    paths = {}
    for stack in ("enc_layers", "dec_layers"):
        for sub, leaves in jtree[stack].items():
            for k, x in leaves.items():
                for i in range(x.shape[0]):
                    paths[f"{stack}.{i}.{sub}.{k}"] = x
    for k in ("embed", "enc_pos", "dec_pos"):
        paths[k] = jtree[k]
    for norm in ("enc_norm", "dec_norm"):
        for k, x in jtree[norm].items():
            paths[f"{norm}.{k}"] = x
    return [paths[n] for n in named]


def test_train_steps_match_jax(tree):
    """Two ``make_train_step`` steps from the bridged train state on
    batches that carry ``enc_embeds`` (float32): each step's loss and grad
    norm against the reference's, then m, v and the parameters."""
    jcfg, tcfg = _cfgs("float32")
    ocfg = dict(lr=3e-3, warmup_steps=2, total_steps=6)
    jstate = jinit_train_state(jbuild_model(jcfg), jax.random.PRNGKey(0))
    state = bridge.train_state_from_numpy(
        jax.tree.map(np.asarray, jstate), tcfg, device="cpu")
    jstep = jmake_train_step(jbuild_model(jcfg), JOptConfig(**ocfg))
    step = make_train_step(build_model(tcfg), OptConfig(**ocfg))
    lr_sum = 0.0
    for s in range(2):
        b = _batch(tcfg, seed=10 + s)
        jstate, jm = jstep(jstate, _jb(b))
        state, m = step(state, _tb(b))
        np.testing.assert_allclose(float(m["loss"]), float(jm["loss"]),
                                   rtol=1e-5)
        np.testing.assert_allclose(float(m["grad_norm"]),
                                   float(jm["grad_norm"]), rtol=1e-4)
        lr_sum += float(jm["lr"])
    got = bridge.train_state_to_numpy(state)
    want = jax.tree.map(np.asarray, jstate)
    _leaves_close(got["opt"]["m"], want.opt.m, "float32")
    _leaves_close(got["opt"]["v"], want.opt.v, "float32")
    # Adam divides by sqrt(v): where a gradient is a sum of cancelling
    # terms its last bits set the sign of an update of size lr, so the
    # parameters are held to 1 % of the summed lr; the key biases, whose
    # gradient is all rounding noise (``_leaves_close``), take updates of
    # either sign, each at most about lr, so they are held to twice it
    flat_w = dict(jax.tree_util.tree_flatten_with_path(want.params)[0])
    for path, g in jax.tree_util.tree_flatten_with_path(got["params"])[0]:
        noise = jax.tree_util.keystr(path).endswith("['bk']")
        np.testing.assert_allclose(
            g, flat_w[path], rtol=0,
            atol=(2.0 if noise else 1e-2) * lr_sum,
            err_msg=jax.tree_util.keystr(path))


def test_model_init_needs_cuda_by_default():
    if torch.cuda.is_available():
        pytest.skip("this machine has CUDA: the default device is valid")
    m = build_model(reduced(get_config(ARCH)))
    with pytest.raises(RuntimeError, match="CUDA"):
        m.init(torch.Generator().manual_seed(0))
    with pytest.raises(RuntimeError, match="CUDA"):
        m.init_cache(1, 8)
