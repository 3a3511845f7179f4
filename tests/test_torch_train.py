"""Training in the port (``Model.loss``, its gradients, ``make_train_step``
and the restart driver) against the JAX package's, on the CPU, on reduced
configurations with the reference's own init bridged across.

Tolerances: in float32 compute the loss at rtol 1e-5 and every gradient
leaf within 1e-4 of its largest entry (the two libraries sum products in
other orders and their exp, log, rsqrt, sin and cos differ in the last
bits; a leaf's small entries are sums of cancelling terms, so each leaf is
held relative to its own scale).  In bfloat16 compute the repo's rule
(tests/test_torch_models.py's ``TOL``): rtol 2e-2, atol 2e-2 scaled by
max(1, max|x|) of the reference value.  Within the port, the three remat
policies give ``torch.equal`` losses and gradients (recomputation repeats
the same deterministic ops).
"""
import dataclasses
import tempfile

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
from repro.optim import OptConfig as JOptConfig  # noqa: E402
from repro_torch import bridge  # noqa: E402
from repro_torch.configs import get_config, reduced  # noqa: E402
from repro_torch.data import DataConfig, batch_at  # noqa: E402
from repro_torch.launch import train as train_mod  # noqa: E402
from repro_torch.launch.step import make_train_step, trainable  # noqa: E402
from repro_torch.models import build_model  # noqa: E402
from repro_torch.models.transformer import _casts, _named_leaves  # noqa: E402
from repro_torch.optim import OptConfig  # noqa: E402

torch.set_num_threads(1)
TOL = {"float32": dict(rtol=1e-4, atol=1e-5),
       "bfloat16": dict(rtol=2e-2, atol=2e-2)}
B, S = 2, 32
ARCHS = {"dense": "qwen3-1.7b", "moe": "granite-moe-1b-a400m",
         "vlm": "qwen2-vl-2b", "ssm": "falcon-mamba-7b",
         "hybrid": "recurrentgemma-9b"}


def _f32(x) -> np.ndarray:
    if torch.is_tensor(x):
        return x.detach().float().cpu().numpy()
    return np.asarray(x, np.float32)


def _leaves_close(got: dict, want: dict, cd: str, frac=1e-4) -> None:
    """Each leaf of two same-shaped numpy trees: within ``frac`` of the
    reference leaf's largest entry (float32), or the repo's bf16 rule."""
    flat_g = jax.tree_util.tree_flatten_with_path(got)[0]
    flat_w = dict(jax.tree_util.tree_flatten_with_path(want)[0])
    assert len(flat_g) == len(flat_w)
    for path, g in flat_g:
        w = np.asarray(flat_w[path], np.float32)
        g = np.asarray(g, np.float32)
        if cd == "float32":
            scale = float(np.abs(w).max())
            assert np.abs(g - w).max() <= frac * scale + 1e-12, (
                f"{jax.tree_util.keystr(path)}: {np.abs(g - w).max()} > "
                f"{frac} of {scale}")
        else:
            tol = dict(TOL[cd])
            tol["atol"] *= max(1.0, float(np.abs(w).max()))
            np.testing.assert_allclose(g, w, **tol,
                                       err_msg=jax.tree_util.keystr(path))


def _cfgs(arch: str, cd: str, **kw):
    jcfg = dataclasses.replace(jreduced(jget_config(arch)), compute_dtype=cd,
                               **kw)
    tcfg = dataclasses.replace(reduced(get_config(arch)), compute_dtype=cd,
                               **kw)
    return jcfg, tcfg


def _batch(cfg, seed=0, embeds=False):
    g = np.random.default_rng(seed)
    toks = g.integers(0, cfg.vocab_size, (B, S + 1)).astype(np.int32)
    b = {"labels": toks[:, 1:]}
    if embeds:
        b["embeds"] = g.standard_normal((B, S, cfg.d_model)).astype(
            np.float32)
    else:
        b["tokens"] = toks[:, :-1]
    return b


def _jax_loss_grads(jcfg, tree, batch):
    jmodel = jbuild_model(jcfg)
    jparams = jax.tree.map(jnp.asarray, tree)
    jb = {k: jnp.asarray(v) for k, v in batch.items()}
    (loss, metrics), grads = jax.value_and_grad(
        jmodel.loss, has_aux=True)(jparams, jb)
    return loss, metrics, jax.tree.map(np.asarray, grads)


def _port_loss_grads(tcfg, tree, batch):
    model = build_model(tcfg)
    params = trainable(bridge.params_from_numpy(tree, tcfg, device="cpu"))
    tb = {k: torch.from_numpy(v) for k, v in batch.items()}
    names, leaves = zip(*params.named_parameters())
    loss, metrics = model.loss(params, tb)
    grads = torch.autograd.grad(loss, leaves, allow_unused=True)
    grads = {n: torch.zeros_like(p) if g is None else g
             for n, p, g in zip(names, leaves, grads)}
    return loss.detach(), metrics, grads


@pytest.fixture(scope="module")
def inits():
    """The reference's init of each reduced configuration, as numpy."""
    out = {}
    for fam, arch in ARCHS.items():
        jcfg = jreduced(jget_config(arch))
        out[fam] = jax.tree.map(np.asarray, jbuild_model(jcfg).init(
            jax.random.PRNGKey(0)))
    return out


CASES = [(fam, cd) for fam in ARCHS for cd in ("float32", "bfloat16")
         if not (fam == "moe" and cd == "bfloat16")]


@pytest.mark.parametrize("fam,cd", CASES)
def test_loss_and_grads_match_jax(inits, fam, cd):
    """``Model.loss`` and every gradient leaf against
    ``jax.value_and_grad(model.loss)``.  moe runs in float32 only (in bf16
    a near tie of router logits may route a token elsewhere) and with an
    aux-loss weight of 0.01, so that the router's aux gradient is held
    too; the hybrid's bf16 reference runs without ``lax.scan`` (the rule
    of tests/test_torch_hybrid.py)."""
    jcfg, tcfg = _cfgs(ARCHS[fam], cd)
    if fam == "moe":
        jcfg, tcfg = (dataclasses.replace(c, moe=dataclasses.replace(
            c.moe, router_aux_loss=0.01)) for c in (jcfg, tcfg))
    if fam == "hybrid" and cd == "bfloat16":
        jcfg = dataclasses.replace(jcfg, scan_layers=False)
    batch = _batch(tcfg, embeds=(fam == "vlm"))
    jloss, jmet, jgrads = _jax_loss_grads(jcfg, inits[fam], batch)
    loss, met, grads = _port_loss_grads(tcfg, inits[fam], batch)
    rtol = 1e-5 if cd == "float32" else 2e-2
    np.testing.assert_allclose(float(loss), float(jloss), rtol=rtol)
    if fam == "moe":
        np.testing.assert_allclose(float(met["moe_aux"].detach()),
                                   float(jmet["moe_aux"]), rtol=1e-5)
        assert float(met["moe_dropped"]) == float(jmet["moe_dropped"])
    _leaves_close(bridge.grads_to_numpy(grads, tcfg), jgrads, cd)


def test_loss_chunk_matches_jax_and_the_unchunked_loss(inits):
    """``loss_chunk`` = 8 over S = 32: the chunked CE against the
    reference's chunked scan, and against the port's unchunked loss (the
    same sum in another order, float32)."""
    jcfg, tcfg = _cfgs("qwen3-1.7b", "float32", loss_chunk=8)
    batch = _batch(tcfg, seed=1)
    jloss, _, jgrads = _jax_loss_grads(jcfg, inits["dense"], batch)
    loss, _, grads = _port_loss_grads(tcfg, inits["dense"], batch)
    np.testing.assert_allclose(float(loss), float(jloss), rtol=1e-5)
    _leaves_close(bridge.grads_to_numpy(grads, tcfg), jgrads, "float32")
    loss0, _, grads0 = _port_loss_grads(
        dataclasses.replace(tcfg, loss_chunk=0), inits["dense"], batch)
    np.testing.assert_allclose(float(loss), float(loss0), rtol=1e-6)
    for n in grads:
        np.testing.assert_allclose(_f32(grads[n]), _f32(grads0[n]),
                                   rtol=1e-5, atol=1e-8)


@pytest.mark.parametrize("fam", ["dense", "moe", "hybrid"])
def test_remat_policies_give_equal_loss_and_grads(inits, fam):
    """"none", "nothing" (checkpoint per layer) and "dots" (the weight
    products kept) recompute the same ops, so the loss and every gradient
    are ``torch.equal`` (bf16 compute)."""
    out = {}
    for policy in ("none", "nothing", "dots"):
        _, tcfg = _cfgs(ARCHS[fam], "bfloat16", remat_policy=policy)
        loss, _, grads = _port_loss_grads(tcfg, inits[fam], _batch(tcfg))
        out[policy] = (loss, grads)
    loss, grads = out["none"]
    for policy in ("nothing", "dots"):
        assert torch.equal(out[policy][0], loss), policy
        for n, g in grads.items():
            assert torch.equal(out[policy][1][n], g), (policy, n)


def test_lever_gradients_reach_the_f32_leaves():
    """With ``cast_weights_bf16`` on (a reduced qwen3 widened so that the
    tied embedding and the MLP weights pass the reference's 1M-element
    rule) every cast leaf gets a non-zero float32 gradient through the
    cast, within 2e-2 of its largest entry of the lever-off gradient, and
    the loss and gradients agree with the reference's lever-on
    ``value_and_grad`` by the bf16 rule."""
    wide = dict(d_model=128, d_ff=4096, vocab_size=8192)
    jcfg, tcfg = _cfgs("qwen3-1.7b", "bfloat16", **wide)
    tree = jax.tree.map(np.asarray, jbuild_model(jcfg).init(
        jax.random.PRNGKey(1)))
    batch = _batch(tcfg, seed=2)
    on = dataclasses.replace(tcfg, cast_weights_bf16=True)
    params = bridge.params_from_numpy(tree, on, device="cpu")
    cast = {n for n, x, depth in _named_leaves(params, on)
            if _casts(x, depth)}
    assert "embed" in cast and any("w_gate" in n for n in cast)
    loss_on, _, g_on = _port_loss_grads(on, tree, batch)
    loss_off, _, g_off = _port_loss_grads(tcfg, tree, batch)
    for n in cast:
        assert g_on[n].dtype == torch.float32
        assert torch.isfinite(g_on[n]).all() and g_on[n].abs().max() > 0, n
        scale = float(g_off[n].abs().max())
        assert float((g_on[n] - g_off[n]).abs().max()) <= 2e-2 * scale, n
    np.testing.assert_allclose(float(loss_on), float(loss_off), rtol=2e-2)
    jloss, _, jgrads = _jax_loss_grads(
        dataclasses.replace(jcfg, cast_weights_bf16=True), tree, batch)
    np.testing.assert_allclose(float(loss_on), float(jloss), rtol=2e-2)
    _leaves_close(bridge.grads_to_numpy(g_on, on), jgrads, "bfloat16")


def test_train_steps_match_jax():
    """Three ``make_train_step`` steps from the bridged train state on the
    data pipeline's batches (float32): each step's loss, grad norm and lr
    against the reference's, then the parameters, m and v."""
    jcfg, tcfg = _cfgs("qwen3-1.7b", "float32")
    ocfg = dict(lr=3e-3, warmup_steps=2, total_steps=6)
    jstate = jinit_train_state(jbuild_model(jcfg), jax.random.PRNGKey(0))
    state = bridge.train_state_from_numpy(
        jax.tree.map(np.asarray, jstate), tcfg, device="cpu")
    jstep = jmake_train_step(jbuild_model(jcfg), JOptConfig(**ocfg))
    step = make_train_step(build_model(tcfg), OptConfig(**ocfg))
    dcfg = DataConfig(vocab_size=tcfg.vocab_size, seq_len=16, global_batch=4)
    lr_sum = 0.0
    for s in range(3):
        b = batch_at(dcfg, s, device="cpu")
        jstate, jm = jstep(jstate, {k: jnp.asarray(v.numpy())
                                    for k, v in b.items()})
        state, m = step(state, b)
        np.testing.assert_allclose(float(m["loss"]), float(jm["loss"]),
                                   rtol=1e-5)
        np.testing.assert_allclose(float(m["grad_norm"]),
                                   float(jm["grad_norm"]), rtol=1e-4)
        np.testing.assert_allclose(float(m["lr"]), float(jm["lr"]),
                                   rtol=1e-6)
        lr_sum += float(jm["lr"])
    got = bridge.train_state_to_numpy(state)
    want = jax.tree.map(np.asarray, jstate)
    assert int(got["opt"]["step"]) == int(want.opt.step) == 3
    _leaves_close(got["opt"]["m"], want.opt.m, "float32")
    _leaves_close(got["opt"]["v"], want.opt.v, "float32")
    # Adam divides by sqrt(v): where a gradient is a sum of cancelling
    # terms its last bits set the sign of an update of size lr, so the
    # parameters are held to 1 % of the summed lr
    for g, w in zip(jax.tree.leaves(got["params"]),
                    jax.tree.leaves(want.params)):
        np.testing.assert_allclose(g, w, rtol=0, atol=1e-2 * lr_sum)


def test_train_recovers_from_failure_and_loss_decreases():
    """tests/test_system.py's run on the port: reduced qwen3, 24 steps,
    checkpoints every 8, one failure injected at step 13; the resumed run
    ends at step 24 with parameters ``torch.equal`` to the clean run's,
    and the loss falls."""
    cfg = reduced(get_config("qwen3-1.7b"))
    runs = {}
    for fail_at in (None, 13):
        with tempfile.TemporaryDirectory() as d:
            runs[fail_at] = train_mod.train(
                cfg, steps=24, batch=4, seq=16, lr=3e-3, ckpt_dir=d,
                ckpt_every=8, device="cpu", fail_at_step=fail_at)
    clean, faulty = runs[None], runs[13]
    assert int(clean.state.opt.step) == int(faulty.state.opt.step) == 24
    for (n, a), (m, b) in zip(clean.state.params.named_parameters(),
                              faulty.state.params.named_parameters()):
        assert n == m and torch.equal(a, b), n
    # the faulty run replayed steps 9..13 after restoring step 8
    assert [r["step"] for r in faulty.records] == \
        list(range(1, 14)) + list(range(9, 25))
    losses = [r["loss"] for r in clean.records]
    assert losses[-1] < losses[0]


def test_launcher_trains_on_the_cpu_and_refuses_without_a_card(capsys,
                                                               monkeypatch):
    """``python -m repro_torch.launch.train --device cpu`` trains the reduced
    qwen3 (the loss falls over 8 steps at lr 1e-2); without ``--device``
    and without a card it raises."""
    with tempfile.TemporaryDirectory() as d:
        train_mod.main(["--steps", "8", "--batch", "4", "--seq", "16",
                        "--lr", "1e-2", "--device", "cpu", "--ckpt-dir", d,
                        "--log-every", "0"])
    out = capsys.readouterr().out
    assert "done; final step 8" in out
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="CUDA"):
        train_mod.main(["--steps", "1", "--log-every", "0"])
