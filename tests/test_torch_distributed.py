"""The port's mesh path (``launch.mesh``, ``models.parallel``, the
expert-parallel MoE, the sharded clip, the re-sharding restore) on the CPU:
four gloo ranks on a ``(2, 2)`` ``("data", "model")`` mesh, spawned from
this process (``tests/torch_mesh_ranks.py``), each group started from a
``file://`` store under ``tmp_path``.

The reference's own mesh runs fail under the installed jax (its
``embed_in`` raises a ``ShardingTypeError``), so the port is held against
what runs: its one-process path, which is held against the reference's
single-device loss and gradients on bridged weights, and the reference's
``_moe_shard`` called for each (data shard, expert shard).

Tolerances, float32 compute: the loss at rtol 1e-5 and every parameter, m
and v within 1e-4 of the leaf's largest entry (the repo's f32 gradient
rule, tests/test_torch_train.py): the ranks sum partial products in other
orders than one process does.  Two runs on the same mesh are
``torch.equal``: every sum over ranks is in rank order.
"""
import dataclasses

import numpy as np
import pytest

torch = pytest.importorskip("torch")
import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402
import torch.multiprocessing as mp  # noqa: E402
import torch_mesh_ranks as ranks  # noqa: E402

from repro.configs import get_config as jget_config  # noqa: E402
from repro.configs import reduced as jreduced  # noqa: E402
from repro.models import build_model as jbuild_model  # noqa: E402
from repro.models.moe import _moe_shard as j_moe_shard  # noqa: E402
from repro_torch import bridge, checkpoint  # noqa: E402
from repro_torch.configs import get_config, reduced  # noqa: E402
from repro_torch.data import DataConfig, batch_at  # noqa: E402
from repro_torch.models import build_model  # noqa: E402

torch.set_num_threads(1)
ARCHS = ("qwen3-1.7b", "qwen3-moe-30b-a3b")
STEPS = 3
# the leaves each comparison names first: the ones whose gradients come out
# partial on each "model" rank (wk, wv and the qk-norm scales, read by a
# rank's heads; ln1's scale, whose cotangent arrives through the attention
# block's entry) and the one split over the vocabulary (embed)
NAMED = ("layers.0.attn.wk", "layers.0.attn.wv", "layers.0.attn.q_norm",
         "layers.0.attn.k_norm", "layers.0.ln1.scale", "embed")


def _cfgs(arch, **moe):
    jcfg = dataclasses.replace(jreduced(jget_config(arch)),
                               compute_dtype="float32")
    tcfg = dataclasses.replace(reduced(get_config(arch)),
                               compute_dtype="float32")
    if moe:
        jcfg = dataclasses.replace(
            jcfg, moe=dataclasses.replace(jcfg.moe, **moe))
        tcfg = dataclasses.replace(
            tcfg, moe=dataclasses.replace(tcfg.moe, **moe))
    return jcfg, tcfg


def _spawn(n, job):
    mp.spawn(ranks.main, args=(n, job), nprocs=n, join=True)


def _close(name, got, want, frac=1e-4):
    got, want = got.detach().float(), want.detach().float()
    scale = float(want.abs().max())
    err = float((got - want).abs().max())
    assert err <= frac * scale + 1e-12, (
        f"{name}: {err} > {frac} of its largest entry {scale}")


def _as_dict(state) -> dict:
    """A one-process ``TrainState`` as ``torch_mesh_ranks``'s dict."""
    return {"params": {n: p.detach().clone() for n, p in
                       state.params.named_parameters()},
            "m": {n: t.clone() for n, t in state.opt.m.items()},
            "v": {n: t.clone() for n, t in state.opt.v.items()}}


def _state_close(got: dict, want: dict, what: str):
    """Every parameter, m and v of a gathered state against the
    one-process one, the NAMED leaves first."""
    names = list(NAMED) + [n for n in want["params"] if n not in NAMED]
    for n in names:
        for kind in ("params", "m", "v"):
            _close(f"{what} {kind} {n}", got[kind][n], want[kind][n])


@pytest.fixture(scope="module")
def work(tmp_path_factory):
    """The reference's init of each configuration, bridged and saved; the
    one-process port run of 2 x STEPS steps from it (the state after
    STEPS and after 2 x STEPS kept); the (2, 2) mesh's runs, twice, with a
    checkpoint of qwen3 after STEPS steps; the restores of that checkpoint
    into (2, 1) and (1, 2) meshes, STEPS more steps each."""
    tmp = tmp_path_factory.mktemp("mesh")
    out = {"tmp": tmp, "trees": {}, "init": {}, "cfgs": {}, "one": {}}
    for arch in ARCHS:
        jcfg, tcfg = _cfgs(arch)
        tree = jax.tree.map(np.asarray,
                            jbuild_model(jcfg).init(jax.random.PRNGKey(0)))
        params = bridge.params_from_numpy(tree, tcfg, device="cpu")
        path = str(tmp / f"{tcfg.name}.pt")
        torch.save({"params": {n: p.detach() for n, p in
                               params.named_parameters()}}, path)
        out["trees"][arch], out["init"][tcfg.name] = tree, path
        out["cfgs"][arch] = (jcfg, tcfg)
        model = build_model(tcfg)
        state = ranks.whole_state(tcfg, torch.load(path))
        state, rec3 = ranks.run_steps(model, state, STEPS)
        kept = _as_dict(state)
        state, rec6 = ranks.run_steps(model, state, STEPS, start=STEPS)
        out["one"][arch] = (rec3, kept, rec6, _as_dict(state))
    qwen = out["cfgs"]["qwen3-1.7b"][1]
    ckpt = {qwen.name: str(tmp / "ckpt")}
    cfgs = [out["cfgs"][a][1] for a in ARCHS]
    _spawn(4, dict(kind="train", mesh=(2, 2), cfgs=cfgs, init=out["init"],
                   steps=STEPS, runs=2, ckpt=ckpt, out=str(tmp),
                   store=str(tmp / "store_train")))
    out["mesh"] = torch.load(tmp / "train.pt")
    out["resumed"] = {}
    for shape in ((2, 1), (1, 2)):
        d = tmp / f"resume_{shape[0]}{shape[1]}"
        d.mkdir()
        _spawn(2, dict(kind="resume", mesh=shape, cfgs=[qwen],
                       init=out["init"], steps=STEPS, ckpt=ckpt, out=str(d),
                       store=str(d / "store")))
        out["resumed"][shape] = torch.load(d / "train.pt")[(qwen.name, 0)]
    return out


@pytest.mark.parametrize("arch", ARCHS)
def test_sharded_steps_match_one_process(work, arch):
    """(2, 2): data parallelism with ZeRO-3 over "data", tensor (and, for
    the MoE, expert) parallelism over "model"; three steps against one
    process, loss and grad norm at rtol 1e-5, every leaf at 1e-4."""
    rec3, kept, _, _ = work["one"][arch]
    tcfg = work["cfgs"][arch][1]
    records, whole = work["mesh"][(tcfg.name, 0)]
    for got, want in zip(records, rec3, strict=True):
        for k in ("loss", "grad_norm", "lr"):
            np.testing.assert_allclose(got[k], want[k], rtol=1e-5,
                                       err_msg=k)
    _state_close(whole, kept, f"{arch} (2, 2) after {STEPS} steps")


@pytest.mark.parametrize("arch", ARCHS)
def test_two_mesh_runs_are_equal(work, arch):
    tcfg = work["cfgs"][arch][1]
    (ra, wa), (rb, wb) = (work["mesh"][(tcfg.name, r)] for r in (0, 1))
    assert ra == rb
    for kind in ("params", "m", "v"):
        for n in wa[kind]:
            assert torch.equal(wa[kind][n], wb[kind][n]), (kind, n)


@pytest.mark.parametrize("arch", ARCHS)
def test_one_process_matches_the_reference(work, arch):
    """The one-process port's first step (the mesh runs' yardstick)
    against ``jax.value_and_grad`` of the reference's loss on the same
    bridged weights and batch."""
    jcfg, tcfg = work["cfgs"][arch]
    batch = batch_at(DataConfig(vocab_size=tcfg.vocab_size,
                                seq_len=ranks.S, global_batch=ranks.B), 0,
                     "cpu")
    tree = work["trees"][arch]
    jb = {k: jnp.asarray(v.numpy()) for k, v in batch.items()}
    (jloss, _), jgrads = jax.value_and_grad(
        jbuild_model(jcfg).loss, has_aux=True)(
            jax.tree.map(jnp.asarray, tree), jb)
    model = build_model(tcfg)
    state = ranks.whole_state(tcfg, torch.load(work["init"][tcfg.name]))
    names, leaves = zip(*state.params.named_parameters())
    loss, _ = model.loss(state.params, batch)
    grads = dict(zip(names, torch.autograd.grad(loss, leaves)))
    np.testing.assert_allclose(float(loss.detach()), float(jloss),
                               rtol=1e-5)
    want = bridge.named_from_tree(jax.tree.map(np.asarray, jgrads), tcfg,
                                  device="cpu")
    for n in list(NAMED) + [n for n in names if n not in NAMED]:
        _close(f"{arch} gradient {n}", grads[n], want[n])
    np.testing.assert_allclose(work["one"][arch][0][0]["loss"],
                               float(jloss), rtol=1e-5)


@pytest.mark.parametrize("shape", [(2, 1), (1, 2)])
def test_restore_into_another_mesh_continues(work, shape):
    """Saved after STEPS steps on (2, 2), restored into 2 ranks as
    ``shape``, STEPS more steps: the one-process run's 2 x STEPS steps
    (``examples/elastic_rescale.py``'s flow)."""
    _, _, rec6, state = work["one"]["qwen3-1.7b"]
    records, whole = work["resumed"][shape]
    assert whole["step"] == 2 * STEPS
    for got, want in zip(records, rec6, strict=True):
        np.testing.assert_allclose(got["loss"], want["loss"], rtol=1e-5)
    _state_close(whole, state, f"restored into {shape}")


def test_checkpoint_of_a_mesh_holds_whole_leaves(work):
    """The checkpoint written from the (2, 2) mesh holds every leaf whole,
    equal to the gathered state."""
    tcfg = work["cfgs"]["qwen3-1.7b"][1]
    _, whole = work["mesh"][(tcfg.name, 0)]
    flat = {**whole["params"], "opt/step": torch.tensor(STEPS)}
    flat.update({f"opt/m/{n}": t for n, t in whole["m"].items()})
    flat.update({f"opt/v/{n}": t for n, t in whole["v"].items()})
    arrays, manifest = checkpoint.restore(str(work["tmp"] / "ckpt"), flat)
    assert manifest["step"] == STEPS
    for n, t in flat.items():
        assert np.array_equal(arrays[n], t.numpy()), n


def test_expert_parallel_matches_moe_shard(tmp_path):
    """Capacity factor 1.0, where tokens drop: each (data, model) rank's
    expert-parallel output, aux and drop fraction against the reference's
    ``_moe_shard`` called for each expert shard of the rank's data shard
    and summed in shard order (its ``psum`` / ``pmean``)."""
    jcfg, tcfg = _cfgs("qwen3-moe-30b-a3b", capacity_factor=1.0)
    tree = jax.tree.map(np.asarray,
                        jbuild_model(jcfg).init(jax.random.PRNGKey(1)))
    params = bridge.params_from_numpy(tree, tcfg, device="cpu")
    path = str(tmp_path / "init.pt")
    torch.save({"params": {n: p.detach() for n, p in
                           params.named_parameters()}}, path)
    D, M, B, S = 2, 2, 4, 16
    x = np.random.default_rng(0).standard_normal(
        (B, S, tcfg.d_model)).astype(np.float32)
    _spawn(4, dict(kind="moe", mesh=(D, M), cfgs=[tcfg],
                   init={tcfg.name: path}, x=torch.from_numpy(x),
                   out=str(tmp_path), store=str(tmp_path / "store")))
    moe = {k: v[0] for k, v in tree["layers"]["moe"].items()}
    E_loc = tcfg.moe.num_experts // M
    dropped_any = False
    for d in range(D):
        xd = jnp.asarray(x[d * B // D:(d + 1) * B // D].reshape(
            -1, x.shape[-1]))
        parts = [j_moe_shard(
            xd, jnp.asarray(moe["router"]),
            *(jnp.asarray(moe[w][m * E_loc:(m + 1) * E_loc])
              for w in ("w_gate", "w_up", "w_down")),
            jcfg, shard_id=m, n_shards=M) for m in range(M)]
        y, aux, drop = parts[0]
        for yp, ap, dp in parts[1:]:
            y, aux, drop = y + yp, aux + ap, drop + dp
        aux, drop = aux / M, drop / M
        dropped_any |= float(drop) > 0
        for m in range(M):
            got = torch.load(tmp_path / f"moe_rank{d * M + m}.pt")
            y_got = got["y"].reshape(-1, x.shape[-1]).numpy()
            np.testing.assert_allclose(
                y_got, np.asarray(y), rtol=1e-5,
                atol=1e-5 * float(np.abs(np.asarray(y)).max()))
            np.testing.assert_allclose(float(got["moe_aux"]), float(aux),
                                       rtol=1e-5)
            np.testing.assert_allclose(float(got["moe_dropped"]),
                                       float(drop), rtol=1e-6)
    assert dropped_any, "capacity factor 1.0 dropped nothing"
