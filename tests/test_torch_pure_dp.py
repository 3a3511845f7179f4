"""The ``pure_dp`` layout (``cfg.pure_dp``: the batch over ``("data",
"model")``, every leaf ZeRO-3 over both axes, nothing tensor-parallel) on
the CPU, for every family.

* One spawn of four gloo ranks on a ``(2, 2)`` ``("data", "model")`` mesh
  (``tests/torch_mesh_ranks.py``, a list of jobs from ``file://`` stores
  under ``tmp_path``): the six families trained under ``pure_dp`` (twice),
  granite-moe also on a batch of 2 that does not divide over the four
  ranks (kept whole on each); qwen3 saved under ``pure_dp`` and restored
  into the tensor-parallel layout, and the reverse; the six families
  served in both serving layouts (twice); granite-moe's MoE block on the
  ranks' rows and on a whole batch.
* The yardsticks: the one-process port on the reference's init bridged
  through numpy (itself held against the reference's single-device loss
  and gradients in ``tests/test_torch_distributed.py`` and
  ``test_torch_mesh_families.py``), and the reference's ``_moe_shard``
  called once for each ``"data"`` shard and expert shard, as its
  ``apply_moe`` runs under ``pure_dp`` (its token group a ``"data"``
  shard's tokens, the experts over ``"model"``).
* The per-device shapes of the parameters, m, v and the batch against the
  reference's own ``cell_structs(replace(cfg, pure_dp=True), ...)`` on a
  device-free ``jax.sharding.AbstractMesh`` at (2, 2), (2, 16, 16) and
  (16, 16), full width and a depth cut; the port's side on the meta
  device under a fake process group.  The caches are held by their bytes:
  the reference keeps the caches' own specs (S or heads over "model")
  while the batch spans both axes, the port holds a rank's batch slice
  with every slot and head.

Tolerances, float32 compute (``tests/test_torch_distributed.py``'s rule):
the loss and grad norm at rtol 1e-5, every parameter, m and v within 1e-4
of the leaf's largest entry (whisper's key biases by
``tests/test_torch_mesh_families.py``'s rule); logits and caches within
1e-4 of the one-process run's largest entry (``test_torch_mesh_serve.py``'s
bounds); the MoE block at rtol 1e-5.  Two runs on the mesh are
``torch.equal``.
"""
import dataclasses

import numpy as np
import pytest

torch = pytest.importorskip("torch")
import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402
import torch.multiprocessing as mp  # noqa: E402
import torch_mesh_ranks as ranks  # noqa: E402
from jax.sharding import AbstractMesh as JAbstractMesh  # noqa: E402

from repro.configs import get_config as jget_config  # noqa: E402
from repro.configs import get_shape as jget_shape  # noqa: E402
from repro.configs import reduced as jreduced  # noqa: E402
from repro.launch.step import cell_structs as jcell_structs  # noqa: E402
from repro.models import build_model as jbuild_model  # noqa: E402
from repro.models.moe import _moe_shard as j_moe_shard  # noqa: E402
from repro_torch import bridge, configs  # noqa: E402
from repro_torch.configs import get_config, reduced  # noqa: E402
from repro_torch.launch import dryrun  # noqa: E402
from repro_torch.launch import mesh as tmesh  # noqa: E402
from repro_torch.launch.step import cell_structs  # noqa: E402
from repro_torch.models import build_model  # noqa: E402
from repro_torch.models.hybrid import _pattern  # noqa: E402

torch.set_num_threads(1)
ARCHS = ("qwen3-1.7b", "granite-moe-1b-a400m", "qwen2-vl-2b",
         "falcon-mamba-7b", "recurrentgemma-9b", "whisper-medium")
STEPS = 3
MESH = (2, 2)
PROMPT, DECODE, CACHE = 8, 8, 16
WINDOW = 8
WHOLE_B = 2            # a train batch that does not divide over 4 ranks


def _dp(cfg):
    return dataclasses.replace(cfg, name=cfg.name + "-puredp", pure_dp=True)


def _cfgs(arch, serve=False, **moe):
    """(reference, port) configurations, reduced, float32; for serving the
    hybrid's window cut to WINDOW (its ring buffers wrap), as
    ``tests/test_torch_mesh_serve.py`` serves it (training keeps the
    window, as ``tests/test_torch_mesh_families.py`` trains it)."""
    jcfg = dataclasses.replace(jreduced(jget_config(arch)),
                               compute_dtype="float32")
    tcfg = dataclasses.replace(reduced(get_config(arch)),
                               compute_dtype="float32")
    if tcfg.family == "hybrid" and serve:
        jcfg = dataclasses.replace(jcfg, hybrid=dataclasses.replace(
            jcfg.hybrid, window=WINDOW))
        tcfg = dataclasses.replace(tcfg, hybrid=dataclasses.replace(
            tcfg.hybrid, window=WINDOW))
    if moe:
        jcfg = dataclasses.replace(
            jcfg, moe=dataclasses.replace(jcfg.moe, **moe))
        tcfg = dataclasses.replace(
            tcfg, moe=dataclasses.replace(tcfg.moe, **moe))
    return jcfg, tcfg


def _no_fsdp(cfg):
    return dataclasses.replace(cfg, name=cfg.name + "-replicated",
                               serve_param_fsdp=False)


def _as_dict(state) -> dict:
    return {"params": {n: p.detach().clone() for n, p in
                       state.params.named_parameters()},
            "m": {n: t.clone() for n, t in state.opt.m.items()},
            "v": {n: t.clone() for n, t in state.opt.v.items()}}


def _close(name, got, want, frac=1e-4, ref=None):
    got, want = got.detach().float(), want.detach().float()
    assert got.shape == want.shape, (name, got.shape, want.shape)
    scale = float((want if ref is None else ref).abs().max()) \
        if want.numel() else 0.0
    err = float((got - want).abs().max()) if got.numel() else 0.0
    assert err <= frac * scale + 1e-12, (
        f"{name}: {err} > {frac} of its largest entry {scale}")


def _init(tmp, jcfg, tcfg, seed=0):
    """The reference's init, bridged and saved; (path, tree, params)."""
    tree = jax.tree.map(np.asarray,
                        jbuild_model(jcfg).init(jax.random.PRNGKey(seed)))
    params = bridge.params_from_numpy(tree, tcfg, device="cpu")
    path = str(tmp / f"{tcfg.name}.pt")
    torch.save({"params": {n: p.detach() for n, p in
                           params.named_parameters()}}, path)
    return path, tree, params


def _prompts(cfg, rng, B):
    toks = torch.from_numpy(rng.integers(0, cfg.vocab_size, (B, PROMPT),
                                         dtype=np.int32))
    if cfg.family == "vlm":
        return {"embeds": torch.from_numpy(rng.standard_normal(
            (B, PROMPT, cfg.d_model)).astype(np.float32))}
    if cfg.family == "encdec":
        return {"enc_embeds": torch.from_numpy(rng.standard_normal(
            (B, cfg.encdec.source_positions, cfg.d_model)).astype(
                np.float32)), "tokens": toks}
    return {"tokens": toks}


def _one_run(tcfg, path, steps, more=0, batch=ranks.B):
    """The one-process port's ``steps`` steps from the saved init: (the
    records, the state); with ``more``, also the records of ``more`` steps
    after them and the state then."""
    state = ranks.whole_state(tcfg, torch.load(path))
    model = build_model(tcfg)
    state, rec = ranks.run_steps(model, state, steps, 0, batch)
    kept = _as_dict(state)
    if not more:
        return rec, kept
    state, rec2 = ranks.run_steps(model, state, more, steps, batch)
    return rec, kept, rec2, _as_dict(state)


@pytest.fixture(scope="module")
def work(tmp_path_factory):
    """The one-process runs and the one spawn of every mesh check."""
    tmp = tmp_path_factory.mktemp("pure_dp")
    rng = np.random.default_rng(0)
    out = {"cfgs": {}, "one": {}, "serve1": {}, "tmp": tmp}
    init, prompts, forced = {}, {}, {}
    train_cfgs, serve_cfgs = [], []
    for arch in ARCHS:
        jcfg, tcfg = _cfgs(arch)
        path, tree, _ = _init(tmp, jcfg, tcfg)
        dp = _dp(tcfg)
        out["cfgs"][arch] = dp
        init[tcfg.name] = init[dp.name] = path
        if arch == "qwen3-1.7b":
            out["one"][arch] = _one_run(tcfg, path, STEPS, more=STEPS)
        else:
            out["one"][arch] = _one_run(tcfg, path, STEPS)
        train_cfgs.append(dp)
        tcfg = _cfgs(arch, serve=True)[1]
        params = bridge.params_from_numpy(tree, tcfg, device="cpu")
        dp = _dp(tcfg)
        pr = _prompts(tcfg, rng, ranks.B)
        fz = torch.from_numpy(rng.integers(0, tcfg.vocab_size,
                                           (ranks.B, DECODE),
                                           dtype=np.int32))
        for cfg in (dp, _no_fsdp(dp)):
            init[cfg.name], prompts[cfg.name], forced[cfg.name] = \
                path, pr, fz
            serve_cfgs.append(cfg)
        with torch.inference_mode():
            out["serve1"][arch] = ranks.serve_run(build_model(tcfg), params,
                                                  pr, fz, CACHE)
    # granite-moe on a batch that does not divide over the four ranks
    granite = out["cfgs"]["granite-moe-1b-a400m"]
    whole = dataclasses.replace(granite, name=granite.name + "-whole")
    init[whole.name] = init[granite.name]
    out["one_whole"] = _one_run(_cfgs("granite-moe-1b-a400m")[1],
                                init[granite.name], STEPS, batch=WHOLE_B)
    out["whole_cfg"] = whole
    # the MoE block at capacity factor 1.0, where tokens drop
    jm, tm = _cfgs("granite-moe-1b-a400m", capacity_factor=1.0)
    tm = dataclasses.replace(_dp(tm), name=tm.name + "-cf1")
    mpath, mtree, _ = _init(tmp, jm, tm, seed=1)
    init[tm.name] = mpath
    x = np.random.default_rng(2).standard_normal(
        (ranks.B, ranks.S, tm.d_model)).astype(np.float32)
    out["moe"] = (jm, tm, mtree, x)
    qwen = out["cfgs"]["qwen3-1.7b"]
    tp = dataclasses.replace(qwen, name=qwen.name + "-tp", pure_dp=False)
    init[tp.name] = init[qwen.name]
    out["tp"] = tp
    d = {k: tmp / k for k in ("train", "whole", "tp", "to_tp", "to_dp",
                              "serve", "moe", "moe_whole")}
    for p in d.values():
        p.mkdir()
    ckpt_dp, ckpt_tp = str(tmp / "ckpt_dp"), str(tmp / "ckpt_tp")
    common = dict(mesh=MESH, init=init)
    jobs = [
        dict(kind="train", cfgs=train_cfgs, steps=STEPS, runs=2,
             ckpt={qwen.name: ckpt_dp}, out=str(d["train"]), **common),
        dict(kind="train", cfgs=[whole], steps=STEPS, batch=WHOLE_B,
             out=str(d["whole"]), **common),
        dict(kind="train", cfgs=[tp], steps=STEPS, ckpt={tp.name: ckpt_tp},
             out=str(d["tp"]), **common),
        dict(kind="resume", cfgs=[tp], steps=STEPS, ckpt={tp.name: ckpt_dp},
             out=str(d["to_tp"]), **common),
        dict(kind="resume", cfgs=[qwen], steps=STEPS,
             ckpt={qwen.name: ckpt_tp}, out=str(d["to_dp"]), **common),
        dict(kind="serve", cfgs=serve_cfgs, prompts=prompts, forced=forced,
             cache_len=CACHE, runs=2, out=str(d["serve"]), **common),
        dict(kind="moe", cfgs=[tm], x=torch.from_numpy(x),
             out=str(d["moe"]), **common),
        dict(kind="moe", cfgs=[tm], x=torch.from_numpy(x[:WHOLE_B]),
             whole=True, out=str(d["moe_whole"]), **common),
    ]
    mp.spawn(ranks.main, args=(4, dict(jobs=jobs, store=str(tmp / "store"))),
             nprocs=4, join=True)
    out["mesh"] = torch.load(d["train"] / "train.pt")
    out["mesh_whole"] = torch.load(d["whole"] / "train.pt")
    out["to_tp"] = torch.load(d["to_tp"] / "train.pt")
    out["to_dp"] = torch.load(d["to_dp"] / "train.pt")
    out["serve"] = [torch.load(d["serve"] / f"serve{r}.pt")
                    for r in range(4)]
    out["moe_out"] = {k: [torch.load(d[k] / f"moe_rank{r}.pt")
                          for r in range(4)] for k in ("moe", "moe_whole")}
    return out


def _hold_training(records, whole, rec1, whole1, what):
    for got, want in zip(records, rec1, strict=True):
        for k in ("loss", "grad_norm", "lr"):
            np.testing.assert_allclose(got[k], want[k], rtol=1e-5,
                                       err_msg=f"{what} {k}")
    lr_sum = sum(r["lr"] for r in rec1)
    for kind in ("params", "m", "v"):
        leaves = whole1[kind]
        assert whole[kind].keys() == leaves.keys()
        for n in leaves:
            ref = None
            if n.endswith(".bk"):
                # exact gradient zero: tests/test_torch_mesh_families.py
                if kind == "params":
                    err = float((whole[kind][n] - leaves[n]).abs().max())
                    assert err <= 2.0 * lr_sum, (n, err, lr_sum)
                    continue
                ref = leaves[n[:-3] + ".wk"]
            _close(f"{what} {kind} {n}", whole[kind][n], leaves[n], ref=ref)


@pytest.mark.parametrize("arch", ARCHS)
def test_pure_dp_trains_as_one_process(work, arch):
    """(2, 2) under pure_dp: each rank a quarter of the batch, every leaf
    gathered over both axes at its use, the gradients reduce-scattered
    over the joint group; STEPS steps against one process."""
    rec1, whole1 = work["one"][arch][:2]
    cfg = work["cfgs"][arch]
    records, whole = work["mesh"][(cfg.name, 0)]
    _hold_training(records, whole, rec1, whole1, f"{arch} pure_dp")


@pytest.mark.parametrize("arch", ARCHS)
def test_two_pure_dp_runs_are_equal(work, arch):
    cfg = work["cfgs"][arch]
    (ra, wa), (rb, wb) = (work["mesh"][(cfg.name, r)] for r in (0, 1))
    assert ra == rb
    for kind in ("params", "m", "v"):
        for n in wa[kind]:
            assert torch.equal(wa[kind][n], wb[kind][n]), (kind, n)


def test_a_whole_batch_trains_as_one_process(work):
    """granite-moe on a batch of 2 over four ranks: the batch kept whole
    on each rank (it does not divide), the MoE block on the rank's
    "data" shard's rows with its expert shard, summed over "model" and
    gathered over "data"; every rank's gradient summed."""
    rec1, whole1 = work["one_whole"]
    records, whole = work["mesh_whole"][(work["whole_cfg"].name, 0)]
    _hold_training(records, whole, rec1, whole1, "granite whole batch")


@pytest.mark.parametrize("direction", ["to_tp", "to_dp"])
def test_restore_across_the_layouts(work, direction):
    """qwen3 saved after STEPS steps under pure_dp and restored into the
    tensor-parallel layout on the same (2, 2) mesh (``to_tp``), and the
    reverse (``to_dp``), STEPS more steps: the one-process run's 2 x
    STEPS steps (the elastic path)."""
    _, _, rec2, state = work["one"]["qwen3-1.7b"]
    name = work["tp"].name if direction == "to_tp" \
        else work["cfgs"]["qwen3-1.7b"].name
    records, whole = work[direction][(name, 0)]
    assert whole["step"] == 2 * STEPS
    _hold_training(records, whole, rec2, state, f"restored {direction}")


def _flat(tree, specs):
    if torch.is_tensor(tree):
        return [(specs, tree)]
    if isinstance(tree, dict):
        return [x for k in sorted(tree) for x in _flat(tree[k], specs[k])]
    return [x for t, s in zip(tree, specs, strict=True)
            for x in _flat(t, s)]


SERVE_CASES = [(a, f) for a in ARCHS for f in (True, False)]


@pytest.mark.parametrize("arch,fsdp", SERVE_CASES, ids=[
    f"{a}-{'fsdp' if f else 'replicated'}" for a, f in SERVE_CASES])
def test_pure_dp_serving_matches_one_process(work, arch, fsdp):
    """Each rank's logits (its row of the batch, the whole vocabulary) and
    caches (its row, every slot, head and channel: ``to_dp`` of
    ``cache_specs``) against the one-process run's."""
    cfg = _dp(_cfgs(arch, serve=True)[1])
    cfg = cfg if fsdp else _no_fsdp(cfg)
    pc1, logits1, caches1 = work["serve1"][arch]
    am = tmesh.AbstractMesh(MESH, ("data", "model"))
    specs = build_model(cfg).cache_specs()
    scale = float(logits1.abs().max())
    for r, res in enumerate(work["serve"]):
        coords = {"data": r // MESH[1], "model": r % MESH[1]}
        pc, logits, caches = res[(cfg.name, 0)]
        _close(f"rank {r} logits", logits, logits1[r:r + 1], ref=torch.full(
            (), scale))
        for what, got, want in (("prefill", pc, pc1),
                                ("final", caches, caches1)):
            for i, ((spec, g), (_, w)) in enumerate(zip(
                    _flat(got, specs), _flat(want, specs), strict=True)):
                sp = tmesh.sanitize_spec(tmesh.to_dp(spec), tuple(w.shape),
                                         am)
                w = w[tmesh.local_slices(sp, w.shape, am, coords)]
                _close(f"rank {r} {what} cache {i}", g, w)


def test_two_pure_dp_serving_runs_are_equal(work):
    for res in work["serve"]:
        for name in {k[0] for k in res}:
            a, b = res[(name, 0)], res[(name, 1)]
            assert _flat_equal(a, b), name


def _flat_equal(a, b) -> bool:
    if torch.is_tensor(a):
        return torch.equal(a, b)
    if isinstance(a, dict):
        return a.keys() == b.keys() and all(_flat_equal(a[k], b[k])
                                            for k in a)
    return len(a) == len(b) and all(_flat_equal(x, y) for x, y in zip(a, b))


def _reference_groups(jcfg, tree, x, D, M):
    """The reference's ``apply_moe`` under pure_dp on (D, M): for each
    "data" shard of ``x``, ``_moe_shard`` once per expert shard, summed in
    shard order (its ``psum`` / ``pmean``)."""
    moe = {k: v[0] for k, v in tree["layers"]["moe"].items()}
    E_loc = jcfg.moe.num_experts // M
    G = x.shape[0] // D
    out = []
    for d in range(D):
        xd = jnp.asarray(x[d * G:(d + 1) * G].reshape(-1, x.shape[-1]))
        parts = [j_moe_shard(
            xd, jnp.asarray(moe["router"]),
            *(jnp.asarray(moe[w][m * E_loc:(m + 1) * E_loc])
              for w in ("w_gate", "w_up", "w_down")),
            jcfg, shard_id=m, n_shards=M) for m in range(M)]
        y, aux, drop = parts[0]
        for yp, ap, dp in parts[1:]:
            y, aux, drop = y + yp, aux + ap, drop + dp
        out.append((np.asarray(y).reshape(G, -1, x.shape[-1]),
                    float(aux / M), float(drop / M)))
    return out


@pytest.mark.parametrize("case", ["rows", "whole"])
def test_moe_keeps_the_reference_token_group(work, case):
    """granite-moe's block at capacity factor 1.0 (tokens drop): the
    token group is a "data" shard's tokens, gathered over "model" from the
    ranks' rows (``rows``: a batch of 4, a row a rank) or cut from a batch
    kept whole (``whole``: 2 rows), the experts over "model"; each rank's
    output rows, aux and drop fraction against the reference's
    ``_moe_shard`` per (data shard, expert shard)."""
    jm, tm, tree, x = work["moe"]
    D, M = MESH
    if case == "whole":
        x = x[:WHOLE_B]
    groups = _reference_groups(jm, tree, x, D, M)
    got = work["moe_out"]["moe" if case == "rows" else "moe_whole"]
    assert any(drop > 0 for _, _, drop in groups), "nothing dropped"
    whole_y = np.concatenate([g[0] for g in groups])
    for r in range(D * M):
        d = r // M
        y, aux, drop = groups[d]
        want = whole_y[r:r + 1] if case == "rows" else whole_y
        if case == "whole":
            aux, drop = groups[d][1], groups[d][2]
        res = got[r]
        np.testing.assert_allclose(
            res["y"].numpy(), want, rtol=1e-5,
            atol=1e-5 * float(np.abs(whole_y).max()))
        np.testing.assert_allclose(float(res["moe_aux"]), aux, rtol=1e-5)
        np.testing.assert_allclose(float(res["moe_dropped"]), drop,
                                   rtol=1e-6)


# ---------------------------------------------------------------------------
# per-device shapes against the reference's cell_structs
# ---------------------------------------------------------------------------

DRY = {"2x2": ((2, 2), ("data", "model")),
       "pod2x16x16": ((2, 16, 16), ("pod", "data", "model")),
       "16x16": ((16, 16), ("data", "model"))}
DRY_ARCHS = sorted(configs.ARCHS)
SHAPES = [s.name for s in configs.ALL_SHAPES]


def _cut(cfg):
    """Full width, a depth cut, pure_dp."""
    kw = {"num_layers": len(cfg.hybrid.pattern) if cfg.family == "hybrid"
          else 2, "pure_dp": True}
    if cfg.family == "encdec":
        kw["encdec"] = dataclasses.replace(cfg.encdec, encoder_layers=2)
    return dataclasses.replace(cfg, **kw)


def _ref_path(name, cfg):
    parts = name.split(".")
    if parts[0] in ("layers", "enc_layers", "dec_layers"):
        i, rest = int(parts[1]), parts[2:]
        if cfg.family == "hybrid":
            pat, n_super, _, _ = _pattern(cfg)
            if i < n_super * len(pat):
                j = i % len(pat)
                return ["super", f"s{j}_{pat[j]}", *rest], True
            return ["tail", *rest], True
        return [parts[0], *rest], True
    return parts, False


def _at(tree, path):
    for k in path:
        tree = tree[k]
    return tree


_MESHES = {}


def _dry_mesh(name):
    """The port's mesh of ``name`` over a fake process group (one group at
    a time: the tests run grouped by mesh)."""
    shape, axes = DRY[name]
    world = int(np.prod(shape))
    if name not in _MESHES or not torch.distributed.is_initialized() \
            or torch.distributed.get_world_size() != world:
        _MESHES.clear()
        dryrun.start(world)
        _MESHES[name] = tmesh.make_mesh(shape, axes, "cpu")
    return _MESHES[name]


@pytest.fixture(scope="module")
def fake_group():
    yield
    _MESHES.clear()
    if torch.distributed.is_initialized():
        torch.distributed.destroy_process_group()


DRY_CASES = [(m, a) for m in DRY for a in DRY_ARCHS]


@pytest.mark.parametrize("mesh_name,arch", DRY_CASES,
                         ids=[f"{m}-{a}" for m, a in DRY_CASES])
def test_per_device_shapes_match_the_reference_cells(fake_group, mesh_name,
                                                     arch):
    """Every leaf of every applicable cell: the parameters (the serving
    layout for prefill and decode), m and v, and the batch at the
    reference's shard shapes; the caches' bytes equal the reference's
    where the batch divides over the batch axes, and are the whole
    cache's where it does not (the rank then serves the whole batch)."""
    cfg, jcfg = _cut(get_config(arch)), _cut(jget_config(arch))
    m = _dry_mesh(mesh_name)
    jm = JAbstractMesh(*DRY[mesh_name])
    for shape in SHAPES:
        cell = dryrun.SHAPES[shape]
        if not configs.shape_applicable(cfg, cell)[0]:
            continue
        _, args, model = cell_structs(cfg, cell, m)
        _, jargs, _, _ = jcell_structs(jcfg, jget_shape(shape), jm)
        assert not any(model.sharding.tp.values())
        params = args[0].params if cell.kind == "train" else args[0]
        jparams = jargs[0].params if cell.kind == "train" else jargs[0]
        pairs = []
        for n, p in params.named_parameters():
            path, stacked = _ref_path(n, cfg)
            pairs.append((p, _at(jparams, path), stacked))
            if cell.kind == "train":
                pairs.append((args[0].opt.m[n], _at(jargs[0].opt.m, path),
                              stacked))
                pairs.append((args[0].opt.v[n], _at(jargs[0].opt.v, path),
                              stacked))
        batch, jbatch = args[-1], jargs[-1]
        pairs += [(batch[k], jbatch[k], False) for k in batch
                  if torch.is_tensor(batch[k])]
        for got, want, stacked in pairs:
            ref = tuple(want.sharding.shard_shape(want.shape))
            assert tuple(got.shape) == (ref[1:] if stacked else ref), (
                mesh_name, arch, shape, tuple(got.shape), ref)
        if cell.kind != "decode":
            continue
        got_b = sum(t.numel() * t.element_size()
                    for t in jax.tree.leaves(
                        args[1], is_leaf=torch.is_tensor))
        jl = jax.tree.leaves(jargs[1])
        ref_b = sum(int(np.prod(x.sharding.shard_shape(x.shape)))
                    * x.dtype.itemsize for x in jl)
        whole_b = sum(int(np.prod(x.shape)) * x.dtype.itemsize for x in jl)
        if cell.global_batch % m.axis_size(model.sharding.batch_axes) == 0:
            assert got_b == ref_b, (mesh_name, arch, shape, got_b, ref_b)
        else:
            assert got_b == whole_b, (mesh_name, arch, shape, got_b,
                                      whole_b)
