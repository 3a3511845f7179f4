"""The port's dry-run (``repro_torch.launch.dryrun``, ``launch.step.
cell_structs``, ``models.registry.input_structs``) on the meta device under
a fake process group (``torch.testing._internal.distributed.fake_pg``),
and the caches' partition specs against the reference's.

* Every (arch × shape) cell on the single-pod (16, 16) mesh of 256 fake
  ranks, at full width and a depth cut (2 layers; the hybrid one pattern
  of 3; whisper's encoder 2), builds and runs its step on rank 0's shards,
  or is the reference's SKIP.
* The rank's per-device shapes of every leaf of every cell's inputs
  (parameters, m and v, caches, batch) at full width and full depth equal
  the shard shapes of the reference's own ``cell_structs`` on a
  device-free ``jax.sharding.AbstractMesh`` of the same shape, which runs
  under the installed jax (its ``NamedSharding.shard_shape``): the
  reference's stacked leaves ``[L, ...]`` against the port's layers one by
  one.
* qwen3-1.7b's per-device bytes of ``train_4k`` and ``decode_32k``
  against hand arithmetic from its specs.
* The collective counts of reduced qwen3's prefill and decode on a fake
  (2, 2) mesh against PERF.md §3's per-layer arithmetic.
* On a world of one, the costing pass's FLOPs against
  ``FlopCounterMode`` over the one-process step.
* Every family's ``cache_specs``, resolved and sanitized on an
  ``AbstractMesh`` at the decode cells' cache shapes, against the
  reference's.
"""
import dataclasses

import pytest

torch = pytest.importorskip("torch")
import jax  # noqa: E402
from jax.sharding import AbstractMesh as JAbstractMesh  # noqa: E402
from torch.utils.flop_counter import FlopCounterMode  # noqa: E402

from repro.configs import get_config as jget_config  # noqa: E402
from repro.configs import get_shape as jget_shape  # noqa: E402
from repro.launch import mesh as jmesh  # noqa: E402
from repro.launch.step import cell_structs as jcell_structs  # noqa: E402
from repro.models import build_model as jbuild_model  # noqa: E402
from repro_torch import configs  # noqa: E402
from repro_torch.configs import get_config, reduced  # noqa: E402
from repro_torch.launch import dryrun  # noqa: E402
from repro_torch.launch import mesh as tmesh  # noqa: E402
from repro_torch.launch.step import cell_structs  # noqa: E402
from repro_torch.models import build_model  # noqa: E402
from repro_torch.models.hybrid import _pattern  # noqa: E402

ARCHS = sorted(configs.ARCHS)
SHAPES = [s.name for s in configs.ALL_SHAPES]


def _cut(cfg):
    """Full width, a depth cut."""
    kw = {"num_layers": len(cfg.hybrid.pattern) if cfg.family == "hybrid"
          else 2}
    if cfg.family == "encdec":
        kw["encdec"] = dataclasses.replace(cfg.encdec, encoder_layers=2)
    return dataclasses.replace(cfg, **kw)


@pytest.fixture(scope="module")
def pod():
    """The (16, 16) mesh over a fake group of 256 ranks."""
    mesh = dryrun.production_mesh("single")
    yield mesh
    if torch.distributed.is_initialized():
        torch.distributed.destroy_process_group()


def test_every_cell_runs_or_skips_at_a_depth_cut(pod, tmp_path):
    bad = []
    for arch in ARCHS:
        cfg = _cut(get_config(arch))
        for shape in SHAPES:
            rec = dryrun.run_cell(arch, shape, "single", str(tmp_path),
                                  cfg_override=cfg, mesh=pod,
                                  costing=False)
            want = "OK" if configs.shape_applicable(
                cfg, dryrun.SHAPES[shape])[0] else "SKIP"
            if rec["status"] != want:
                bad.append((arch, shape, rec.get("error")))
    assert not bad, bad


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


def _shard(struct):
    return tuple(struct.sharding.shard_shape(struct.shape))


def _cache_pairs(cfg, got, want):
    """(port leaf, reference struct, stacked) of a cache tree."""
    if cfg.family in ("dense", "moe", "vlm"):
        return [(got[k], want[k], False) for k in ("k", "v")]
    if cfg.family == "encdec":
        return [(g, w, False) for g, w in zip(got, want, strict=True)]
    out = []
    for i, pair in enumerate(got):
        if cfg.family == "ssm":
            ref = want
        else:
            path, _ = _ref_path(f"layers.{i}.x", cfg)
            ref = _at(want, path[:-1])
        out += [(g, w, True) for g, w in zip(pair, ref, strict=True)]
    return out


@pytest.mark.parametrize("arch", ARCHS)
def test_per_device_shapes_match_the_reference_cells(pod, arch):
    cfg, jcfg = get_config(arch), jget_config(arch)
    jm = JAbstractMesh((16, 16), ("data", "model"))
    for shape in SHAPES:
        if not configs.shape_applicable(cfg, dryrun.SHAPES[shape])[0]:
            continue
        _, args, _ = cell_structs(cfg, dryrun.SHAPES[shape], pod)
        _, jargs, _, _ = jcell_structs(jcfg, jget_shape(shape), jm)
        kind = dryrun.SHAPES[shape].kind
        params = args[0].params if kind == "train" else args[0]
        jparams = jargs[0].params if kind == "train" else jargs[0]
        pairs = []
        for n, p in params.named_parameters():
            path, stacked = _ref_path(n, cfg)
            pairs.append((p, _at(jparams, path), stacked))
        if kind == "train":
            m = args[0].opt.m
            for n, p in params.named_parameters():
                path, stacked = _ref_path(n, cfg)
                pairs.append((m[n], _at(jargs[0].opt.m, path), stacked))
        if kind == "decode":
            pairs += _cache_pairs(cfg, args[1], jargs[1])
        batch, jbatch = args[-1], jargs[-1]
        pairs += [(batch[k], jbatch[k], False) for k in batch
                  if torch.is_tensor(batch[k])]
        for got, want, stacked in pairs:
            ref = _shard(want)
            assert tuple(got.shape) == (ref[1:] if stacked else ref), (
                arch, shape, tuple(got.shape), ref)


def test_qwen3_bytes_per_device_are_the_specs_arithmetic(pod):
    """qwen3-1.7b on (16, 16), float32 parameters: the embedding [V, d]
    split (model, data); a layer's wq [d, H, hd] (data, model), wk and wv
    [d, Hkv, hd] (data), wo [H, hd, d] (model, data), the MLP's three [d,
    ff] (data, model) / (model, data), the four norm vectors whole; the
    final norm whole.  Train: m and v as the parameters, the step's int32,
    tokens and labels [B / 16, S] int32.  Decode: K and V [L, B / 16, S /
    16, Hkv, hd] bf16, the token [B / 16, 1] int32."""
    c = get_config("qwen3-1.7b")
    D = M = 16
    d, H, Hkv, hd, ff, L, V = (c.d_model, c.num_heads, c.num_kv_heads,
                               c.head_dim_, c.d_ff, c.num_layers,
                               c.vocab_size)
    layer = (d // D * H // M * hd + 2 * d // D * Hkv * hd
             + H // M * hd * d // D + 3 * d // D * ff // M + 2 * d + 2 * hd)
    n_params = V // M * d // D + L * layer + d
    train = dryrun.footprint(dryrun.SHAPES["train_4k"], cell_structs(
        c, dryrun.SHAPES["train_4k"], pod)[1])
    B, S = 256 // D, 4096
    assert train == {"params": 4 * n_params, "opt_state": 8 * n_params + 4,
                     "caches": 0, "inputs": 2 * 4 * B * S,
                     "total": 12 * n_params + 4 + 8 * B * S}
    dec = dryrun.footprint(dryrun.SHAPES["decode_32k"], cell_structs(
        c, dryrun.SHAPES["decode_32k"], pod)[1])
    B, S = 128 // D, 32768 // M
    caches = 2 * 2 * L * B * S * Hkv * hd
    assert dec == {"params": 4 * n_params, "opt_state": 0,
                   "caches": caches, "inputs": 4 * B,
                   "total": 4 * n_params + caches + 4 * B}


def test_collective_counts_are_the_per_layer_arithmetic(tmp_path):
    """Reduced qwen3 on a fake (2, 2) mesh, every count an all-gather
    (PERF.md §3): a layer gathers its seven FSDP leaves (wq, wk, wv, wo and
    the MLP's three) over "data" and sums the attention's and the MLP's
    partial outputs over "model" (one rank-ordered all-reduce, an
    all-gather, each): 9; decode adds the query heads' gather and the
    partials' gather of the distributed flash-decode: 11.  Outside the
    layers: the embedding's FSDP gather and its vocabulary sum, the tied
    head's FSDP gather and the logits' vocabulary gather: 4."""
    dryrun.start(4)
    try:
        m = tmesh.make_mesh((2, 2), ("data", "model"), "cpu")
        cfg = reduced(get_config("qwen3-1.7b"))
        for kind, S, per_layer in (("prefill", 64, 9), ("decode", 64, 11)):
            shape = configs.ShapeConfig("cell", kind, S, 4)
            c = dryrun.cost(cfg, shape, m)
            assert c["collective_by_kind"] == {"all_gather": {
                "count": 4 + per_layer * cfg.num_layers,
                "bytes": c["collective_bytes"]}}, (kind, c)
    finally:
        torch.distributed.destroy_process_group()


def test_world_of_one_flops_are_the_one_process_step():
    dryrun.start(1)
    try:
        m = tmesh.make_mesh((1, 1), ("data", "model"), "cpu")
        for arch, shape in (("qwen3-1.7b", "train_4k"),
                            ("falcon-mamba-7b", "decode_32k"),
                            ("whisper-medium", "prefill_32k")):
            cfg = _cut(get_config(arch))
            cell = dryrun.SHAPES[shape]
            got = dryrun.cost(cfg, cell, m)["flops"]
            fn, args, _ = cell_structs(cfg, cell, None)
            with FlopCounterMode(display=False) as fc:
                fn(*args)
            assert got == fc.get_total_flops() > 0, (arch, shape)
    finally:
        torch.distributed.destroy_process_group()


MESHES = {"data16_model16": ((16, 16), ("data", "model")),
          "pod2_data16_model16": ((2, 16, 16), ("pod", "data", "model"))}


@pytest.mark.parametrize("mesh_name", sorted(MESHES))
@pytest.mark.parametrize("arch", ARCHS)
def test_cache_specs_resolve_as_the_reference(arch, mesh_name):
    """At decode_32k's global cache shapes: the port's per-layer specs
    resolved and sanitized on an ``AbstractMesh`` equal the reference's
    stacked ones without their leading entry."""
    shape, axes = MESHES[mesh_name]
    tm, jm = tmesh.AbstractMesh(shape, axes), JAbstractMesh(shape, axes)
    cfg, jcfg = get_config(arch), jget_config(arch)
    model, jmodel = build_model(cfg), jbuild_model(jcfg)
    got = model.init_cache(128, 32768, device="meta")
    want = jax.eval_shape(lambda: jmodel.init_cache(128, 32768))
    gspecs, jspecs = model.cache_specs(), jmodel.cache_specs()
    flat_g = _cache_pairs(cfg, got, want)
    flat_s = _cache_pairs(cfg, gspecs, jspecs)
    for (g, w, stacked), (gs, ws, _) in zip(flat_g, flat_s, strict=True):
        a = tmesh.sanitize_spec(gs, tuple(g.shape), tm)
        b = tuple(jmesh.sanitize_spec(ws, tuple(w.shape), jm))
        assert tuple(a) == (b[1:] if stacked else b), (arch, a, b)


def test_two_pods_split_the_batch_over_pod_and_data():
    """On (2, 16, 16) the batch axes are ("pod", "data"): the rank's
    inputs and caches equal the reference's shard shapes there too."""
    m = dryrun.production_mesh("multi")
    try:
        jm = JAbstractMesh((2, 16, 16), ("pod", "data", "model"))
        for arch, shape in (("qwen3-1.7b", "decode_32k"),
                            ("qwen3-1.7b", "train_4k"),
                            ("whisper-medium", "prefill_32k")):
            cfg = _cut(get_config(arch))
            _, args, _ = cell_structs(cfg, dryrun.SHAPES[shape], m)
            _, jargs, _, _ = jcell_structs(_cut(jget_config(arch)),
                                           jget_shape(shape), jm)
            batch, jbatch = args[-1], jargs[-1]
            for k in batch:
                if torch.is_tensor(batch[k]):
                    assert tuple(batch[k].shape) == _shard(jbatch[k]), k
            if shape == "decode_32k":
                for got, want, _ in _cache_pairs(cfg, args[1], jargs[1]):
                    assert tuple(got.shape) == _shard(want)
    finally:
        torch.distributed.destroy_process_group()
