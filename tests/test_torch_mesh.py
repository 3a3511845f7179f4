"""The port's partition specs and their resolution (``launch.mesh``, the
families' ``specs_*``, ``Model.specs`` / ``cache_specs``, ``opt_specs``,
``input_partition_specs``, the ``ShapeConfig`` cells) against the JAX
package's, in process with no process group; the mesh layout's block rule
(``models.parallel.Sharding``); and a one-process world of one (gloo,
``file://`` store) with jax and repro blocked, whose mesh path is
``torch.equal`` to the unsharded step and whose checkpoint round trip under
the mesh is exact.

The reference's spec functions run on a device-free
``jax.sharding.AbstractMesh``; its models' ``specs()`` and
``cache_specs()`` on reduced configurations (templates do not depend on
widths).  The port keys a layer's templates by ``named_parameters`` names,
one layer at a time, where the reference stacks the layers under a leading
``None``: a port spec equals the reference's without that entry.
"""
import dataclasses
import os
import pickle
import subprocess
import sys
from pathlib import Path

import pytest

torch = pytest.importorskip("torch")
from jax.sharding import AbstractMesh as JAbstractMesh  # noqa: E402
from jax.sharding import PartitionSpec as JP  # noqa: E402

from repro.configs import base as jbase  # noqa: E402
from repro.configs import get_config as jget_config  # noqa: E402
from repro.configs import reduced as jreduced  # noqa: E402
from repro.launch import mesh as jmesh  # noqa: E402
from repro.launch.step import \
    train_state_specs as jtrain_state_specs  # noqa: E402
from repro.models import build_model as jbuild_model  # noqa: E402
from repro.models.registry import \
    input_partition_specs as jinput_partition_specs  # noqa: E402
from repro.optim import opt_specs as jopt_specs  # noqa: E402
from repro_torch import configs  # noqa: E402
from repro_torch.configs import get_config, reduced  # noqa: E402
from repro_torch.launch import mesh  # noqa: E402
from repro_torch.launch.mesh import P  # noqa: E402
from repro_torch.launch.step import train_state_specs  # noqa: E402
from repro_torch.models import build_model  # noqa: E402
from repro_torch.models.hybrid import _pattern  # noqa: E402
from repro_torch.models.parallel import Sharding  # noqa: E402
from repro_torch.models.registry import input_partition_specs  # noqa: E402
from repro_torch.optim import opt_specs  # noqa: E402

ROOT = Path(__file__).resolve().parents[1]
MESHES = {"data4_model4": ((4, 4), ("data", "model")),
          "pod2_data2_model4": ((2, 2, 4), ("pod", "data", "model"))}
# (entries, shape, needs a pod axis)
SPECS = [
    (("model", "data"), (49155, 1024), False),   # granite's vocab
    (("model", "data"), (151936, 2048), False),
    (("data", "model", None), (2048, 16, 128), False),
    (("data", "model", None), (1536, 12, 128), False),
    (("model", None, "data"), (28, 128, 3584), False),
    (("data", "model"), (2048, 6144), False),
    (("model", "data"), (6, 1024), False),
    ((("data", "model"), None), (256, 4096), False),
    ((("data", "model"), None), (8, 4096), False),
    (("data", None), (1, 4096), False),          # batch 1 over 'data'
    ((None, "data"), (3,), False),               # more entries than dims
    ((None, "data", "model", None, None), (28, 8, 4096, 8, 128), False),
    ((None, None), (2048, 32), False),
    ((), (), False),
    ((("pod", "data"), None), (16, 4), True),
    ((("pod", "data"), None), (6, 4), True),
    ((None, ("pod", "data", "model")), (2, 64), True),
]


def _meshes(name):
    shape, axes = MESHES[name]
    return (mesh.AbstractMesh(shape, axes),
            JAbstractMesh(shape, axes))


def _t(spec):
    return tuple(spec)


CASES = [(m, e, s) for m in sorted(MESHES) for e, s, pod in SPECS
         if not pod or "pod" in MESHES[m][1]]


@pytest.mark.parametrize("mesh_name,entries,shape", CASES,
                         ids=[f"{m}-{e}-{s}" for m, e, s in CASES])
def test_spec_functions_match_reference(mesh_name, entries, shape):
    tm, jm = _meshes(mesh_name)
    ts, js = P(*entries), JP(*entries)
    assert _t(ts) == _t(js)
    assert _t(mesh.resolve_spec(ts, tm)) == _t(jmesh.resolve_spec(js, jm))
    assert _t(mesh.sanitize_spec(ts, shape, tm)) == _t(
        jmesh.sanitize_spec(js, shape, jm))
    assert mesh.batch_axes_of(tm) == jmesh.batch_axes_of(jm)


def test_reference_cases_of_its_own_tests():
    """tests/test_distribution.py's vocab 49155 and ('pod', 'data')
    cases, which the reference's tests cannot run under this jax."""
    tm = mesh.AbstractMesh((4, 4), ("data", "model"))
    assert mesh.sanitize_spec(P("model", "data"), (49155, 1024), tm) == \
        P(None, "data")
    tp = mesh.AbstractMesh((2, 2, 4), ("pod", "data", "model"))
    assert mesh.resolve_spec(P("data", "model"), tp) == \
        P(("pod", "data"), "model")
    assert mesh.batch_axes_of(tp) == ("pod", "data")


def test_partition_spec_semantics():
    """A one-name tuple is the name, an empty one None (as JAX's); specs
    pickle (they travel to spawned ranks)."""
    for e in [(("data",), None), ((), "model"), (["pod", "data"],), ()]:
        assert _t(P(*e)) == _t(JP(*e))
    s = P(("pod", "data"), None, "model")
    assert pickle.loads(pickle.dumps(s)) == s
    assert type(pickle.loads(pickle.dumps(s))) is P


def test_resolve_specs_over_a_tree():
    tp = mesh.AbstractMesh((2, 2, 4), ("pod", "data", "model"))
    tree = {"a": P("data"), "b": [P(None, "data"), (P("model"),)]}
    got = mesh.resolve_specs(tree, tp)
    assert got == {"a": P(("pod", "data")),
                   "b": [P(None, ("pod", "data")), (P("model"),)]}


@pytest.mark.parametrize("entries,shape", [
    (("data", "model", None), (8, 4, 3)),
    ((("pod", "data"), None, "model"), (8, 3, 4)),
    ((None, ("pod", "data", "model")), (2, 16)),
    ((None,), (5,)),
])
def test_local_slices_tile_the_leaf(entries, shape):
    """On a (2, 2, 2) pod mesh every element of a leaf lies in the shard of
    as many ranks as the axes the spec does not name."""
    tp = mesh.AbstractMesh((2, 2, 2), ("pod", "data", "model"))
    spec = P(*entries)
    named = {a for e in spec for a in mesh.entry_axes(e)}
    copies = 2 ** len(set(tp.axis_names) - named)
    count = torch.zeros(shape, dtype=torch.int64)
    for p in range(2):
        for d in range(2):
            for m in range(2):
                sl = mesh.local_slices(spec, shape, tp,
                                       {"pod": p, "data": d, "model": m})
                count[sl] += 1
    assert bool((count == copies).all())


# ---------------------------------------------------------------------------
# the families' templates
# ---------------------------------------------------------------------------

ARCHS = sorted(configs.ARCHS)


def _ref_path(name, cfg):
    """(reference tree path, stacked) of a port parameter name."""
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


@pytest.mark.parametrize("arch", ARCHS)
def test_model_specs_match_reference(arch):
    """Every leaf's template, through the bridge's names; the names are
    the model's ``named_parameters``."""
    cfg, jcfg = reduced(get_config(arch)), jreduced(jget_config(arch))
    model, jmodel = build_model(cfg), jbuild_model(jcfg)
    specs, jspecs = model.specs(), jmodel.specs()
    names = [n for n, _ in model.init(torch.Generator(),
                                      device="meta").named_parameters()]
    assert sorted(specs) == sorted(names)
    for n, s in specs.items():
        path, stacked = _ref_path(n, cfg)
        want = _t(_at(jspecs, path))
        assert _t(s) == (want[1:] if stacked else want), n
    ospecs, jospecs = opt_specs(specs), jopt_specs(jspecs)
    assert _t(ospecs.step) == _t(jospecs.step)
    assert ospecs.m is specs and ospecs.v is specs
    ts, jts = train_state_specs(model), jtrain_state_specs(jmodel)
    assert ts.params == specs and ts.opt.m == specs
    assert _t(ts.opt.step) == _t(jts.opt.step)


@pytest.mark.parametrize("arch", ARCHS)
def test_cache_specs_match_reference(arch):
    """The caches' specs in the port's layout: stacked as the reference's
    for the transformer and encdec families, a pair a layer (the stacking
    entry dropped) for the ssm and hybrid ones."""
    cfg, jcfg = reduced(get_config(arch)), jreduced(jget_config(arch))
    got, want = build_model(cfg).cache_specs(), \
        jbuild_model(jcfg).cache_specs()
    if cfg.family in ("dense", "moe", "vlm"):
        assert {k: _t(v) for k, v in got.items()} == \
            {k: _t(v) for k, v in want.items()}
    elif cfg.family == "encdec":
        assert [_t(s) for s in got] == [_t(s) for s in want]
    else:
        assert len(got) == cfg.num_layers
        for i, pair in enumerate(got):
            if cfg.family == "ssm":
                ref = want
            else:
                path, _ = _ref_path(f"layers.{i}.x", cfg)
                ref = _at(want, path[:-1])
            assert [_t(s) for s in pair] == [_t(s)[1:] for s in ref], i


@pytest.mark.parametrize("arch", ARCHS)
@pytest.mark.parametrize("batch_axes", [("data",), ("pod", "data")])
def test_input_specs_and_cells_match_reference(arch, batch_axes):
    cfg, jcfg = get_config(arch), jget_config(arch)
    assert [dataclasses.astuple(s) for s in configs.ALL_SHAPES] == \
        [dataclasses.astuple(s) for s in jbase.ALL_SHAPES]
    for shape, jshape in zip(configs.ALL_SHAPES, jbase.ALL_SHAPES,
                             strict=True):
        assert configs.shape_applicable(cfg, shape) == \
            jbase.shape_applicable(jcfg, jshape)
        got = input_partition_specs(cfg, shape, batch_axes)
        want = jinput_partition_specs(jcfg, jshape, batch_axes)
        assert {k: _t(v) for k, v in got.items()} == \
            {k: _t(v) for k, v in want.items()}


# ---------------------------------------------------------------------------
# the layout's block rule
# ---------------------------------------------------------------------------


def test_layout_splits_divisible_blocks_and_replicates_the_rest():
    """qwen3-1.7b on (2, 4): every block split, the kv heads each rank's
    query heads read; qwen2-vl-2b's 12 heads and granite's 49155-token
    vocabulary on 8 "model" ranks: replicated over "model" (the
    counterpart of XLA's uneven padding), the rest still split."""
    qwen = Sharding(get_config("qwen3-1.7b"),
                    mesh.AbstractMesh((2, 4), ("data", "model")))
    assert (qwen.attn_tp, qwen.mlp_tp, qwen.moe_ep) == (True, True, False)
    assert qwen.kv == slice(0, 2) and qwen.vocab_tp == {"embed": True}
    assert qwen.specs["layers.3.attn.wq"] == P("data", "model", None)
    assert qwen.specs["layers.3.attn.wk"] == P("data", None, None)
    vl = Sharding(get_config("qwen2-vl-2b"),
                  mesh.AbstractMesh((1, 8), ("data", "model")))
    assert not vl.attn_tp and vl.mlp_tp
    assert vl.specs["layers.0.attn.wq"] == P("data", None, None)
    assert vl.specs["layers.0.attn.bq"] == P(None, None)
    granite = Sharding(get_config("granite-moe-1b-a400m"),
                       mesh.AbstractMesh((2, 8), ("data", "model")))
    assert granite.moe_ep and granite.attn_tp
    assert granite.vocab_tp == {"embed": False}
    assert granite.specs["embed"] == P(None, "data")
    assert granite.specs["layers.0.moe.w_gate"] == P("model", "data", None)


@pytest.mark.parametrize("arch", ["falcon-mamba-7b", "recurrentgemma-9b",
                                  "whisper-medium"])
def test_waiting_families_raise_on_a_mesh(arch):
    """The ssm, hybrid and encdec families take the mesh path on any mesh
    (their blocks split over "model" where they divide); what still waits
    and raises is the pure_dp layout, whatever the family."""
    cfg = reduced(get_config(arch))
    model = build_model(cfg, mesh.AbstractMesh((2, 2), ("data", "model")))
    assert model.sharding is not None and model.serve_sharding is not None
    kind = {"ssm": "mamba", "hybrid": "rec", "encdec": "attn"}[cfg.family]
    assert model.sharding.tp[kind]
    one = build_model(cfg, mesh.AbstractMesh((1, 1), ("data", "model")))
    assert not any(one.sharding.tp.values())
    with pytest.raises(NotImplementedError, match="pure_dp"):
        build_model(dataclasses.replace(cfg, pure_dp=True),
                    mesh.AbstractMesh((2, 2), ("data", "model")))


# ---------------------------------------------------------------------------
# a world of one, with jax and repro blocked
# ---------------------------------------------------------------------------


def test_world_of_one_is_the_unsharded_step(tmp_path):
    """A gloo group of one process on a (1, 1) mesh, jax and repro
    blocked: two steps of reduced qwen3 and one of reduced granite-moe
    through the mesh path, ``torch.equal`` to the unsharded steps (loss,
    grad norm, every parameter, m and v); the state saved under the mesh
    and restored with ``restore_into(..., mesh=)`` equal leaf for leaf."""
    code = f"""
import sys
sys.modules['jax'] = None
sys.modules['repro'] = None
import dataclasses, torch
from repro_torch import checkpoint
from repro_torch.configs import get_config, reduced
from repro_torch.data import DataConfig, batch_at
from repro_torch.launch import dist
from repro_torch.launch.mesh import make_mesh
from repro_torch.launch.step import init_train_state, make_train_step
from repro_torch.models import build_model
from repro_torch.optim import OptConfig
torch.set_num_threads(1)
dist.init('gloo', init_method='file://{tmp_path}/store', rank=0,
          world_size=1)
mesh = make_mesh((1, 1), ('data', 'model'), 'cpu')
opt = OptConfig(lr=1e-3, warmup_steps=2, total_steps=10)
def run(cfg, m, steps):
    model = build_model(cfg, m)
    st = init_train_state(model, torch.Generator().manual_seed(0), 'cpu')
    fn = make_train_step(model, opt)
    dc = DataConfig(vocab_size=cfg.vocab_size, seq_len=16, global_batch=4)
    recs = []
    for s in range(steps):
        st, met = fn(st, batch_at(dc, s, 'cpu'))
        recs.append(met)
    return st, recs
def same(a, b):
    return all(torch.equal(x, y) for x, y in zip(a, b, strict=True))
for arch, steps in (('qwen3-1.7b', 2), ('granite-moe-1b-a400m', 1)):
    cfg = reduced(get_config(arch))
    (s0, r0), (s1, r1) = run(cfg, None, steps), run(cfg, mesh, steps)
    assert build_model(cfg, mesh).sharding is not None
    for a, b in zip(r0, r1, strict=True):
        assert a.keys() == b.keys() and same(a.values(), b.values()), arch
    n0 = [p for _, p in s0.params.named_parameters()]
    n1 = [p for _, p in s1.params.named_parameters()]
    assert same(n0, n1), arch
    assert same(s0.opt.m.values(), s1.opt.m.values()), arch
    assert same(s0.opt.v.values(), s1.opt.v.values()), arch
    if arch == 'qwen3-1.7b':
        checkpoint.save('{tmp_path}/ckpt', steps, s1, mesh=mesh)
        fresh = init_train_state(build_model(cfg, mesh),
                                 torch.Generator().manual_seed(1), 'cpu')
        back, man = checkpoint.restore_into('{tmp_path}/ckpt', fresh,
                                            mesh=mesh)
        assert man['step'] == steps
        a, b = checkpoint.flatten(s1), checkpoint.flatten(back)
        assert a.keys() == b.keys() and same(a.values(), b.values())
dist.destroy()
bad = [m for m in sys.modules if m == 'jax' and sys.modules[m]
       or m.startswith(('jax.', 'repro.'))]
assert not bad, bad
print('ok')
"""
    env = dict(os.environ, PYTHONPATH=str(ROOT / "src"))
    out = subprocess.run([sys.executable, "-c", code], env=env,
                         capture_output=True, text=True, timeout=300)
    assert out.returncode == 0, out.stderr[-3000:]
    assert out.stdout.strip().endswith("ok")
