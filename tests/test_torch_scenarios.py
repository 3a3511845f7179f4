"""The port's scenario plug-in registry (``repro_torch.swarm.register_*``)
against the reference's (``repro.swarm.register_*``):

* the twins of tests/test_scenarios.py's registry tests, a duplicate name
  of each kind refused, and ``get_channel_edges``'s message;
* toy third-party models (``torch_scenario_models.py``) registered in both
  packages, the reference's per run in ``jnp``, the port's batched:
  ``run_many`` dense and sparse under the simulator's rule (counters
  exact, floats rtol 1e-5 / atol 1e-6), every strategy;
* the built-in callables under new names, ``torch.equal`` to the built-in
  names on the ``vmap``, ``streaming`` and ``sharded`` backends with the
  three telemetry streams on;
* a script that registers at module level and sweeps over two spawned
  workers (``torch_scenario_dispatch.py``): its report is byte-identical
  to ``execute``'s, and a model registered inside ``main`` does not reach
  the workers.

Every model a test registers is removed again in its fixture's teardown:
the registries are shared by every test file a worker process runs.
"""
import dataclasses
import os
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest

torch = pytest.importorskip("torch")
import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

import repro.swarm as jswarm  # noqa: E402
import repro_torch.swarm as tswarm  # noqa: E402
import torch_scenario_models as toys  # noqa: E402
from repro.configs.base import SwarmConfig as JCfg  # noqa: E402
from repro_torch import rng  # noqa: E402
from repro_torch.bridge import key_from_numpy  # noqa: E402
from repro_torch.configs import SwarmConfig as TCfg  # noqa: E402
from repro_torch.fleet import run_batch  # noqa: E402
from repro_torch.swarm import scenario as tsc  # noqa: E402

torch.set_num_threads(1)
ROOT = Path(__file__).resolve().parents[1]
N, R = 10, 2
BASE = dict(num_workers=N, queue_slots=16, sim_time_s=3.0)
MODES = {"dense": {}, "sparse": dict(neighbor_mode="sparse",
                                     neighbor_k=N - 1)}
COUNTERS = ("completed", "generated", "transfers", "transfers_delivered",
            "dropped")
TRACE = dict(trace_capacity=256, trace_hop_capacity=64, trace_state_every=2,
             trace_state_nodes=4)
BUILTINS = {
    "MOBILITY_MODELS": {"circular", "random_waypoint", "gauss_markov",
                        "levy_flight"},
    "CHANNEL_MODELS": {"two_ray", "free_space", "log_normal",
                       "log_normal_corr", "rician", "nakagami"},
    "CHANNEL_EDGE_MODELS": {"two_ray", "free_space", "log_normal",
                            "rician", "nakagami"},
    "FAULT_MODELS": {"none", "markov"}}


def _cfgs(mode="dense", **kw):
    j = dataclasses.replace(JCfg(), **BASE, **MODES[mode], **kw)
    return j, TCfg(**dataclasses.asdict(j))


@pytest.fixture(scope="module")
def port_toys():
    undo = toys.register(tswarm, toys.port_toys())
    yield
    undo()


@pytest.fixture(scope="module")
def both_toys(port_toys):
    undo = toys.register(jswarm, toys.reference_toys())
    yield
    undo()


@pytest.fixture(scope="module")
def aliases():
    undo = toys.register(tswarm, toys.port_aliases())
    yield
    undo()


# ---------------------------------------------------------------------------
# the registries (tests/test_scenarios.py:28-58)
# ---------------------------------------------------------------------------


def test_registry_roundtrip():
    assert set(tswarm.MOBILITY_MODELS) == BUILTINS["MOBILITY_MODELS"]
    assert set(tswarm.CHANNEL_MODELS) == BUILTINS["CHANNEL_MODELS"]
    assert set(tswarm.FAULT_MODELS) == BUILTINS["FAULT_MODELS"]
    for name in tswarm.MOBILITY_MODELS:
        cfg = dataclasses.replace(TCfg(), mobility_model=name)
        assert tswarm.get_mobility(cfg) is tswarm.MOBILITY_MODELS[name]
    for name in tswarm.CHANNEL_MODELS:
        cfg = dataclasses.replace(TCfg(), channel_model=name)
        assert tswarm.get_channel(cfg) is tswarm.CHANNEL_MODELS[name]
    for name in tswarm.FAULT_MODELS:
        cfg = dataclasses.replace(TCfg(), fault_model=name)
        assert tswarm.get_fault(cfg) is tswarm.FAULT_MODELS[name]


def test_registry_unknown_key_raises_with_known_keys():
    cfg = dataclasses.replace(TCfg(), mobility_model="brownian")
    with pytest.raises(KeyError, match="circular"):
        tswarm.get_mobility(cfg)
    cfg = dataclasses.replace(TCfg(), channel_model="weibull")
    with pytest.raises(KeyError, match="two_ray"):
        tswarm.get_channel(cfg)
    cfg = dataclasses.replace(TCfg(), fault_model="byzantine")
    with pytest.raises(KeyError, match="markov"):
        tswarm.get_fault(cfg)


@pytest.mark.parametrize("kind,name", [
    ("mobility", "circular"), ("channel", "two_ray"),
    ("channel_edges", "two_ray"), ("fault", "markov")])
def test_duplicate_name_raises(kind, name):
    registry = getattr(tswarm, toys.REGISTRIES[kind])
    before = dict(registry)
    fns = (lambda *a: None,) * (2 if kind in ("mobility", "fault") else 1)
    label = "edge channel" if kind == "channel_edges" else kind
    with pytest.raises(ValueError, match=f"duplicate {label} model '{name}'"):
        getattr(tswarm, f"register_{kind}")(name, *fns)
    assert registry == before
    # the reference refuses the same names with the same message
    with pytest.raises(ValueError) as want:
        getattr(jswarm, f"register_{kind}")(name, *fns)
    with pytest.raises(ValueError) as got:
        getattr(tswarm, f"register_{kind}")(name, *fns)
    assert str(got.value) == str(want.value)


def test_register_returns_what_it_registered():
    models = toys.port_toys()
    (_, mob), (_, (ch,)), (_, (edges,)), (_, fault) = (
        models[k] for k in ("mobility", "channel", "channel_edges", "fault"))
    try:
        assert tswarm.register_mobility("t_mob", *mob) == tsc.MobilityModel(
            *mob)
        assert tswarm.register_channel("t_ch", ch) is ch
        assert tswarm.register_channel_edges("t_ch", edges) is edges
        assert tswarm.register_fault("t_fault", *fault) == tsc.FaultModel(
            *fault)
        _, tc = _cfgs("sparse", mobility_model="t_mob", channel_model="t_ch",
                      fault_model="t_fault")
        assert tswarm.get_mobility(tc).step is mob[1]
        assert tswarm.get_channel(tc) is ch
        assert tswarm.get_channel_edges(tc) is edges
        assert tswarm.get_fault(tc).init is fault[0]
    finally:
        for reg, name in (("MOBILITY_MODELS", "t_mob"),
                          ("CHANNEL_MODELS", "t_ch"),
                          ("CHANNEL_EDGE_MODELS", "t_ch"),
                          ("FAULT_MODELS", "t_fault")):
            getattr(tswarm, reg).pop(name, None)
    assert not [k for reg in BUILTINS for k in getattr(tswarm, reg)
                if k.startswith("t_")]


def test_get_channel_edges_message():
    """A channel without an edge model raises ``KeyError`` with the
    reference's message: the registered edge models and
    ``register_channel_edges()``.  ``log_normal_corr`` is such a channel,
    and so is a third-party one registered dense only, on which the sparse
    path refuses to run (no fallback to dense)."""
    jc, tc = _cfgs("sparse", channel_model="log_normal_corr")
    with pytest.raises(KeyError) as want:
        jswarm.get_channel_edges(jc)
    with pytest.raises(KeyError) as got:
        tswarm.get_channel_edges(tc)
    assert str(got.value) == str(want.value)
    for word in ("log_normal_corr", "nakagami", "register_channel_edges()",
                 "neighbor_mode='dense'"):
        assert word in str(got.value)
    (_, (ch,)) = toys.port_toys()["channel"]
    tswarm.register_channel("t_dense_only", ch)
    try:
        _, tc = _cfgs("sparse", channel_model="t_dense_only")
        with pytest.raises(KeyError, match="'t_dense_only' has no per-edge"):
            tswarm.run_many(rng.PRNGKey(0), tc, tswarm.DISTRIBUTED, N, R,
                            device="cpu")
        _, tc = _cfgs("dense", channel_model="t_dense_only")
        m = tswarm.run_many(rng.PRNGKey(0), tc, tswarm.DISTRIBUTED, N, R,
                            device="cpu")
        assert bool(torch.isfinite(m["fom"]).all())
    finally:
        tswarm.CHANNEL_MODELS.pop("t_dense_only")


# ---------------------------------------------------------------------------
# toy third-party models in both packages
# ---------------------------------------------------------------------------


@pytest.fixture(scope="module")
def toy_runs(both_toys):
    out = {}
    for mode in MODES:
        jc, tc = _cfgs(mode, **toys.TOY)
        for s in range(5):
            want = jswarm.run_many(jax.random.PRNGKey(0), jc, jnp.int32(s),
                                   N, R)
            got = tswarm.run_many(rng.PRNGKey(0), tc, s, N, R, device="cpu")
            out[mode, s] = ({k: np.asarray(v) for k, v in want.items()},
                            {k: v.numpy() for k, v in got.items()})
    return out


@pytest.mark.parametrize("strategy", range(5),
                         ids=lambda s: tswarm.STRATEGY_NAMES[s])
@pytest.mark.parametrize("mode", list(MODES))
def test_toy_models_match_reference(toy_runs, mode, strategy):
    want, got = toy_runs[mode, strategy]
    assert sorted(got) == sorted(want)
    for k in want:
        assert got[k].dtype == np.float32 and got[k].shape == (R,)
        if k in COUNTERS:
            np.testing.assert_array_equal(got[k], want[k], err_msg=k)
        else:
            np.testing.assert_allclose(got[k], want[k], rtol=1e-5,
                                       atol=1e-6, err_msg=k)
    if strategy != tswarm.LOCAL_ONLY:
        # the toys do something: links come and go, transfers happen
        assert got["transfers"].sum() > 0, mode


def test_toy_sparse_equals_dense_bit_for_bit(toy_runs):
    """Lists that cover every neighbour give the dense result under the
    third-party channel's edge model, as under the built-ins."""
    for s in (tswarm.LOCAL_ONLY, tswarm.GREEDY, tswarm.DISTRIBUTED):
        dense, sparse = toy_runs["dense", s][1], toy_runs["sparse", s][1]
        for k in dense:
            np.testing.assert_array_equal(sparse[k], dense[k], err_msg=k)


def test_toy_models_per_call_match_reference(both_toys):
    """Each toy callable against its reference twin, run by run."""
    jc, tc = _cfgs("dense", **toys.TOY)
    keys = jax.random.split(jax.random.PRNGKey(3), R)
    tkeys = key_from_numpy(np.asarray(keys))
    jm, tm = jswarm.get_mobility(jc), tswarm.get_mobility(tc)
    jst = jax.vmap(lambda k: jm.init(k, jc, N))(keys)
    tst = tm.init(tkeys, tc, N)
    np.testing.assert_array_equal(tst["pos"].numpy(), np.asarray(jst["pos"]))
    jst, jpos = jax.vmap(lambda s, k: jm.step(s, k, jc, 0.0))(jst, keys)
    tst, tpos = tm.step(tst, tkeys, tc, 0.0)
    np.testing.assert_array_equal(tpos.numpy(), np.asarray(jpos))
    np.testing.assert_array_equal(tst["pos"].numpy(), np.asarray(jst["pos"]))
    dist = np.random.default_rng(0).uniform(0, 2e4, (R, N, N)).astype(
        np.float32)
    np.testing.assert_array_equal(
        tswarm.get_channel(tc)(tkeys, torch.from_numpy(dist), tc).numpy(),
        np.asarray(jax.vmap(lambda k, d: jswarm.get_channel(jc)(k, d, jc))(
            keys, dist)))
    jf, tf = jswarm.get_fault(jc), tswarm.get_fault(tc)
    alive = np.random.default_rng(1).uniform(size=(R, N)) < 0.7
    np.testing.assert_array_equal(
        tf.step(torch.from_numpy(alive), tkeys, tc).numpy(),
        np.asarray(jax.vmap(lambda a, k: jf.step(a, k, jc))(alive, keys)))


# ---------------------------------------------------------------------------
# aliases of the built-ins on every backend, traced
# ---------------------------------------------------------------------------


BACKENDS = {"vmap": {}, "streaming": dict(chunk_size=2),
            "sharded": dict(devices=["cpu", "cpu"])}


@pytest.mark.parametrize("backend", list(BACKENDS))
def test_aliases_equal_builtins(aliases, backend):
    for mode in MODES:
        for s in (tswarm.RANDOM, tswarm.DISTRIBUTED):
            runs = {}
            for names in (toys.ALIAS, toys.BUILTIN):
                _, tc = _cfgs(mode, **names, **TRACE)
                runs[names["mobility_model"]] = run_batch(
                    rng.PRNGKey(0), tc, s, N, 3, backend=backend,
                    device="cpu", **BACKENDS[backend])
            got, want = runs["alias_circular"], runs["circular"]
            assert sorted(got) == sorted(want)
            assert any(k.startswith("trace_") for k in got)
            for k, v in want.items():
                if not k.startswith("_"):
                    assert torch.equal(got[k], v), (mode, s, k)


# ---------------------------------------------------------------------------
# module-level registration through spawned workers
# ---------------------------------------------------------------------------


def test_spawned_workers_see_module_level_models(tmp_path):
    env = dict(os.environ, PYTHONPATH=os.pathsep.join(
        [str(ROOT / "src"), str(ROOT / "tests")]), OMP_NUM_THREADS="1",
        REPRO_CODE_VERSION="test-scenarios")
    script = str(ROOT / "tests" / "torch_scenario_dispatch.py")
    for args in ([], ["--late"]):
        out = subprocess.run(
            [sys.executable, script, str(tmp_path / "+".join(args or ["ok"])),
             "--device", "cpu", *args], env=env, cwd=ROOT,
            capture_output=True, text=True, timeout=600)
        assert out.returncode == 0, out.stdout[-2000:] + out.stderr[-3000:]
        assert "byte-identical" in out.stdout if not args else \
            "did not reach the workers" in out.stdout
