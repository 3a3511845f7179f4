"""The port's simulator against the JAX reference, at three levels.

* Per epoch: the reference's state at epochs 0, 1 and 5 is bridged into
  the port (``repro_torch.bridge``) and one epoch is stepped in both
  packages with the same key, for all five strategies, dense and sparse.
  Integer and boolean state must be exact; floats within rtol 1e-5
  (atol 1e-6 for values that start at 0).
* Whole run (``run_many``, 3 s): counters exact and the paper indices
  within rtol 1e-5.  The differences that remain come from ulps of
  sin/cos/log10/log/pow between XLA's and ATen's CPU math (see
  test_torch_swarm.py) and from float sums taken in another order.
* Within the port: sparse lists that cover every neighbour give the dense
  result bit for bit (LocalOnly, Greedy, Distributed; the Random
  strategies draw per slot, a different stream by design).
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

from repro.configs.base import SwarmConfig as JCfg  # noqa: E402
from repro.swarm import run_many as jrun_many  # noqa: E402
from repro.swarm import simulator as jsim  # noqa: E402
from repro.swarm.tasks import make_profile as jprofile  # noqa: E402
from repro_torch import rng  # noqa: E402
from repro_torch.bridge import (key_from_numpy, state_from_numpy,  # noqa: E402
                                state_to_numpy)
from repro_torch.configs import SwarmConfig as TCfg  # noqa: E402
from repro_torch.swarm import simulator as tsim  # noqa: E402
from repro_torch.swarm.tasks import make_profile as tprofile  # noqa: E402

torch.set_num_threads(1)
N, R = 10, 2
STRATEGIES = range(5)
BASE = dict(num_workers=N, queue_slots=16, sim_time_s=3.0)
MODES = {"dense": {}, "sparse": dict(neighbor_mode="sparse",
                                     neighbor_k=N - 1)}
INT_KINDS = "biu"


def _cfgs(mode, **kw):
    j = dataclasses.replace(JCfg(), **BASE, **MODES[mode], **kw)
    return j, TCfg(**dataclasses.asdict(j))


@pytest.fixture(scope="module")
def ref_epoch():
    """Jitted reference epoch over R runs, one executable per mode."""
    cache = {}

    def get(mode):
        if mode not in cache:
            jc, _ = _cfgs(mode)
            prof = jprofile(jc)
            cache[mode] = jax.jit(jax.vmap(
                lambda s, k, i, strat: jsim._epoch(s, k, i, strat, jc, prof),
                in_axes=(0, 0, None, None)))
        return cache[mode]
    return get


def _flat(d, prefix=""):
    for k, v in d.items():
        if isinstance(v, dict):
            yield from _flat(v, f"{prefix}{k}.")
        else:
            yield f"{prefix}{k}", np.asarray(v)


def assert_states_match(got, want, what):
    want = dict(_flat(want))
    got = dict(_flat(got))
    assert sorted(got) == sorted(want), what
    for k, w in want.items():
        g = got[k]
        assert g.dtype == w.dtype and g.shape == w.shape, f"{what}: {k}"
        if w.dtype.kind in INT_KINDS:
            np.testing.assert_array_equal(g, w, err_msg=f"{what}: {k}")
        else:
            np.testing.assert_allclose(g, w, rtol=1e-5, atol=1e-6,
                                       err_msg=f"{what}: {k}")


@pytest.mark.parametrize("strategy", STRATEGIES,
                         ids=lambda s: tsim.STRATEGY_NAMES[s])
@pytest.mark.parametrize("mode", list(MODES))
def test_one_epoch_from_bridged_state(ref_epoch, mode, strategy):
    jc, tc = _cfgs(mode)
    step = ref_epoch(mode)
    keys = jax.random.split(jax.random.PRNGKey(11), R)
    k_init, k_run = jax.vmap(jax.random.split, out_axes=1)(keys)
    st = jax.vmap(lambda k: jsim.init_state(k, jc, N))(k_init)
    tprof = tprofile(tc)
    for e in range(6):
        ek = jax.vmap(lambda k, e=e: jax.random.fold_in(k, e))(k_run)
        want = step(st, ek, jnp.int32(e), jnp.int32(strategy))
        if e in (0, 1, 5):
            mine = state_from_numpy({k: v for k, v in _flat_dict(st)},
                                    device="cpu")
            tsim._epoch(mine, key_from_numpy(np.asarray(ek)), e, strategy,
                        tc, tprof)
            assert_states_match(state_to_numpy(mine), want,
                                f"{mode} {tsim.STRATEGY_NAMES[strategy]} "
                                f"epoch {e}")
        st = want


def _flat_dict(st):
    """Top-level items as numpy (nested dicts kept), for the bridge."""
    for k, v in st.items():
        if isinstance(v, dict):
            yield k, {kk: np.asarray(vv) for kk, vv in v.items()}
        else:
            yield k, np.asarray(v)


def test_init_state_matches_reference():
    jc, tc = _cfgs("dense")
    keys = jax.random.split(jax.random.PRNGKey(2), 3)
    want = jax.vmap(lambda k: jsim.init_state(k, jc, N))(keys)
    got = tsim.init_state(key_from_numpy(np.asarray(keys)), tc, N)
    assert_states_match(state_to_numpy(got), want, "init_state")
    # only F comes through normal(): 2-ulp draws, scaled by capability_std
    np.testing.assert_allclose(got["F"].numpy(), np.asarray(want["F"]),
                               rtol=1e-6)


def test_bridge_round_trip_and_run_axis():
    jc, _ = _cfgs("dense")
    st = jsim.init_state(jax.random.PRNGKey(4), jc, N)      # no run axis
    port = state_from_numpy(dict(_flat_dict(st)), device="cpu")
    assert port["q_active"].shape == (1, N, jc.queue_slots)
    assert port["tx_dst"].dtype == torch.int32
    assert port["mob"]["center"].shape == (1, N, 2)
    back = state_to_numpy(port)
    for k, v in _flat(st):
        assert np.array_equal(dict(_flat(back))[k][0], v), k
    key = key_from_numpy(np.asarray(jax.random.PRNGKey(9)))
    assert key.dtype == torch.uint32 and torch.equal(key, rng.PRNGKey(9))


@pytest.fixture(scope="module")
def whole_runs():
    out = {}
    for mode in MODES:
        jc, tc = _cfgs(mode)
        for s in STRATEGIES:
            want = jrun_many(jax.random.PRNGKey(0), jc, jnp.int32(s), N, R)
            got = tsim.run_many(rng.PRNGKey(0), tc, s, N, R, device="cpu")
            out[mode, s] = ({k: np.asarray(v) for k, v in want.items()},
                            {k: v.numpy() for k, v in got.items()})
    return out


COUNTERS = ("completed", "generated", "transfers", "transfers_delivered",
            "dropped")


@pytest.mark.parametrize("mode", list(MODES))
def test_run_many_matches_reference(whole_runs, mode):
    for s in STRATEGIES:
        want, got = whole_runs[mode, s]
        assert sorted(got) == sorted(want)
        for k in want:
            assert got[k].dtype == np.float32 and got[k].shape == (R,)
            if k in COUNTERS:
                np.testing.assert_array_equal(got[k], want[k], err_msg=k)
            else:
                np.testing.assert_allclose(got[k], want[k], rtol=1e-5,
                                           atol=1e-7, err_msg=k)
        assert np.all(got["completed"] <= got["generated"])
        if s == tsim.LOCAL_ONLY:
            assert np.all(got["transfers"] == 0)


def test_sparse_equals_dense_bit_for_bit(whole_runs):
    for s in (tsim.LOCAL_ONLY, tsim.GREEDY, tsim.DISTRIBUTED):
        dense, sparse = whole_runs["dense", s][1], whole_runs["sparse", s][1]
        for k in dense:
            np.testing.assert_array_equal(sparse[k], dense[k], err_msg=k)


def test_run_many_needs_cuda_by_default():
    if torch.cuda.is_available():
        pytest.skip("this machine has CUDA: the default device is valid")
    _, tc = _cfgs("dense")
    with pytest.raises(RuntimeError, match="CUDA"):
        tsim.run_many(rng.PRNGKey(0), tc, tsim.DISTRIBUTED, N, R)


TRACE_KEYS = {"trace_capacity": ("trace_records", "trace_overflow"),
              "trace_hop_capacity": ("trace_hops", "trace_hop_overflow"),
              "trace_state_every": ("trace_state", "trace_state_sys",
                                    "trace_state_epochs")}


def test_telemetry_streams_are_refused():
    """The telemetry streams are ported: each traced config runs and emits
    the reference's ``trace_*`` keys, with its shapes (plus the run axis)
    and dtypes, and nothing else changes."""
    plain = None
    for field, keys in TRACE_KEYS.items():
        jc, tc = (dataclasses.replace(c, sim_time_s=1.0, **{field: 4})
                  for c in _cfgs("dense"))
        want = {k: np.asarray(v) for k, v in jrun_many(
            jax.random.PRNGKey(0), jc, jnp.int32(tsim.DISTRIBUTED), N,
            R).items()}
        got = tsim.run_many(rng.PRNGKey(0), tc, tsim.DISTRIBUTED, N, R,
                            device="cpu")
        assert sorted(got) == sorted(want)
        assert sorted(k for k in got if k.startswith("trace_")) == \
            sorted(keys)
        for k in keys:
            assert got[k].shape == want[k].shape, k
            assert got[k].numpy().dtype == want[k].dtype, k
        if plain is None:
            plain = tsim.run_many(
                rng.PRNGKey(0), dataclasses.replace(tc, **{field: 0}),
                tsim.DISTRIBUTED, N, R, device="cpu")
        for k, v in plain.items():
            assert torch.equal(got[k], v), (field, k)


def test_port_imports_neither_jax_nor_repro():
    """Every module of repro_torch, found by walking the package (the
    training slice's optim, data, runtime and launch.train among them), and
    the card scripts (chip_smoke.py, tools/*.py) import with jax and repro
    blocked; a simulator run, the serving host paths, two train steps and
    a dry-run cell (``repro_torch.launch.dryrun`` on a fake world of 4)
    then run without them."""
    root = Path(__file__).resolve().parents[1]
    src = root / "src"
    mods = sorted(
        ".".join(p.relative_to(src).with_suffix("").parts).removesuffix(
            ".__init__")
        for p in (src / "repro_torch").rglob("*.py"))
    scripts = [str(root / "chip_smoke.py")] + sorted(
        str(p) for p in (root / "tools").glob("*.py"))
    code = ("import sys\n"
            "sys.modules['jax'] = None\nsys.modules['repro'] = None\n"
            "import importlib, importlib.util\n"
            f"for m in {mods!r}:\n    importlib.import_module(m)\n"
            f"for i, path in enumerate({scripts!r}):\n"
            "    spec = importlib.util.spec_from_file_location(f's{i}', path)\n"
            "    spec.loader.exec_module(importlib.util.module_from_spec(spec))\n"
            "import dataclasses\n"
            "from repro_torch import rng, trace\n"
            "from repro_torch.configs import SwarmConfig\n"
            "from repro_torch.swarm import simulator\n"
            "c = dataclasses.replace(SwarmConfig(), num_workers=6,"
            " queue_slots=8, sim_time_s=0.4, trace_capacity=64,"
            " trace_hop_capacity=64, trace_state_every=1)\n"
            "m = simulator.run_many(rng.PRNGKey(0), c, 4, 6, 2,"
            " device='cpu')\n"
            "assert trace.decode(m['trace_records'])['seq'].size == int("
            "m['completed'].sum() + m['dropped'].sum())\n"
            "assert trace.decode_state(m['trace_state'], m['trace_state_sys'],"
            " m['trace_state_epochs'])['epoch'].tolist() == [0, 1]\n"
            "from repro_torch.configs import get_config\n"
            "from repro_torch.obs import loadgen, slo\n"
            "from repro_torch.splitcompute import planner\n"
            "e = loadgen.SyntheticServeEngine(n_stages=2)\n"
            "st = loadgen.run_open_loop(e, loadgen.poisson_arrivals(500.0,"
            " 1.0), dt=0.01, max_batch=4)\n"
            "assert slo.slo_indices(st, horizon_s=e.clock, offered_rows=1)"
            "['completed'] == st.completed > 0\n"
            "assert planner.plan_and_refine(get_config('granite-moe-1b-a400m'),"
            " [400.0, 300.0])[2].boundaries[-1] == 24\n"
            "from repro_torch import data, optim, runtime\n"
            "from repro_torch.configs import reduced\n"
            "from repro_torch.launch import train\n"
            "r = train.train(reduced(get_config('qwen3-1.7b')), steps=2,"
            " batch=2, seq=8, device='cpu')\n"
            "assert int(r.state.opt.step) == 2 and len(r.records) == 2\n"
            "import torch\n"
            "from repro_torch.models import build_model\n"
            "wc = reduced(get_config('whisper-medium'))\n"
            "wm = build_model(wc)\n"
            "wp = wm.init(torch.Generator().manual_seed(0), device='cpu')\n"
            "wb = {'enc_embeds': torch.zeros(1, 24, wc.d_model),"
            " 'tokens': torch.zeros(1, 4, dtype=torch.int64),"
            " 'labels': torch.zeros(1, 4, dtype=torch.int64)}\n"
            "assert bool(torch.isfinite(wm.loss(wp, wb)[0]))\n"
            "import contextlib, io, tempfile\n"
            "from repro_torch.launch import dryrun, mesh\n"
            "dryrun.start(4)\n"
            "with contextlib.redirect_stdout(io.StringIO()):\n"
            "    rec = dryrun.run_cell('qwen3-1.7b', 'decode_32k', 'single',"
            " tempfile.mkdtemp(), cfg_override=reduced(get_config("
            "'qwen3-1.7b')), mesh=mesh.make_mesh((2, 2), ('data', 'model'),"
            " 'cpu'))\n"
            "assert rec['status'] == 'OK' and rec['flops_per_device'] > 0\n"
            "bad = [m for m in sys.modules if m == 'jax' and sys.modules[m]"
            " or m.startswith(('jax.', 'repro.'))]\n"
            "assert not bad, bad\nprint(len(" f"{mods!r}" "))\n")
    env = dict(os.environ, PYTHONPATH=str(src))
    out = subprocess.run([sys.executable, "-c", code], env=env,
                         capture_output=True, text=True, timeout=120)
    assert out.returncode == 0, out.stderr
    assert int(out.stdout.strip()) == len(mods) >= 15
    assert {"repro_torch.launch.serve", "repro_torch.models.transformer",
            "repro_torch.splitcompute.serve_engine",
            "repro_torch.kernels.flash_attention",
            "repro_torch.kernels.decode_attention",
            "repro_torch.kernels.rmsnorm", "repro_torch.kernels.rglru_scan",
            "repro_torch.kernels.mamba_scan", "repro_torch.models.rglru",
            "repro_torch.optim", "repro_torch.optim.adamw",
            "repro_torch.data", "repro_torch.data.pipeline",
            "repro_torch.runtime", "repro_torch.runtime.fault",
            "repro_torch.runtime.compression", "repro_torch.launch.train",
            "repro_torch.kernels.flash_attention_bwd",
            "repro_torch.kernels.rmsnorm_bwd", "repro_torch.launch.dryrun",
            "repro_torch.models.mamba", "repro_torch.models.ssm_lm",
            "repro_torch.models.hybrid", "repro_torch.fleet",
            "repro_torch.fleet.sweep", "repro_torch.fleet.store",
            "repro_torch.fleet.executor", "repro_torch.fleet.report",
            "repro_torch.fleet.dispatch", "repro_torch.checkpoint",
            "repro_torch.checkpoint.ckpt", "repro_torch.trace",
            "repro_torch.trace.record", "repro_torch.trace.decode",
            "repro_torch.trace.critical", "repro_torch.trace.export",
            "repro_torch.trace.aggregate", "repro_torch.models.moe",
            "repro_torch.splitcompute.planner", "repro_torch.obs",
            "repro_torch.obs.hist", "repro_torch.obs.registry",
            "repro_torch.obs.prom", "repro_torch.obs.slo",
            "repro_torch.obs.loadgen", "repro_torch.models.encdec",
            "repro_torch.kernels.rglru_scan_bwd",
            "repro_torch.kernels.mamba_scan_bwd"} <= set(mods)
