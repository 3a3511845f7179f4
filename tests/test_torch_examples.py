"""The five torch twins of ``examples/`` (``examples/torch_*.py``) run to
their end on the CPU, each in a subprocess in which ``jax`` and ``repro``
cannot be imported (a directory of stand-in packages that raise on import,
first on ``PYTHONPATH``, so the spawned ranks of the elastic twin are
blocked too), at the smallest flags their counterparts are run with:

* ``torch_quickstart.py`` and ``torch_serve_swarm.py`` at their defaults;
* ``torch_train_lm.py`` at 121 steps of 4 x 32 (the failure at step 120,
  the resume from the step-100 checkpoint): the resumed run's final state
  ``torch.equal`` to an uninterrupted run's, which the script asserts;
* ``torch_swarm_simulation.py`` at CI's ``--num-runs 1 --workers 8
  --sim-time 5``: each strategy's indices (and Distributed with the early
  exit) against the reference's ``run_many`` at the same configuration and
  key, rtol 1e-5 (the fleet tests' rule);
* ``torch_elastic_rescale.py``'s ``main`` with worlds of 4, 2 and 8 ranks
  (its own are 8, 4 and 16): gloo groups on (n / 2, 2) meshes, the state
  re-sharded through the checkpoint at each change.

And the reference's swarmlint, which scans ``examples/``, finds nothing in
the twins.
"""
import dataclasses
import os
import pickle
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest

ROOT = Path(__file__).resolve().parents[1]
EXAMPLES = ROOT / "examples"
TWINS = ("torch_quickstart", "torch_train_lm", "torch_serve_swarm",
         "torch_swarm_simulation", "torch_elastic_rescale")
SWARM_FLAGS = ["--num-runs", "1", "--workers", "8", "--sim-time", "5"]


@pytest.fixture(scope="module")
def env(tmp_path_factory):
    """An environment whose ``jax`` and ``repro`` raise on import."""
    block = tmp_path_factory.mktemp("blocked")
    for name in ("jax", "repro"):
        (block / name).mkdir()
        (block / name / "__init__.py").write_text(
            f"raise ImportError('{name} is blocked: the port runs "
            f"without it')\n")
    path = os.pathsep.join([str(block), str(ROOT / "src"), str(EXAMPLES)])
    return dict(os.environ, PYTHONPATH=path, OMP_NUM_THREADS="2")


def _run(env, args, timeout=600):
    out = subprocess.run([sys.executable, *args], env=env, cwd=ROOT,
                         capture_output=True, text=True, timeout=timeout)
    assert out.returncode == 0, out.stdout[-2000:] + out.stderr[-3000:]
    return out.stdout


def test_the_block_holds(env):
    out = subprocess.run([sys.executable, "-c", "import jax"], env=env,
                         capture_output=True, text=True, timeout=60)
    assert out.returncode != 0 and "blocked" in out.stderr
    src = {t: (EXAMPLES / f"{t}.py").read_text() for t in TWINS}
    for t, text in src.items():
        assert "import jax" not in text and "from repro." not in text, t


def test_quickstart(env):
    out = _run(env, [str(EXAMPLES / "torch_quickstart.py"), "--device",
                     "cpu"])
    assert "public API round trip OK" in out
    assert out.count(" loss ") == 5


def test_train_lm_resumes_to_the_uninterrupted_state(env):
    out = _run(env, [str(EXAMPLES / "torch_train_lm.py"), "--steps", "121",
                     "--batch", "4", "--seq", "32", "--device", "cpu"])
    assert "(improved)" in out
    assert "torch.equal to an uninterrupted run's" in out


def test_serve_swarm(env):
    out = _run(env, [str(EXAMPLES / "torch_serve_swarm.py"), "--device",
                     "cpu"])
    assert "served " in out and "early exits triggered by the burst" in out


def test_swarm_simulation_matches_the_reference(env, tmp_path):
    import jax

    from repro.configs.base import SwarmConfig
    from repro.swarm import STRATEGY_NAMES, run_many
    res = tmp_path / "res.pkl"
    code = ("import pickle, sys, torch_swarm_simulation as m\n"
            f"r = m.main({SWARM_FLAGS + ['--device', 'cpu']!r})\n"
            f"pickle.dump(r, open({str(res)!r}, 'wb'))\n"
            "bad = [k for k in sys.modules if k.split('.')[0] in "
            "('jax', 'repro')]\n"
            "assert not bad, bad\n")
    out = _run(env, ["-c", code])
    assert "Distributed + congestion-aware early exit" in out
    with open(res, "rb") as f:
        got = pickle.load(f)
    cfg = dataclasses.replace(SwarmConfig(), num_workers=8, sim_time_s=5.0)
    want = {name: run_many(jax.random.PRNGKey(0), cfg, s, 8, 1)
            for s, name in enumerate(STRATEGY_NAMES)}
    want["Distributed+EE"] = run_many(
        jax.random.PRNGKey(0),
        dataclasses.replace(cfg, early_exit_enabled=True), 4, 8, 1)
    assert got.keys() == want.keys()
    for name, w in want.items():
        for k, v in w.items():
            np.testing.assert_allclose(got[name][k], np.asarray(v),
                                       rtol=1e-5, err_msg=f"{name} {k}")


def test_elastic_rescale_on_smaller_worlds(env):
    code = ("import torch_elastic_rescale as m\n"
            "a, b, c = m.main(['--device', 'cpu'], worlds=(4, 2, 8))\n"
            "assert (a['to'], b['to'], c['to']) == (10, 20, 30)\n")
    out = _run(env, ["-c", code])
    assert "elastic rescale OK" in out
    assert "8 devices, mesh {'data': 4, 'model': 2}: steps 20→30" in out


def test_reference_swarmlint_finds_nothing_in_the_twins():
    """The reference's AST tier scans ``examples/``: no finding, with or
    without its baseline, lies in a twin."""
    from repro.analysis import run
    raw = run(str(ROOT), use_baseline=False)
    assert [f for f in raw if f.file.startswith("examples/torch_")] == []
    assert run(str(ROOT)) == []
