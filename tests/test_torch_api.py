"""The port's public API against the reference's: every package of the port
exports its counterpart's ``__all__`` name for name (the re-exports the
submodules' own objects), but for the reference's JAX-only names, which
have no counterpart; ``get_shape`` and ``init_congestion`` agree with the
reference's; and the package inits import in any order, without jax or
repro, and without starting an ``nvcc`` build."""
import dataclasses
import importlib
import os
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest

torch = pytest.importorskip("torch")
ROOT = Path(__file__).resolve().parents[1]
PACKAGES = ("checkpoint", "configs", "core", "data", "fleet", "kernels",
            "models", "obs", "optim", "runtime", "splitcompute", "swarm",
            "trace")
# the reference's public names that only make sense under JAX: none of
# them is in a package's __all__, and the port has none of them
JAX_ONLY = {"compat": ("shard_map",),
            "models.common": ("scan_fn", "unrolled_scan"),
            "models.transformer": ("remat_wrap", "shard_hint"),
            "launch.mesh": ("shardings",),
            "launch.dryrun": ("collective_bytes",),
            "analysis": ("JAXPR_RULE_IDS",)}


@pytest.mark.parametrize("pkg", PACKAGES)
def test_package_exports_the_reference_all(pkg):
    ref = importlib.import_module(f"repro.{pkg}")
    port = importlib.import_module(f"repro_torch.{pkg}")
    missing = [n for n in ref.__all__ if n not in port.__all__]
    assert not missing, f"repro_torch.{pkg} lacks {missing}"
    assert [n for n in port.__all__ if not hasattr(port, n)] == []
    for names in JAX_ONLY.values():
        assert not set(names) & set(ref.__all__)


def test_jax_only_names_have_no_counterpart():
    for mod, names in JAX_ONLY.items():
        ref = importlib.import_module(f"repro.{mod}")
        try:
            port = importlib.import_module(f"repro_torch.{mod}")
        except ModuleNotFoundError:
            assert mod == "compat"
            continue
        for name in names:
            assert hasattr(ref, name) and not hasattr(port, name), (mod, name)
    assert importlib.util.find_spec("repro_torch.analysis.jaxpr") is None


def test_reexports_are_the_submodules_objects():
    from repro_torch import core, swarm
    from repro_torch.core import early_exit, protocol
    from repro_torch.swarm import scenario, simulator
    for name in ("run_many", "run_sim", "STRATEGY_NAMES", "DISTRIBUTED"):
        assert getattr(swarm, name) is getattr(simulator, name)
    for name in ("register_mobility", "register_channel",
                 "register_channel_edges", "register_fault",
                 "MOBILITY_MODELS", "CHANNEL_MODELS", "CHANNEL_EDGE_MODELS",
                 "FAULT_MODELS", "get_channel_edges"):
        assert getattr(swarm, name) is getattr(scenario, name)
    assert core.init_congestion is early_exit.init_congestion
    assert core.decision_epoch is protocol.decision_epoch
    from repro_torch.kernels import ops, ref
    assert ops.__name__ == "repro_torch.kernels.ops"
    assert ref.__name__ == "repro_torch.kernels.ref"
    from repro_torch.models import input_partition_specs, input_structs
    from repro_torch.models import registry
    assert input_structs is registry.input_structs
    assert input_partition_specs is registry.input_partition_specs


def test_get_shape_agrees_with_reference():
    from repro.configs import SHAPES as JSHAPES
    from repro.configs import get_shape as jget_shape
    from repro_torch.configs import SHAPES, get_shape
    from repro_torch.launch import dryrun
    assert sorted(SHAPES) == sorted(JSHAPES)
    assert dryrun.SHAPES is SHAPES
    for name in JSHAPES:
        assert dataclasses.asdict(get_shape(name)) == dataclasses.asdict(
            jget_shape(name))
        assert get_shape(name) is SHAPES[name]
    with pytest.raises(KeyError) as want:
        jget_shape("train_1m")
    with pytest.raises(KeyError) as got:
        get_shape("train_1m")
    assert str(got.value) == str(want.value)
    assert "decode_32k" in str(got.value)


def test_init_congestion_agrees_with_reference():
    from repro.core import init_congestion as jinit
    from repro_torch.core import CongestionState, init_congestion
    want = jinit(7)
    got = init_congestion(7)
    assert isinstance(got, CongestionState)
    for g, w in zip(got, want, strict=True):
        assert g.dtype == torch.float32 and g.shape == (7,)
        np.testing.assert_array_equal(g.numpy(), np.asarray(w))
    assert got.prev_T is not got.D
    batched = init_congestion(7, (3,), device="cpu")
    assert batched.D.shape == (3, 7) and not batched.D.any()
    # the simulator's state and init_protocol hold the same thing
    from repro_torch.core import init_protocol
    st = init_protocol(torch.ones(3, 7))
    for g in st.congestion:
        assert torch.equal(g, batched.D)


def test_package_inits_import_in_any_order_without_a_build(tmp_path):
    """Each package init imported first, in a fresh interpreter with jax
    and repro blocked and a stand-in ``nvcc`` that leaves a mark if it is
    ever run: the import chain swarm -> simulator -> trace -> trace.record
    -> swarm.queues closes no cycle, and nothing is built."""
    fake = tmp_path / "cuda" / "bin"
    fake.mkdir(parents=True)
    mark = tmp_path / "nvcc_ran"
    (fake / "nvcc").write_text(f"#!/bin/sh\ntouch {mark}\nexit 1\n")
    (fake / "nvcc").chmod(0o755)
    env = dict(os.environ, PYTHONPATH=str(ROOT / "src"),
               CUDA_HOME=str(tmp_path / "cuda"), OMP_NUM_THREADS="1")
    firsts = ("repro_torch.swarm", "repro_torch.trace", "repro_torch.core",
              "repro_torch.kernels", "repro_torch.models",
              "repro_torch.fleet", "repro_torch.trace.record",
              "repro_torch.swarm.queues", "repro_torch.configs")
    code = ("import sys\n"
            "sys.modules['jax'] = None\nsys.modules['repro'] = None\n"
            "import importlib\n"
            "importlib.import_module(sys.argv[1])\n"
            "from repro_torch.swarm import (register_mobility, register_channel,"
            " register_channel_edges, register_fault, run_many,"
            " STRATEGY_NAMES)\n"
            "from repro_torch.core import init_congestion\n"
            "from repro_torch.configs import get_shape, SHAPES\n"
            "from repro_torch.models import input_structs,"
            " input_partition_specs\n"
            "from repro_torch.kernels import ops, ref, build\n"
            "libs = [v for k, m in list(sys.modules.items())"
            " if k.startswith('repro_torch.') for v in vars(m).values()"
            " if isinstance(v, build.CudaLibrary)]\n"
            "assert libs and all(lib._lib is None for lib in libs)\n")
    for i in range(0, len(firsts), 3):        # three interpreters at a time
        procs = {first: subprocess.Popen(
            [sys.executable, "-c", code, first], env=env,
            stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True)
            for first in firsts[i:i + 3]}
        for first, p in procs.items():
            _, err = p.communicate(timeout=300)
            assert p.returncode == 0, (first, err[-3000:])
    assert not mark.exists()
