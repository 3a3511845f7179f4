"""The benchmark harness: cells found by name, a cell added by new files
alone, the result line's keys, no run without a card, no JAX in a run.

    PYTHONPATH=src python -m pytest -q bench/tests/test_bench_harness.py

The ``cuda``-marked test runs a cell on the card and skips elsewhere.
"""
from __future__ import annotations

import hashlib
import json
import os
import shutil
import subprocess
import sys
from pathlib import Path

import pytest

import bench_tiny  # noqa: F401  (puts bench/ and src/ on sys.path)
from harness import common  # noqa: E402

ROOT = common.ROOT
SPEC = json.loads((ROOT / "BENCHMARK.json").read_text())
CELLS = [w["name"] for w in SPEC["workloads"]]
CONTRACT_KEYS = {"correct", "attempted", "failed", "metrics", "device"}


@pytest.mark.parametrize("name", CELLS)
def test_every_cell_finds_its_files_by_name(name):
    cell = common.find_cell(name)
    w = cell.workload
    assert (common.BENCH / "mixes" / f"{w['traffic']}.json").exists()
    assert (common.BENCH / "limits" / f"{name}.json").exists()
    assert cell.model["name"] == w["config"]
    assert cell.mix["driver"] in ("train", "split")
    assert cell.limits and all(v > 0 for v in cell.limits.values())
    e2e = {m["name"] for m in cell.end_to_end}
    assert "setup_s" in e2e and len(e2e) >= 2
    assert cell.per_layer
    for m in cell.per_layer:
        assert m["moves"] in e2e
        assert callable(common.reader(m["name"]))
    if cell.mix["driver"] == "split":
        assert cell.model["serve"]["knee_hz"] > 0


def test_every_metric_file_is_named_in_the_benchmark():
    names = {m["name"] for m in SPEC["per_layer"]}
    files = {p.name[:-3] for p in (common.BENCH / "metrics").glob("*.py")}
    assert files == names


def _digest(root: Path):
    return {str(p.relative_to(root)): hashlib.sha256(p.read_bytes()
                                                     ).hexdigest()
            for p in sorted(root.rglob("*")) if p.is_file()
            and "__pycache__" not in p.parts}


def test_a_cell_is_added_by_new_files_alone(tmp_path):
    shutil.copytree(common.BENCH, tmp_path / "bench",
                    ignore=shutil.ignore_patterns("__pycache__"))
    before = _digest(tmp_path / "bench")
    b = tmp_path / "bench"
    mix = json.loads((b / "mixes" / "split-steady.json").read_text())
    mix["rate_x_knee"] = 0.5
    (b / "mixes" / "split-light.json").write_text(json.dumps(mix))
    (b / "limits" / "split.granite-moe-1b-a400m.light.json").write_text(
        json.dumps({"limits": {"logit_gap": 1.0}}))
    (b / "metrics" / "queue_ms.light.py").write_text(
        "def read(ctx):\n    return 1.0\n")
    spec = json.loads(json.dumps(SPEC))
    spec["workloads"].append({"name": "split.granite-moe-1b-a400m.light",
                              "config": "granite-moe-1b-a400m",
                              "traffic": "split-light", "chips": 1,
                              "why": "a test cell"})
    spec["per_layer"].append({"name": "queue_ms.light", "unit": "ms",
                              "better": "lower", "source": "host_clock",
                              "layer": "splitcompute.serve_engine",
                              "moves": "serve_tokens_per_s"})
    for m in spec["end_to_end"]:
        if m["name"] == "serve_tokens_per_s":
            m["workloads"].append("split.granite-moe-1b-a400m.light")
    (tmp_path / "BENCHMARK.json").write_text(json.dumps(spec))
    code = ("import sys; sys.path.insert(0, sys.argv[1]);"
            "from harness.common import find_cell, reader;"
            "c = find_cell('split.granite-moe-1b-a400m.light');"
            "print(c.mix['rate_x_knee'], c.model['name'], c.limits,"
            " sorted(m['name'] for m in c.per_layer),"
            " reader('queue_ms.light')({}))")
    out = subprocess.run([sys.executable, "-c", code, str(b)],
                         capture_output=True, text=True, timeout=120)
    assert out.returncode == 0, out.stderr
    assert out.stdout.startswith("0.5 granite-moe-1b-a400m")
    assert "queue_ms.light" in out.stdout and out.stdout.strip()[-3:] == "1.0"
    after = _digest(b)
    assert {k: v for k, v in after.items() if k in before} == before


def _outcome():
    return common.Outcome(attempted=3, failed=0,
                          end_to_end={"train_tokens_per_s": 1.5,
                                      "setup_s": 2.5},
                          ctx={"kind": "train", "window_s": 1.0,
                               "model_flops": 1e12},
                          compared={"loss_gap": {"value": 0.1,
                                                 "limit": 0.2}},
                          device_extra={"busy_s": 0.5, "window_s": 1.0},
                          breakdown={"device_ops": [["k", 0.4]],
                                     "idle_gaps": [["aten::mm", 0.1]]},
                          memory_peak_bytes=7)


@pytest.mark.parametrize("trace", [False, True])
def test_the_last_line_has_the_contract_keys(trace):
    cell = common.find_cell("train.qwen3-1.7b.seq4k")
    line = json.loads(common.result_line(
        cell, _outcome(), trace, {"platform": "gpu", "kind": "k",
                                  "count": 1}))
    assert CONTRACT_KEYS <= set(line)
    assert set(line) - CONTRACT_KEYS == ({"compared", "breakdown"} if trace
                                         else {"compared"})
    assert list(line)[-1] == "compared"
    assert {"platform", "kind", "count", "memory_peak_bytes"} <= set(
        line["device"])
    if trace:
        assert {"busy_s", "window_s"} <= set(line["device"])
        assert set(line["metrics"]) <= {m["name"] for m in cell.per_layer}
        assert "mfu.train" in line["metrics"]
    else:
        assert set(line["metrics"]) == {"train_tokens_per_s", "setup_s"}
    assert all(set(v) == {"value", "unit"} for v in line["metrics"].values())
    assert line["correct"] is True


def test_a_run_with_no_card_fails_and_prints_no_result():
    env = dict(os.environ, CUDA_VISIBLE_DEVICES="")
    out = subprocess.run([sys.executable, str(common.BENCH / "run.py"),
                          "--workload", CELLS[0], "--seed", "3000000001",
                          "--seconds", "1", "--trace", "0"],
                         capture_output=True, text=True, timeout=300,
                         env=env, cwd=ROOT)
    assert out.returncode != 0
    assert out.stdout.strip() == ""
    assert "CUDA" in out.stderr


def test_forbidden_modules_are_compared_by_whole_name():
    assert common.forbidden_loaded({"repro_torch": 1, "repro_torch.x": 1,
                                    "reprox": 1, "torch": 1}) == []
    assert common.forbidden_loaded({"repro.core": 1, "jax": 1,
                                    "jaxlib.xla": 1}) == ["jax", "jaxlib",
                                                          "repro"]


@pytest.mark.parametrize("name", ["train.qwen3-1.7b.seq4k",
                                  "split.qwen3-1.7b.steady"])
def test_a_run_loads_no_jax(name):
    code = ("import sys, json; sys.path.insert(0, sys.argv[1]);"
            "import bench_tiny; from harness.common import forbidden_loaded;"
            f"out = bench_tiny.run_tiny({name!r}, seconds=1.5);"
            "print(json.dumps([forbidden_loaded(), out.correct]))")
    out = subprocess.run([sys.executable, "-c", code,
                          str(Path(__file__).parent)], capture_output=True,
                         text=True, timeout=600, cwd=ROOT)
    assert out.returncode == 0, out.stderr[-2000:]
    loaded, correct = json.loads(out.stdout.strip().splitlines()[-1])
    assert loaded == [] and correct in (True, False)


@pytest.mark.cuda
def test_a_cell_runs_on_the_card():
    import torch
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    out = subprocess.run([sys.executable, str(common.BENCH / "run.py"),
                          "--workload", CELLS[0], "--seed", "2147483999",
                          "--seconds", "5", "--trace", "0"],
                         capture_output=True, text=True, timeout=900,
                         cwd=ROOT)
    assert out.returncode == 0, out.stderr[-4000:]
    line = json.loads(out.stdout.strip().splitlines()[-1])
    assert line["correct"] is True and line["device"]["platform"] == "gpu"
