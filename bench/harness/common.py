"""What every run shares: the cell's files found by name, the checks on the
card and on loaded modules, the caches' places, and the result line."""
from __future__ import annotations

import importlib.util
import json
import subprocess
import sys
from dataclasses import dataclass, field
from pathlib import Path
from typing import Callable, Dict, List, Optional

BENCH = Path(__file__).resolve().parents[1]
ROOT = BENCH.parent
# top-level module names no run may hold once its window has closed: the
# JAX package the port was made from, and JAX itself
FORBIDDEN = ("jax", "jaxlib", "flax", "repro")


def cache_env() -> Dict[str, str]:
    """Build and kernel caches at fixed places inside the checkout (the
    program's own kernels build into ``build/`` there already)."""
    base = ROOT / "build" / "bench_cache"
    return {"TRITON_CACHE_DIR": str(base / "triton"),
            "TORCH_EXTENSIONS_DIR": str(base / "torch_extensions"),
            "CUDA_CACHE_PATH": str(base / "cuda"),
            "USE_FLAX": "0", "USE_JAX": "0"}


def forbidden_loaded(modules=None) -> List[str]:
    """Top-level names in ``sys.modules`` (compared whole: the port's
    ``repro_torch`` is not ``repro``) that a run may not load."""
    names = {m.split(".")[0] for m in (sys.modules if modules is None
                                       else modules)}
    return sorted(names & set(FORBIDDEN))


@dataclass
class Cell:
    name: str
    workload: Dict
    model: Dict
    mix: Dict
    limits: Dict
    end_to_end: List[Dict]
    per_layer: List[Dict]
    check: Dict = field(default_factory=dict)   # the limits file, whole


def load_json(path: Path) -> Dict:
    with open(path) as f:
        return json.load(f)


def find_cell(name: str, bench_json: Optional[Path] = None) -> Cell:
    """The cell ``name`` of ``BENCHMARK.json``, its configuration file, its
    mix (``bench/mixes/<traffic>.json``), its limits
    (``bench/limits/<name>.json``), and the metrics it reports."""
    spec = load_json(bench_json or ROOT / "BENCHMARK.json")
    wl = {w["name"]: w for w in spec["workloads"]}
    if name not in wl:
        raise SystemExit(f"no workload {name!r} in BENCHMARK.json; the "
                         f"workloads are {sorted(wl)}")
    w = wl[name]
    cfg = {c["name"]: c for c in spec["configs"]}[w["config"]]
    e2e = [m for m in spec["end_to_end"]
           if name in m.get("workloads", [name])]
    moved = {m["name"] for m in e2e}
    per_layer = [m for m in spec["per_layer"]
                 if (name in m["workloads"] if "workloads" in m
                     else m["moves"] in moved)]
    check = load_json(BENCH / "limits" / f"{name}.json")
    return Cell(name, w, load_json(ROOT / cfg["file"]),
                load_json(BENCH / "mixes" / f"{w['traffic']}.json"),
                check["limits"], e2e, per_layer, check)


def reader(metric: str) -> Callable:
    """The ``read(ctx)`` of ``bench/metrics/<metric>.py``."""
    path = BENCH / "metrics" / f"{metric}.py"
    spec = importlib.util.spec_from_file_location(
        "bench_metric_" + metric.replace(".", "_"), path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod.read


def card_limit() -> str:
    """The card's name and power limit, as nvidia-smi gives them."""
    try:
        out = subprocess.run(
            ["nvidia-smi", "--query-gpu=name,power.limit",
             "--format=csv,noheader"], capture_output=True, text=True,
            timeout=20)
        return out.stdout.strip().splitlines()[0]
    except (OSError, subprocess.SubprocessError, IndexError):
        return "nvidia-smi not readable"


@dataclass
class Outcome:
    """What a driver hands back: the counts, the end-to-end and per-layer
    values, and the comparisons with their limits."""
    attempted: int
    failed: int
    end_to_end: Dict[str, float]
    ctx: Dict = field(default_factory=dict)       # what the readers read
    compared: Dict[str, Dict[str, float]] = field(default_factory=dict)
    device_extra: Dict = field(default_factory=dict)   # traced runs
    breakdown: Optional[Dict] = None
    memory_peak_bytes: int = 0
    readings: Dict[str, float] = field(default_factory=dict)  # all read

    @property
    def correct(self) -> bool:
        return verdict(self.compared)


def verdict(compared: Dict[str, Dict[str, float]]) -> bool:
    """``correct``: something was compared, and every number is within its
    limit."""
    return bool(compared) and all(
        c["value"] <= c["limit"] for c in compared.values())


def limit_between(lower: float, upper: float) -> float:
    """The rule the limits files under ``bench/limits/`` were set by: above
    the sound runs' largest reading and below the control's least, with
    more of the room above the lower."""
    return lower * (upper / lower) ** 0.6


def compare(values: Dict[str, float], limits: Dict[str, float]
            ) -> Dict[str, Dict[str, float]]:
    """Each number compared beside its limit (a missing or non-finite
    number reads infinite)."""
    out = {}
    for name, limit in limits.items():
        v = values.get(name)
        v = float("inf") if v is None or v != v else float(v)
        out[name] = {"value": v, "limit": float(limit)}
    return out


def result_line(cell: Cell, out: Outcome, trace: bool, device: Dict
                ) -> str:
    metrics = {}
    if trace:
        for m in cell.per_layer:
            v = reader(m["name"])(out.ctx)
            if v is not None:
                metrics[m["name"]] = {"value": v, "unit": m["unit"]}
    else:
        for m in cell.end_to_end:
            metrics[m["name"]] = {"value": out.end_to_end[m["name"]],
                                  "unit": m["unit"]}
    line = {"correct": out.correct, "attempted": out.attempted,
            "failed": out.failed, "metrics": metrics,
            "device": {**device, "memory_peak_bytes": out.memory_peak_bytes,
                       **(out.device_extra if trace else {})}}
    if trace and out.breakdown:
        line["breakdown"] = out.breakdown
    line["compared"] = out.compared
    return json.dumps(line)


def compared_lines(out: Outcome) -> str:
    """The numbers read but not compared, then each number compared beside
    its limit (the last lines of a run's standard error)."""
    extra = [f"{k}: {v!r} (read, not compared in this cell)"
             for k, v in out.readings.items() if k not in out.compared]
    return "\n".join(extra + [f"{k}: {c['value']!r} (limit {c['limit']!r})"
                              for k, c in out.compared.items()])
