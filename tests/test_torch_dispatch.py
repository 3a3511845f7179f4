"""The port's multi-process dispatch (``repro_torch.fleet.dispatch``) on the
CPU, after tests/test_dispatch.py and at its sizes (6 UAVs, 1 s): the spec
JSON contract, lease claim/renew/steal, rank-strided claim order, the
``REPRO_FLEET_*`` env contract, the progress surface, and the acceptance
properties — a two-worker spawned dispatch gives a report JSON
byte-identical to a single process, and a worker killed mid-sweep is
survivable: a redispatch resumes from the store to an identical file.
Spawned workers run with ``device="cpu"``.
"""
import dataclasses
import importlib
import json
import os
import time

import pytest

torch = pytest.importorskip("torch")

from repro_torch.configs import SwarmConfig  # noqa: E402
from repro_torch.fleet import (ResultStore, SweepSpec, build_report,  # noqa: E402
                               collect, dispatch, execute, point_digest,
                               progress_summary, publish_spec, read_progress,
                               render_progress, run_sweep, run_worker,
                               spawn_workers, worker_env, write_bench_json)
from repro_torch.fleet.dispatch import claim_order  # noqa: E402
from repro_torch.fleet.store import code_version  # noqa: E402

# the module, which the package's ``dispatch`` function shadows
tdispatch = importlib.import_module("repro_torch.fleet.dispatch")
torch.set_num_threads(1)
CFG = dataclasses.replace(SwarmConfig(), sim_time_s=1.0, num_workers=6)
SPEC = SweepSpec.build("disp", CFG, axes={"gamma": (0.02, 0.1)},
                       strategies=(0, 4), num_runs=3)
SPEC_KILL = SweepSpec.build("dispkill", CFG, axes={"gamma": (0.02, 0.1)},
                            strategies=(0, 2, 4), num_runs=3)
CPU = dict(device="cpu")


@pytest.fixture(scope="module", autouse=True)
def _pinned_code_version():
    """Digests must agree between this process and spawned workers (which
    inherit os.environ), and must not drift with the working tree."""
    old = os.environ.get("REPRO_CODE_VERSION")
    os.environ["REPRO_CODE_VERSION"] = "test-dispatch"
    code_version.cache_clear()
    yield
    if old is None:
        del os.environ["REPRO_CODE_VERSION"]
    else:
        os.environ["REPRO_CODE_VERSION"] = old
    code_version.cache_clear()


def _bench_bytes(path, res):
    write_bench_json(path, "sweep:cmp", build_report(res))
    with open(path, "rb") as f:
        return f.read()


@pytest.fixture(scope="module")
def ref_bytes(tmp_path_factory):
    """Single-process report bytes for both sweep specs."""
    d = tmp_path_factory.mktemp("ref")
    return {
        "disp": _bench_bytes(str(d / "a.json"), execute(SPEC, **CPU)),
        "dispkill": _bench_bytes(str(d / "b.json"),
                                 execute(SPEC_KILL, **CPU)),
    }


# ---------------------------------------------------------------------------
# spec JSON contract + scheduling + env contract (in-process, fast)
# ---------------------------------------------------------------------------


def test_spec_json_roundtrip_preserves_digests():
    spec = SweepSpec.build(
        "rt", CFG,
        axes={"gamma": (0.02, 0.1),
              "scenario": (("base", {}),
                           ("rwp", {"mobility_model": "random_waypoint"}))},
        strategies=(0, 4), num_runs=3, seed=7)
    spec2 = SweepSpec.from_json(spec.to_json())
    assert spec2 == spec
    assert [point_digest(p) for p in spec2.expand()] == \
           [point_digest(p) for p in spec.expand()]
    assert spec.to_json() == spec2.to_json()


def test_spec_json_restores_tuple_fields_in_overrides():
    spec = SweepSpec.build(
        "tup", CFG,
        axes={"ee": (("deep", {"exit_points": (10, 30, 60)}),)},
        strategies=(4,), num_runs=2)
    (pt,) = SweepSpec.from_json(spec.to_json()).expand()
    assert pt.cfg.exit_points == (10, 30, 60)
    hash(pt.cfg)
    assert point_digest(pt) == point_digest(spec.expand()[0])


def test_publish_spec_and_load_by_name(tmp_path):
    store = ResultStore(str(tmp_path))
    path = publish_spec(SPEC, store)
    assert path.endswith(os.path.join("sweeps", "disp.json"))
    assert tdispatch._load_spec("disp", store) == SPEC
    assert tdispatch._load_spec(path, store) == SPEC
    with pytest.raises(FileNotFoundError):
        tdispatch._load_spec("missing", store)


def test_lease_claim_renew_and_steal(tmp_path):
    store = ResultStore(str(tmp_path))
    d = "ab" + "0" * 62
    assert store.try_claim(d, "w0", ttl_s=60)
    assert store.lease_info(d)["owner"] == "w0"
    assert not store.try_claim(d, "w1", ttl_s=60)   # live lease holds
    assert store.renew_lease(d, "w0", ttl_s=60)
    assert not store.renew_lease(d, "w1", ttl_s=60)  # not the owner
    store.release_lease(d)
    assert store.lease_info(d) is None
    # an expired lease is stolen by the next claimer
    assert store.try_claim(d, "w1", ttl_s=0.05)
    time.sleep(0.1)
    assert store.try_claim(d, "w2", ttl_s=60)
    assert store.lease_info(d)["owner"] == "w2"
    # owner-checked release: the robbed worker can't unlink the stealer's
    store.release_lease(d, owner="w1")
    assert store.lease_info(d)["owner"] == "w2"
    store.release_lease(d, owner="w2")
    assert store.lease_info(d) is None


def test_claim_order_shards_then_steals():
    assert claim_order(5, 0, 2) == [0, 2, 4, 1, 3]
    assert claim_order(5, 1, 2) == [1, 3, 0, 2, 4]
    for r in range(3):
        assert sorted(claim_order(7, r, 3)) == list(range(7))
    assert claim_order(4, 0, 1) == [0, 1, 2, 3]


def test_worker_env_contract(monkeypatch):
    for v in ("REPRO_FLEET_WORLD_SIZE", "REPRO_FLEET_RANK",
              "REPRO_FLEET_HOSTS", "REPRO_FLEET_COORD"):
        monkeypatch.delenv(v, raising=False)
    assert worker_env() == worker_env()
    assert worker_env().world == 1 and worker_env().rank == 0
    assert not tdispatch.maybe_init_distributed(worker_env())
    monkeypatch.setenv("REPRO_FLEET_HOSTS", "h0,h1,h2")
    monkeypatch.setenv("REPRO_FLEET_RANK", "2")
    env = worker_env()
    assert (env.rank, env.world) == (2, 3)
    monkeypatch.setenv("REPRO_FLEET_WORLD_SIZE", "4")  # overrides roster
    assert worker_env().world == 4
    monkeypatch.setenv("REPRO_FLEET_COORD", "h0:9876")
    assert worker_env().coordinator == "h0:9876"
    monkeypatch.setenv("REPRO_FLEET_RANK", "4")        # out of range
    with pytest.raises(ValueError, match="bad fleet env"):
        worker_env()


def test_progress_summary_and_render(tmp_path):
    path = str(tmp_path / "p.jsonl")
    rows = [{"event": "sweep_start", "sweep": "s", "total": 4, "t": 0.0},
            {"event": "point", "digest": "d0", "label": "a", "t": 30.0},
            {"event": "point", "digest": "d1", "label": "b", "t": 60.0},
            {"event": "point", "digest": "d1", "label": "b", "t": 60.0}]
    with open(path, "w") as f:
        for r in rows:
            f.write(json.dumps(r) + "\n")
        f.write('{"torn')                      # live-writer tail: skipped
    s = progress_summary(read_progress(path))
    assert (s["completed"], s["total"]) == (2, 4)     # digest-deduped
    assert s["points_per_min"] == pytest.approx(2.0)
    assert s["eta_s"] == pytest.approx(60.0)
    assert "2/4" in render_progress(s) and "ETA" in render_progress(s)
    assert progress_summary([]) is None
    assert render_progress(None) == "no sweep in progress file yet"
    rows_null = [{"event": "sweep_start", "sweep": "s", "total": 2,
                  "t": 0.0},
                 {"event": "point", "digest": None, "label": "a", "t": 1.0},
                 {"event": "point", "digest": None, "label": "b", "t": 2.0}]
    s2 = progress_summary(rows_null)
    assert (s2["completed"], s2["total"]) == (2, 2)


# ---------------------------------------------------------------------------
# in-process worker: max_points interrupt + resume, rank striding
# ---------------------------------------------------------------------------


def test_interrupted_worker_resumes_from_store(tmp_path, ref_bytes):
    store = ResultStore(str(tmp_path / "cache"))
    assert run_worker(SPEC, store, max_points=1, **CPU) == 1
    with pytest.raises(RuntimeError, match="redispatch to resume"):
        collect(SPEC, store)
    res = dispatch(SPEC, store, workers=1, **CPU)
    assert _bench_bytes(str(tmp_path / "b.json"), res) == ref_bytes["disp"]


def test_two_sequential_ranks_complete_via_stealing(tmp_path, ref_bytes):
    """World of two, but rank 1 never shows up: rank 0 walks its own shard
    first, then steals the absentee's unleased points."""
    store = ResultStore(str(tmp_path / "cache"))
    run_worker(SPEC, store, rank=0, world=2, **CPU)
    res = collect(SPEC, store)
    assert _bench_bytes(str(tmp_path / "b.json"), res) == ref_bytes["disp"]


def test_run_sweep_follows_the_env_contract(tmp_path, ref_bytes,
                                            monkeypatch):
    """Rank 0 of a world of one by the env: a local dispatch; the CLI runs
    a published spec by name."""
    for v in ("REPRO_FLEET_WORLD_SIZE", "REPRO_FLEET_RANK",
              "REPRO_FLEET_HOSTS", "REPRO_FLEET_COORD"):
        monkeypatch.delenv(v, raising=False)
    store = ResultStore(str(tmp_path / "cache"))
    res = run_sweep(SPEC, store, **CPU)
    assert _bench_bytes(str(tmp_path / "a.json"), res) == ref_bytes["disp"]
    store2 = ResultStore(str(tmp_path / "cache2"))
    publish_spec(SPEC, store2)
    tdispatch.main(["--spec", "disp", "--store", store2.root,
                    "--device", "cpu"])
    assert _bench_bytes(str(tmp_path / "b.json"),
                        collect(SPEC, store2)) == ref_bytes["disp"]


# ---------------------------------------------------------------------------
# acceptance: spawned workers (multiprocessing 'spawn')
# ---------------------------------------------------------------------------


def test_two_worker_dispatch_bit_identical_to_single_process(
        tmp_path, ref_bytes):
    store = ResultStore(str(tmp_path / "cache"))
    prog = str(tmp_path / "progress.jsonl")
    res = dispatch(SPEC, store, workers=2, progress_path=prog, **CPU)
    assert _bench_bytes(str(tmp_path / "b.json"), res) == ref_bytes["disp"]
    rows = read_progress(prog)
    s = progress_summary(rows)
    assert (s["completed"], s["total"]) == (len(SPEC.expand()),
                                            len(SPEC.expand()))
    pts = [r for r in rows if r["event"] == "point"]
    assert all(r["wall_s"] >= 0 and r["worker"] for r in pts)
    assert {r["worker"].rsplit(":", 1)[1] for r in pts} <= {"r0", "r1"}


def test_killed_worker_mid_sweep_then_redispatch_is_identical(
        tmp_path, ref_bytes):
    store = ResultStore(str(tmp_path / "cache"))
    prog = str(tmp_path / "progress.jsonl")
    (proc,) = spawn_workers(SPEC_KILL, store.root, 1, lease_ttl_s=2.0,
                            progress_path=prog, **CPU)
    try:
        # SIGKILL as soon as the first point lands: mid-sweep, possibly
        # mid-claim — whatever lease survives must expire into a steal
        deadline = time.time() + 300
        while time.time() < deadline:
            if any(r.get("event") == "point"
                   for r in read_progress(prog)):
                break
            assert proc.is_alive(), "worker died before first point"
            time.sleep(0.05)
        else:
            pytest.fail("worker produced no point within 300s")
        proc.kill()
    finally:
        proc.join()

    with pytest.raises(RuntimeError, match="redispatch to resume"):
        collect(SPEC_KILL, store)

    res = dispatch(SPEC_KILL, store, workers=2, lease_ttl_s=2.0,
                   progress_path=prog, **CPU)
    assert _bench_bytes(str(tmp_path / "b.json"), res) == \
        ref_bytes["dispkill"]
    s = progress_summary(read_progress(prog))
    assert (s["completed"], s["total"]) == (len(SPEC_KILL.expand()),
                                            len(SPEC_KILL.expand()))
