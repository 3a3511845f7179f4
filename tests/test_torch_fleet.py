"""The port's fleet sweep engine (``repro_torch.fleet``) on the CPU, after
tests/test_fleet.py and at its sizes (8 UAVs, 2 s, 6 runs): grid expansion
(labels and order equal the reference's), the three backends bit-identical
to one another (``torch.equal`` on every metric, sharded over three CPU
shards with padding, streaming with a padded last chunk), ``vmap`` within
the rtol 1e-5 of tests/test_torch_simulator.py of the reference's
``fleet.run_batch`` with exact counters, the store's bitwise round trip,
kill/resume equal to an uninterrupted run down to the report JSON's bytes,
port and reference digests that never coincide, and ``build_report``
equal to the reference's on the same metrics.
"""
import dataclasses
import json
import os
from pathlib import Path

import numpy as np
import pytest

torch = pytest.importorskip("torch")
import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

import repro.fleet as jfleet  # noqa: E402
from repro.configs.base import SwarmConfig as JCfg  # noqa: E402
from repro_torch import rng  # noqa: E402
from repro_torch.checkpoint import ckpt  # noqa: E402
from repro_torch.configs import SwarmConfig  # noqa: E402
from repro_torch.fleet import (ResultStore, SweepInterrupted,  # noqa: E402
                               SweepSpec, build_report, execute,
                               point_digest, point_indices, run_batch,
                               run_point, write_bench_json)
from repro_torch.fleet import store as tstore  # noqa: E402
from repro_torch.swarm.simulator import (DISTRIBUTED, LOCAL_ONLY,  # noqa: E402
                                         run_many)

torch.set_num_threads(1)
KEY = rng.PRNGKey(0)
CFG = dataclasses.replace(SwarmConfig(), sim_time_s=2.0, num_workers=8)
JCFG = JCfg(**dataclasses.asdict(CFG))
N, RUNS = 8, 6
COUNTERS = ("completed", "generated", "transfers", "transfers_delivered",
            "dropped")


@pytest.fixture(autouse=True)
def _pinned_code_version(monkeypatch):
    """Digests must not drift with the working tree while tests run."""
    from repro.fleet.store import code_version as jversion
    monkeypatch.setenv("REPRO_CODE_VERSION", "test-version")
    tstore.code_version.cache_clear()
    jversion.cache_clear()
    yield
    tstore.code_version.cache_clear()
    jversion.cache_clear()


@pytest.fixture(scope="module")
def vmap_metrics():
    return run_batch(KEY, CFG, DISTRIBUTED, N, RUNS, device="cpu")


def _assert_equal(got, want):
    assert sorted(got) == sorted(want)
    for k in want:
        g = got[k] if torch.is_tensor(got[k]) else torch.from_numpy(got[k])
        w = want[k] if torch.is_tensor(want[k]) else torch.from_numpy(
            want[k])
        assert g.dtype == w.dtype == torch.float32, k
        assert torch.equal(g.cpu(), w.cpu()), k


# ---------------------------------------------------------------------------
# sweep expansion
# ---------------------------------------------------------------------------

GRID = dict(axes={"gamma": (0.02, 0.1),
                  "scenario": (("base", {}),
                               ("rwp", {"mobility_model": "random_waypoint"}))},
            strategies=(LOCAL_ONLY, DISTRIBUTED), num_runs=3)


def test_sweep_expands_full_grid_with_unique_labels_and_digests():
    spec = SweepSpec.build("grid", CFG, **GRID)
    pts = spec.expand()
    assert len(pts) == len(spec) == 2 * 2 * 2
    labels = [p.label for p in pts]
    assert len(set(labels)) == len(labels)
    assert len({point_digest(p) for p in pts}) == len(pts)
    rwp = [p for p in pts if p.values["scenario"] == "rwp"]
    assert all(p.cfg.mobility_model == "random_waypoint" for p in rwp)
    assert all(p.n == CFG.num_workers for p in pts)


def test_sweep_labels_and_order_equal_reference():
    ours = SweepSpec.build("grid", CFG, **GRID, seed=3)
    ref = jfleet.SweepSpec.build("grid", JCFG, **GRID, seed=3)
    tp, jp = ours.expand(), ref.expand()
    assert [p.label for p in tp] == [p.label for p in jp]
    for a, b in zip(tp, jp, strict=True):
        assert a.coords == b.coords
        assert dataclasses.asdict(a.cfg) == dataclasses.asdict(b.cfg)
        assert (a.strategy, a.n, a.num_runs, a.seed) == \
            (b.strategy, b.n, b.num_runs, b.seed)
    assert ours.to_json() == ref.to_json()
    assert SweepSpec.from_json(ref.to_json()) == ours


def test_sweep_rejects_unknown_fields():
    with pytest.raises(ValueError, match="not a SwarmConfig field"):
        SweepSpec.build("bad", CFG, axes={"gama": (0.1,)}).expand()
    with pytest.raises(ValueError, match="unknown SwarmConfig fields"):
        SweepSpec.build("bad", CFG, axes={
            "scenario": (("x", {"mobility": "rwp"}),)}).expand()


# ---------------------------------------------------------------------------
# cross-backend equivalence, and against the reference
# ---------------------------------------------------------------------------


def test_sharded_backend_bit_identical_to_vmap(vmap_metrics):
    got = run_batch(KEY, CFG, DISTRIBUTED, N, RUNS, backend="sharded",
                    devices=["cpu", "cpu"])
    _assert_equal(got, vmap_metrics)


@pytest.mark.parametrize("chunk", [3, 4])
def test_streaming_backend_bit_identical_to_vmap(vmap_metrics, chunk):
    # chunk 4 over 6 runs: a padded final chunk; chunk 3: none
    got = run_batch(KEY, CFG, DISTRIBUTED, N, RUNS, backend="streaming",
                    chunk_size=chunk, device="cpu")
    _assert_equal(got, vmap_metrics)


def test_sharded_and_streaming_pad_non_divisible_run_counts():
    """Three CPU shards over 7 runs pad to 9; chunks of 3 pad the last."""
    ref = run_batch(KEY, CFG, DISTRIBUTED, N, 7, device="cpu")
    sharded = run_batch(KEY, CFG, DISTRIBUTED, N, 7, backend="sharded",
                        devices=["cpu"] * 3)
    streamed = run_batch(KEY, CFG, DISTRIBUTED, N, 7, backend="streaming",
                         chunk_size=3, device="cpu")
    assert all(v.shape == (7,) for v in sharded.values())
    _assert_equal(sharded, ref)
    _assert_equal(streamed, ref)


def test_run_many_routes_through_executor(vmap_metrics):
    _assert_equal(run_many(KEY, CFG, DISTRIBUTED, N, RUNS, device="cpu"),
                  vmap_metrics)


def test_unknown_backend_raises():
    with pytest.raises(ValueError, match="unknown backend"):
        run_batch(KEY, CFG, 0, N, 2, backend="pmap", device="cpu")


def test_vmap_matches_reference_run_batch(vmap_metrics):
    want = jfleet.run_batch(jax.random.PRNGKey(0), JCFG,
                            jnp.int32(DISTRIBUTED), N, RUNS)
    assert sorted(want) == sorted(vmap_metrics)
    for k, w in want.items():
        w, g = np.asarray(w), vmap_metrics[k].numpy()
        if k in COUNTERS:
            np.testing.assert_array_equal(g, w, err_msg=k)
        else:
            np.testing.assert_allclose(g, w, rtol=1e-5, atol=1e-7,
                                       err_msg=k)


def test_entry_points_need_cuda_by_default(tmp_path):
    if torch.cuda.is_available():
        pytest.skip("this machine has CUDA: the default device is valid")
    spec = SweepSpec.build("dev", CFG, num_runs=2)
    for call in (lambda: run_batch(KEY, CFG, 0, N, 2),
                 lambda: run_batch(KEY, CFG, 0, N, 2, backend="sharded"),
                 lambda: run_point(spec.expand()[0], backend="streaming"),
                 lambda: execute(spec)):
        with pytest.raises(RuntimeError, match="CUDA"):
            call()


# ---------------------------------------------------------------------------
# store: content addressing + cache hits
# ---------------------------------------------------------------------------


def test_store_roundtrip_is_bitwise(tmp_path):
    spec = SweepSpec.build("cache", CFG, strategies=(DISTRIBUTED,),
                           num_runs=RUNS)
    (pt,) = spec.expand()
    store = ResultStore(str(tmp_path))
    first = run_point(pt, backend="vmap", store=store, device="cpu")
    assert store.get(point_digest(pt)) is not None
    hit = run_point(pt, backend="vmap", store=store, device="cpu")
    _assert_equal(hit, first)
    # a result computed on one backend is a valid hit for another
    _assert_equal(run_point(pt, backend="streaming", store=store,
                            chunk_size=2, device="cpu"), first)


def test_result_json_float32_round_trip_is_exact(tmp_path):
    """float32 -> JSON float -> float32 gives the same bits, for values
    across the whole range (subnormals, extremes, signed zero)."""
    x = np.random.default_rng(0).standard_normal(4096).astype(np.float32)
    x *= np.float32(10.0) ** np.random.default_rng(1).integers(
        -40, 38, 4096).astype(np.float32)
    x[:6] = [0.0, -0.0, np.finfo(np.float32).tiny, np.finfo(np.float32).max,
             np.float32(1e-45), np.float32(-3.4028235e38)]
    store = ResultStore(str(tmp_path))
    store.put("ab" + "0" * 62, {"x": x})
    got = store.get("ab" + "0" * 62)["x"]
    assert got.dtype == np.float32
    assert np.array_equal(got.view(np.uint32), x.view(np.uint32))


def test_compact_trace_trims_synthetic_buffer():
    """Slots past the last written seq of any run go; everything before
    stays, sentinel rows included; other leaves pass through."""
    buf = np.full((3, 10, 4), -1.0, np.float32)
    buf[0, 2] = [2, 1, 1, 1]
    buf[1, 5] = [5, 0, 3, 1]
    out = tstore._compact_trace("trace_records", buf)
    assert out.shape == (3, 6, 4) and np.array_equal(out, buf[:, :6])
    assert tstore._compact_trace("trace_hops", buf).shape == (3, 6, 4)
    assert tstore._compact_trace("trace_records",
                                 np.full((2, 4, 4), -1.0)).shape == (2, 0, 4)
    assert tstore._compact_trace("completed", buf).shape == (3, 10, 4)


def test_digest_covers_config_and_code_version():
    spec = SweepSpec.build("d", CFG, strategies=(DISTRIBUTED,), num_runs=2)
    (pt,) = spec.expand()
    base = point_digest(pt)
    assert point_digest(pt._replace(
        cfg=dataclasses.replace(CFG, gamma=0.5))) != base
    assert point_digest(pt._replace(seed=1)) != base
    assert point_digest(pt._replace(num_runs=3)) != base
    assert point_digest(pt, version="other") != base
    assert point_digest(pt) == base     # and it is deterministic


def test_port_and_reference_digests_never_coincide(monkeypatch):
    """Same point, same code version (the env override pins both): the
    implementation tag keeps the two stores apart."""
    spec = SweepSpec.build("d", CFG, axes={"gamma": (0.02, 0.1)},
                           strategies=(LOCAL_ONLY, DISTRIBUTED), num_runs=2)
    jspec = jfleet.SweepSpec.from_json(spec.to_json())
    for pt, jpt in zip(spec.expand(), jspec.expand(), strict=True):
        assert pt.label == jpt.label
        assert point_digest(pt) != jfleet.point_digest(jpt)
        assert point_digest(pt, version="v") != jfleet.point_digest(
            jpt, version="v")
    # and with the version git describes for this checkout
    monkeypatch.delenv("REPRO_CODE_VERSION")
    tstore.code_version.cache_clear()
    jfleet.code_version.cache_clear()
    v = tstore.code_version()
    assert point_digest(spec.expand()[0], version=v) != jfleet.point_digest(
        jspec.expand()[0], version=v)


def test_checkpoint_round_trip_and_retention(tmp_path):
    d = str(tmp_path / "ck")
    tree = {"a": np.arange(5, dtype=np.float32),
            "c": torch.tensor([1, 2], dtype=torch.int32)}
    for step in (1, 2, 3):
        ckpt.save(d, step, tree, keep=2, extra={"n": step})
    assert ckpt.all_steps(d) == [2, 3] and ckpt.latest_step(d) == 3
    got, manifest = ckpt.restore(d, {"a": 0, "c": 0})
    assert manifest["extra"] == {"n": 3} and manifest["step"] == 3
    assert np.array_equal(got["a"], tree["a"])
    assert got["c"].dtype == np.int32 and got["c"].tolist() == [1, 2]
    with pytest.raises(ValueError, match="mismatch"):
        ckpt.restore(d, {"a": 0})


# ---------------------------------------------------------------------------
# kill/resume (resumed == uninterrupted, down to the report's bytes)
# ---------------------------------------------------------------------------


def test_killed_and_resumed_sweep_matches_uninterrupted(tmp_path):
    spec = SweepSpec.build("resume", CFG, axes={"gamma": (0.02, 0.1)},
                           strategies=(DISTRIBUTED,), num_runs=RUNS)
    store = ResultStore(str(tmp_path / "cache"))

    # kill after 1 of 3 chunks of the first point
    with pytest.raises(SweepInterrupted):
        for pt in spec.expand():
            run_point(pt, backend="streaming", store=store, chunk_size=2,
                      max_chunks=1, device="cpu")
    done, accum = store.load_partial(point_digest(spec.expand()[0]))
    assert done == 1 and accum is not None
    assert next(iter(accum.values())).shape == (2,)

    resumed = execute(spec, backend="streaming", store=store, chunk_size=2,
                      device="cpu")
    fresh = execute(spec, backend="streaming", chunk_size=2, device="cpu")
    for label in fresh:
        _assert_equal({k: v for k, v in resumed[label].items()
                       if not k.startswith("_")},
                      {k: v for k, v in fresh[label].items()
                       if not k.startswith("_")})
        assert fresh[label]["_compile_s"] == 0.0
        assert fresh[label]["_execute_s"] > 0.0

    p_resumed = str(tmp_path / "bench_resumed.json")
    p_fresh = str(tmp_path / "bench_fresh.json")
    write_bench_json(p_resumed, "sweep:resume", build_report(resumed))
    write_bench_json(p_fresh, "sweep:resume", build_report(fresh))
    with open(p_resumed) as f1, open(p_fresh) as f2:
        assert f1.read() == f2.read()


def test_resume_with_different_chunk_size_discards_stale_partial(tmp_path,
                                                                 vmap_metrics):
    spec = SweepSpec.build("rechunk", CFG, strategies=(DISTRIBUTED,),
                           num_runs=RUNS)
    (pt,) = spec.expand()
    store = ResultStore(str(tmp_path))
    with pytest.raises(SweepInterrupted):
        run_point(pt, backend="streaming", store=store, chunk_size=2,
                  max_chunks=1, device="cpu")
    done, _ = store.load_partial(point_digest(pt), chunk_size=3)
    assert done == 0
    resumed = run_point(pt, backend="streaming", store=store, chunk_size=3,
                        device="cpu")
    _assert_equal(resumed, vmap_metrics)


def test_bench_json_sections_merge(tmp_path):
    path = str(tmp_path / "bench.json")
    write_bench_json(path, "a", {"x": 1})
    write_bench_json(path, "b", {"y": 2})
    write_bench_json(path, "a", {"x": 3})
    with open(path) as f:
        doc = json.load(f)
    assert doc == {"a": {"x": 3}, "b": {"y": 2}}
    assert os.path.exists(path) and not os.path.exists(path + ".tmp")


# ---------------------------------------------------------------------------
# the report against the reference's
# ---------------------------------------------------------------------------


def test_build_report_equals_reference(vmap_metrics):
    """The same per-run metrics (with wall-time spans, which both skip)
    give the same report, key for key and float for float."""
    m = {k: v.numpy() for k, v in vmap_metrics.items()}
    results = {"gamma=0.02/strategy=Distributed": dict(m, _wall_s=1.5),
               "gamma=0.1/strategy=Distributed":
                   {k: v[::-1].copy() for k, v in m.items()}}
    lat = {"gamma=0.02/strategy=Distributed": m["avg_latency_s"] * 3.0}
    meta = {"backend": "vmap", "num_runs": RUNS}
    got = build_report(results, meta=meta, per_task_latency_s=lat)
    want = jfleet.build_report(results, meta=meta, per_task_latency_s=lat)
    assert json.dumps(got, sort_keys=True) == json.dumps(want,
                                                         sort_keys=True)


ARTIFACT = (Path(__file__).resolve().parents[1] / "benchmarks" / "artifacts"
            / "BENCH_fleet.json")
FIG3_POINT = "gamma=0.02/strategy=Distributed"
# chip_smoke.py's CI_INDICES and NOT_REPRODUCED
CI_INDICES = ("avg_latency_s", "completed", "dropped", "transfers",
              "remaining_gflops", "jain_fairness", "energy_per_task_j",
              "throughput_tps")
NOT_REPRODUCED = {"energy_per_task_j"}


def test_fig3_artifact_point_on_the_live_reference():
    """The reference artifact's ``sweep:fig3_gamma`` point (γ = 0.02, 30
    UAVs, 4 runs, 100 s) was computed with the state stream on
    (``trace_state_every``).  On the live reference the stream leaves
    every per-run scalar bit-identical (as it does in the port,
    test_torch_state_trace.py), so an untraced run can be held against the
    artifact's CIs
    (chip_smoke.py).  The live reference (jax 0.9 here, whose random
    streams differ from the artifact's jax: ROADMAP.md, reference-side
    caveats) overlaps the artifact's 95 % CIs on every index chip_smoke.py
    checks but those in ``NOT_REPRODUCED`` (energy_per_task_j: 0.248668 ±
    0.000664 against 0.247437 ± 0.000550)."""
    base = JCfg(num_workers=30)
    runs = {}
    for every in (0, 1):
        spec = jfleet.SweepSpec.build(
            "fig3_gamma", dataclasses.replace(base, trace_state_every=every),
            axes={"gamma": (0.02,)}, strategies=(DISTRIBUTED,), num_runs=4)
        (runs[every],) = jfleet.execute(spec).values()
    assert "trace_state_sys" in runs[1] and "trace_state_sys" not in runs[0]
    for k, v in runs[0].items():
        if not k.startswith("_"):
            np.testing.assert_array_equal(runs[1][k], v, err_msg=k)
    got = jfleet.build_report({FIG3_POINT: runs[0]})["points"][FIG3_POINT]
    art = json.loads(ARTIFACT.read_text())["sweep:fig3_gamma"]["points"][
        FIG3_POINT]
    missed = {k: (got[k]["mean"], got[k]["ci95"], art[k]["mean"],
                  art[k]["ci95"]) for k in CI_INDICES
              if abs(got[k]["mean"] - art[k]["mean"])
              > got[k]["ci95"] + art[k]["ci95"]}
    assert set(missed) <= NOT_REPRODUCED, missed


def test_point_indices_refuse_trace_leaves():
    """The traced sections are ported: ``point_indices`` of a traced point
    has the task, hop and state sections and ``latency_segments``, and
    dumps no buffer."""
    cfg = dataclasses.replace(CFG, trace_capacity=256, trace_hop_capacity=256,
                              trace_state_every=2)
    m = {k: v.numpy() for k, v in run_batch(KEY, cfg, DISTRIBUTED, N, 2,
                                             device="cpu").items()}
    doc = point_indices(m, tick_s=cfg.tick_s, tx_power_dbm=cfg.tx_power_dbm,
                        cfg=cfg)
    assert not any(k.startswith("trace_") and k != "trace_overflow"
                   for k in doc)
    assert doc["task_count"] == int(m["completed"].sum())
    assert doc["trace_overflow"] == 0
    assert doc["hop_count"] == int(m["transfers_delivered"].sum())
    assert doc["tx_energy_total_j"] > 0
    assert doc["latency_segments"]["reconcile_max_err_s"] < 1e-9
    assert doc["state_sample_count"] == 5 and doc["state_runs"] == 2
    assert doc["completion_rate_final"] > 0
