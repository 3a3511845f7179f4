"""The port's TaskRecord stream against the JAX reference's
(``tests/test_trace.py``, case for case where the case concerns the
simulator or the fleet), on the CPU at N = 8, 4 runs, 2 s.

The port and the live reference get the same ``SwarmConfig`` and keys.
Integer record fields (seq, src, dst, exit_label, layers, hops) and the
overflow counter must equal JAX's exactly; float fields (times, energy)
are within rtol 1e-5, the rule the untraced simulator meets.  Within the
port, tracing leaves every untraced metric ``torch.equal`` and the three
backends give ``torch.equal`` buffers.
"""
import dataclasses
import json
import os

import numpy as np
import pytest

torch = pytest.importorskip("torch")
import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

import repro.fleet as jfleet  # noqa: E402
from repro.configs.base import SwarmConfig as JCfg  # noqa: E402
from repro_torch import rng  # noqa: E402
from repro_torch.configs import SwarmConfig  # noqa: E402
from repro_torch.fleet import (ResultStore, SweepInterrupted,  # noqa: E402
                               SweepSpec, build_report, point_digest,
                               run_batch, run_point)
from repro_torch.swarm import simulator as tsim  # noqa: E402
from repro_torch.trace import (chrome_trace_events, decode,  # noqa: E402
                               schema, split_runs, trace_indices,
                               write_chrome_trace)

torch.set_num_threads(1)
KEY = rng.PRNGKey(0)
N, RUNS = 8, 4
CFG = dataclasses.replace(SwarmConfig(), sim_time_s=2.0, num_workers=N)
CFG_TR = dataclasses.replace(CFG, trace_capacity=512)
CPU = dict(device="cpu")


def _np(tree):
    return {k: (v.numpy() if torch.is_tensor(v) else np.asarray(v))
            for k, v in tree.items()}


def _ref(cfg, runs=RUNS):
    jc = JCfg(**dataclasses.asdict(cfg))
    return _np(jfleet.run_batch(jax.random.PRNGKey(0), jc,
                                jnp.int32(tsim.DISTRIBUTED), N, runs))


@pytest.fixture(scope="module", autouse=True)
def _pinned_code_version():
    from repro_torch.fleet.store import code_version
    old = os.environ.get("REPRO_CODE_VERSION")
    os.environ["REPRO_CODE_VERSION"] = "test-torch-trace"
    code_version.cache_clear()
    yield
    if old is None:
        del os.environ["REPRO_CODE_VERSION"]
    else:
        os.environ["REPRO_CODE_VERSION"] = old
    code_version.cache_clear()


@pytest.fixture(scope="module")
def traced():
    return run_batch(KEY, CFG_TR, tsim.DISTRIBUTED, N, RUNS, **CPU)


@pytest.fixture(scope="module")
def untraced():
    return run_batch(KEY, CFG, tsim.DISTRIBUTED, N, RUNS, **CPU)


@pytest.fixture(scope="module")
def ref():
    return _ref(CFG_TR)


def assert_records_match(got, want, fields, int_fields):
    """Buffers [R, C, F]: integer fields exact, floats within rtol 1e-5."""
    assert got.shape == want.shape and got.dtype == want.dtype
    for i, f in enumerate(fields):
        if f in int_fields:
            np.testing.assert_array_equal(got[..., i], want[..., i],
                                          err_msg=f)
        else:
            np.testing.assert_allclose(got[..., i], want[..., i],
                                       rtol=1e-5, atol=1e-7, err_msg=f)


def assert_reports_match(got, want, path="report"):
    """Reports (nested JSON-ready dicts): the same keys, integers and
    strings equal, floats within rtol 1e-5."""
    if isinstance(want, dict):
        assert sorted(got) == sorted(want), path
        for k in want:
            assert_reports_match(got[k], want[k], f"{path}.{k}")
    elif isinstance(want, list):
        assert len(got) == len(want), path
        for i, (g, w) in enumerate(zip(got, want, strict=True)):
            assert_reports_match(g, w, f"{path}[{i}]")
    elif isinstance(want, float):
        assert isinstance(got, float), path
        assert got == pytest.approx(want, rel=1e-5, abs=1e-7), path
    else:
        assert got == want, path


# ---------------------------------------------------------------------------
# trace off == the untraced simulator; trace on perturbs nothing
# ---------------------------------------------------------------------------


def test_capacity_zero_emits_no_trace_state(untraced):
    assert not any(k.startswith("trace_") for k in untraced)
    st = tsim.init_state(rng.split(KEY, 2), CFG, N)
    assert not any(k.startswith(("trace_", "hop_")) or k in (
        "q_src", "q_energy", "q_txtime", "tx_src", "tx_energy", "tx_txtime")
        for k in st)


def test_tracing_does_not_perturb_metrics(traced, untraced):
    for k in untraced:
        assert torch.equal(traced[k], untraced[k]), k


# ---------------------------------------------------------------------------
# against the live reference
# ---------------------------------------------------------------------------


def test_records_match_reference(traced, ref):
    got = _np(traced)
    assert sorted(got) == sorted(ref)
    assert_records_match(got["trace_records"], ref["trace_records"],
                         schema.FIELDS, schema.INT_FIELDS)
    np.testing.assert_array_equal(got["trace_overflow"],
                                  ref["trace_overflow"])
    assert got["trace_overflow"].dtype == ref["trace_overflow"].dtype


def test_report_matches_reference_report(traced, ref):
    """build_report's task section (CDF, Jain, histograms, energy) and
    latency segments of the same point, against the reference's."""
    jc = JCfg(**dataclasses.asdict(CFG_TR))
    want = jfleet.build_report({"pt": ref}, cfg=jc, tick_s=jc.tick_s)
    got = build_report({"pt": _np(traced)}, cfg=CFG_TR, tick_s=CFG.tick_s)
    assert_reports_match(got, want)
    assert "task_latency_cdf_s" in got["points"]["pt"]
    assert "latency_segments" in got["points"]["pt"]


# ---------------------------------------------------------------------------
# record accounting against the scalar accumulators
# ---------------------------------------------------------------------------


def test_records_account_for_every_finished_task(traced):
    m = _np(traced)
    dec = decode(traced["trace_records"], traced["trace_overflow"])
    finished = m["completed"].sum() + m["dropped"].sum()
    assert dec["seq"].size + int(dec["overflow"]) == int(finished)
    done = ~dec["is_dropped"]
    assert int(done.sum()) == int(m["completed"].sum())
    assert int(dec["is_dropped"].sum()) == int(m["dropped"].sum())
    lat_sum = float((m["avg_latency_s"] * m["completed"]).sum())
    assert np.isclose(dec["latency_s"][done].sum(), lat_sum, rtol=1e-4)
    for run in split_runs(m["trace_records"]):
        assert np.all(np.diff(run["seq"]) > 0)


def test_record_fields_are_physical(traced):
    dec = decode(traced["trace_records"], traced["trace_overflow"])
    assert np.all(dec["completed_t"] >= dec["created_t"])
    assert np.all((dec["src"] >= 0) & (dec["src"] < N))
    assert np.all((dec["dst"] >= 0) & (dec["dst"] < N))
    assert np.all(dec["hops"] >= 0) and np.all(dec["hops"] < N)
    assert np.all(dec["energy_j"] >= 0) and np.all(dec["tx_time_s"] >= 0)
    done = ~dec["is_dropped"]
    assert np.all(dec["exit_label"][done] <= 2)
    assert np.all(dec["layers"][done] > 0)
    assert np.all(dec["tx_time_s"][dec["hops"] == 0] == 0.0)
    moved = done & (dec["hops"] > 0)
    assert moved.any()
    assert np.all(dec["tx_time_s"][moved] > 0.0)
    assert np.any(dec["src"][moved] != dec["dst"][moved])


def test_overflow_counter_saturates_capture_exactly(traced):
    """Completions past the capacity are not captured (never wrapped over
    earlier records) and are counted exactly, as JAX counts them."""
    cap = 16
    cfg = dataclasses.replace(CFG_TR, trace_capacity=cap)
    m = _np(run_batch(KEY, cfg, tsim.DISTRIBUTED, N, RUNS, **CPU))
    dec = decode(m["trace_records"], m["trace_overflow"])
    finished = m["completed"].sum() + m["dropped"].sum()
    assert int(dec["overflow"]) > 0
    assert dec["seq"].size + int(dec["overflow"]) == int(finished)
    assert np.all(dec["seq"] < cap)
    want = _ref(cfg)
    np.testing.assert_array_equal(m["trace_overflow"], want["trace_overflow"])
    assert_records_match(m["trace_records"], want["trace_records"],
                         schema.FIELDS, schema.INT_FIELDS)
    # the captured prefix equals the uncapped run's, record for record
    for small, big in zip(split_runs(m["trace_records"]),
                          split_runs(_np(traced)["trace_records"]),
                          strict=True):
        keep = big["seq"] < cap
        for f in schema.FIELDS:
            np.testing.assert_array_equal(small[f], big[f][keep], err_msg=f)


def test_overflow_counter_saturates_at_int32_max():
    from repro_torch.trace import record
    st = {"trace_records": schema.empty_buffer(3, 1),
          "trace_overflow": torch.tensor([2 ** 31 - 2], dtype=torch.int32)}
    seq = torch.tensor([[0, 5, 6, 7]], dtype=torch.int32)
    mask = torch.tensor([[True, True, True, False]])
    record.write_records(st, mask, seq=seq, src=0, dst=1, created_t=0.0,
                         completed_t=1.0, exit_label=0, layers=3, hops=0,
                         energy_j=0.5, tx_time_s=0.0)
    assert st["trace_overflow"].item() == 2 ** 31 - 1
    assert st["trace_records"][0, 0, schema.SEQ].item() == 0.0
    assert (st["trace_records"][0, 1, :] == -1.0).all()


# ---------------------------------------------------------------------------
# backends, run_many, store and resume
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("backend,kw", [
    ("sharded", {"devices": ["cpu"] * 3}), ("streaming", {"chunk_size": 3})])
def test_records_bit_identical_across_backends(traced, backend, kw):
    got = run_batch(KEY, CFG_TR, tsim.DISTRIBUTED, N, RUNS, backend=backend,
                    **kw, **CPU)
    for k in traced:
        assert torch.equal(got[k], traced[k]), k


def test_run_many_carries_records(traced):
    got = tsim.run_many(KEY, CFG_TR, tsim.DISTRIBUTED, N, RUNS, **CPU)
    assert torch.equal(got["trace_records"], traced["trace_records"])


def test_interrupted_streaming_sweep_preserves_records(tmp_path, traced):
    spec = SweepSpec.build("traceresume", CFG_TR,
                           strategies=(tsim.DISTRIBUTED,), num_runs=RUNS)
    (pt,) = spec.expand()
    store = ResultStore(str(tmp_path))
    with pytest.raises(SweepInterrupted):
        run_point(pt, backend="streaming", store=store, chunk_size=2,
                  max_chunks=1, **CPU)
    done, accum = store.load_partial(point_digest(pt))
    assert done == 1
    assert accum["trace_records"].shape == (2, 512, schema.NUM_FIELDS)
    resumed = run_point(pt, backend="streaming", store=store, chunk_size=2,
                        **CPU)
    want = _np(traced)
    np.testing.assert_array_equal(resumed["trace_records"],
                                  want["trace_records"])
    # a store hit trims only trailing unwritten slots: every written
    # record survives the result.json round trip bit for bit
    hit = run_point(pt, backend="vmap", store=store, **CPU)
    assert hit["trace_records"].shape[1] < 512
    dh, dt = decode(hit["trace_records"]), decode(want["trace_records"])
    for f in schema.FIELDS:
        np.testing.assert_array_equal(dh[f], dt[f], err_msg=f)
    assert build_report({"p": hit}) == build_report({"p": resumed})


# ---------------------------------------------------------------------------
# report and timeline export
# ---------------------------------------------------------------------------


def test_report_feeds_task_cdf_from_records(traced, untraced):
    m = _np(traced)
    doc = build_report({"pt": m})["points"]["pt"]
    assert "trace_records" not in doc
    dec = decode(m["trace_records"])
    lat = dec["latency_s"][~dec["is_dropped"]]
    assert doc["task_latency_cdf_s"]["p50"] == pytest.approx(
        float(np.quantile(lat, 0.5)))
    assert doc["task_count"] == int(m["completed"].sum())
    assert 0.0 < doc["task_latency_jain"] <= 1.0
    doc0 = build_report({"pt": _np(untraced)})["points"]["pt"]
    assert not any(k.startswith("task_") for k in doc0)


def test_chrome_trace_export_is_valid_and_complete(tmp_path, traced):
    dec = split_runs(_np(traced)["trace_records"],
                     _np(traced)["trace_overflow"])[0]
    path = write_chrome_trace(str(tmp_path / "t.json"), dec)
    with open(path) as f:
        doc = json.load(f)
    ev = doc["traceEvents"]
    slices = [e for e in ev if e["ph"] == "X"]
    drops = [e for e in ev if e["ph"] == "i"]
    assert len(slices) == int((~dec["is_dropped"]).sum())
    assert len(drops) == int(dec["is_dropped"].sum())
    assert all(e["dur"] >= 0 and e["ts"] >= 0 for e in slices)
    flows = [e for e in ev if e["ph"] in ("s", "f")]
    moved = int(((dec["hops"] > 0) & ~dec["is_dropped"]).sum())
    assert len(flows) == 2 * moved


def test_serve_stats_share_the_task_record_schema():
    """The serve engine's host rows decode through the same pipeline as
    the simulator's records."""
    from repro_torch.splitcompute.serve_engine import ServeStats
    st = ServeStats()
    st.record(seq=0, src=0, dst=1, created_t=0.0, completed_t=0.4,
              exit_label=1, layers=8, hops=1, count=2)
    st.record(seq=1, src=0, dst=0, created_t=0.1, completed_t=0.2,
              exit_label=0, layers=16, hops=0)
    assert st.records.shape == (3, schema.NUM_FIELDS)
    dec = decode(st.records)
    idx = trace_indices(dec)
    assert idx["task_count"] == 3 and idx["dropped_count"] == 0
    assert idx["exit_label_histogram"] == {"0": 1, "1": 2}
    assert sum(e["ph"] == "X" for e in chrome_trace_events(dec)) == 3
