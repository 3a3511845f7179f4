"""The port's flight recorder (the epoch-indexed state stream) against the
JAX reference's (``tests/test_state_trace.py``, case for case where the
case concerns the simulator or the fleet), on the CPU at N = 8, 4 runs,
2 s, and the reference artifact's ``fig_state`` sweep shape at 10 s.

Integer-valued gauges (queue depth, alive, counters, in-flight tasks and
transfers, the epoch map) must equal JAX's exactly; float gauges within
rtol 1e-5 (the cross-node sums go through ``core.fp.fsum`` in the port and
through XLA's f32 order in the reference, an ulp apart).  Within the
port, recording changes no untraced metric and the backends and a
two-worker dispatch give identical buffers and reports.
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
                               SweepSpec, build_report, dispatch, execute,
                               point_digest, read_progress, run_batch,
                               run_point, write_bench_json)
from repro_torch.swarm import simulator as sim  # noqa: E402
from repro_torch.trace import (decode_state, schema,  # noqa: E402
                               state_counter_events, state_indices,
                               write_chrome_trace)
from test_torch_trace import assert_reports_match  # noqa: E402

torch.set_num_threads(1)
KEY = rng.PRNGKey(0)
N, RUNS = 8, 4
CFG = dataclasses.replace(SwarmConfig(), sim_time_s=2.0, num_workers=N)
CFG_ST = dataclasses.replace(CFG, trace_state_every=1)
N_EPOCHS = int(round(CFG.sim_time_s / CFG.decision_period_s))
CPU = dict(device="cpu")
INT_GAUGES = {"trace_state": ("queue_depth", "alive"),
              "trace_state_sys": ("tasks_in_flight", "transfers_active",
                                  "completed", "dropped", "generated",
                                  "queue_depth_max")}


def _np(tree):
    return {k: (v.numpy() if torch.is_tensor(v) else np.asarray(v))
            for k, v in tree.items()}


@pytest.fixture(scope="module", autouse=True)
def _pinned_code_version():
    """Digests must agree with spawned workers and not drift mid-run."""
    from repro_torch.fleet.store import code_version
    old = os.environ.get("REPRO_CODE_VERSION")
    os.environ["REPRO_CODE_VERSION"] = "test-torch-state"
    code_version.cache_clear()
    yield
    if old is None:
        del os.environ["REPRO_CODE_VERSION"]
    else:
        os.environ["REPRO_CODE_VERSION"] = old
    code_version.cache_clear()


@pytest.fixture(scope="module")
def recorded():
    return run_batch(KEY, CFG_ST, sim.DISTRIBUTED, N, RUNS, **CPU)


@pytest.fixture(scope="module")
def plain():
    return run_batch(KEY, CFG, sim.DISTRIBUTED, N, RUNS, **CPU)


@pytest.fixture(scope="module")
def ref():
    jc = JCfg(**dataclasses.asdict(CFG_ST))
    return _np(jfleet.run_batch(jax.random.PRNGKey(0), jc,
                                jnp.int32(sim.DISTRIBUTED), N, RUNS))


@pytest.fixture(scope="module")
def sdec(recorded):
    return decode_state(recorded["trace_state"], recorded["trace_state_sys"],
                        recorded["trace_state_epochs"])


# ---------------------------------------------------------------------------
# recorder off == the untraced simulator; on perturbs nothing
# ---------------------------------------------------------------------------


def test_stride_zero_emits_no_state_buffers(plain):
    assert not any(k.startswith("trace_state") for k in plain)


def test_recording_does_not_perturb_metrics(recorded, plain):
    for k in plain:
        assert torch.equal(recorded[k], plain[k]), k


# ---------------------------------------------------------------------------
# against the live reference
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("key,names", [
    ("trace_state", schema.STATE_GAUGES),
    ("trace_state_sys", schema.SYS_GAUGES)])
def test_state_buffers_match_reference(recorded, ref, key, names):
    got, want = _np(recorded)[key], ref[key]
    assert got.shape == want.shape and got.dtype == want.dtype
    for i, name in enumerate(names):
        if name in INT_GAUGES[key]:
            np.testing.assert_array_equal(got[..., i], want[..., i],
                                          err_msg=name)
        else:
            np.testing.assert_allclose(got[..., i], want[..., i],
                                       rtol=1e-5, err_msg=name)
    np.testing.assert_array_equal(_np(recorded)["trace_state_epochs"],
                                  ref["trace_state_epochs"])


def test_report_matches_reference_report(recorded, ref):
    """The state section of build_report (φ-convergence curve and epochs
    to ε, queue heatmap, Jain and energy curves) against the reference's
    report of the same point.  The report rounds its curves to 6 (queue
    depths 3) decimals, so a curve value within rtol 1e-5 may move by one
    rounding quantum: the comparison allows 1e-6 absolute."""
    got = build_report({"pt": _np(recorded)})["points"]["pt"]
    want = jfleet.build_report({"pt": ref})["points"]["pt"]
    for k in ("state_sample_count", "state_runs", "state_epochs",
              "state_nodes", "phi_epochs_to_eps",
              "queue_depth_heatmap_epochs"):
        assert got[k] == want[k], k
    for k in ("phi_residual_curve", "queue_depth_mean_curve",
              "queue_depth_max_curve", "queue_jain_curve",
              "energy_drain_j_curve", "tasks_in_flight_curve"):
        np.testing.assert_allclose(got[k], want[k], rtol=1e-5, atol=1e-6,
                                   err_msg=k)
    np.testing.assert_allclose(got["queue_depth_heatmap"],
                               want["queue_depth_heatmap"], atol=1e-3)
    for k in ("queue_jain_min", "queue_jain_final", "completion_rate_final",
              "phi_spread_final"):
        assert got[k] == pytest.approx(want[k], rel=1e-5, abs=1e-6), k


# ---------------------------------------------------------------------------
# shapes, epoch map, gauges against the scalar accumulators
# ---------------------------------------------------------------------------


def test_state_buffer_shapes_and_epoch_map(recorded):
    assert recorded["trace_state"].shape == \
        (RUNS, N_EPOCHS, N, schema.NUM_STATE_GAUGES)
    assert recorded["trace_state_sys"].shape == \
        (RUNS, N_EPOCHS, schema.NUM_SYS_GAUGES)
    assert recorded["trace_state_epochs"].shape == (RUNS, N_EPOCHS)
    np.testing.assert_array_equal(recorded["trace_state_epochs"][0].numpy(),
                                  np.arange(N_EPOCHS, dtype=np.float32))


def test_state_gauges_are_physical(sdec):
    assert np.all(sdec["queue_depth"] >= 0)
    assert np.all(sdec["queue_depth"] <= CFG.queue_slots)
    assert np.all((sdec["alive"] == 0) | (sdec["alive"] == 1))
    assert np.all(sdec["e_comp_j"] >= 0) and np.all(sdec["e_tx_j"] >= 0)
    for k in ("e_comp_j", "e_tx_j"):
        assert np.all(np.diff(sdec[k], axis=1) >= -1e-6), k
    for k in ("completed", "dropped", "generated", "energy_j"):
        assert np.all(np.diff(sdec[k], axis=1) >= -1e-6), k
    jain = sdec["queue_jain"]
    assert np.all((jain >= 0) & (jain <= 1.0001))
    assert np.all(jain[sdec["queue_depth_mean"] > 0] > 0)
    np.testing.assert_allclose(
        sdec["t"][0], (np.arange(N_EPOCHS) + 1) * CFG.decision_period_s,
        rtol=1e-5)


def test_final_sample_pins_the_scalar_accumulators(recorded, sdec):
    m = _np(recorded)
    np.testing.assert_array_equal(sdec["completed"][:, -1], m["completed"])
    np.testing.assert_array_equal(sdec["dropped"][:, -1], m["dropped"])
    np.testing.assert_array_equal(
        sdec["energy_j"][:, -1].astype(np.float32), m["energy_total_j"])
    per_node = sdec["e_comp_j"][:, -1, :] + sdec["e_tx_j"][:, -1, :]
    np.testing.assert_allclose(per_node.sum(axis=1), m["energy_total_j"],
                               rtol=1e-4)


def test_stride_and_subsample_are_exact_slices(recorded):
    cfg = dataclasses.replace(CFG, trace_state_every=3, trace_state_nodes=4)
    m = run_batch(KEY, cfg, sim.DISTRIBUTED, N, RUNS, **CPU)
    S = -(-N_EPOCHS // 3)
    assert m["trace_state"].shape == (RUNS, S, 4, schema.NUM_STATE_GAUGES)
    np.testing.assert_array_equal(m["trace_state_epochs"][0].numpy(),
                                  np.arange(0, N_EPOCHS, 3))
    assert torch.equal(m["trace_state"],
                       recorded["trace_state"][:, ::3, :4])
    assert torch.equal(m["trace_state_sys"],
                       recorded["trace_state_sys"][:, ::3])


# ---------------------------------------------------------------------------
# backends, store, resume, dispatch
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("backend,kw", [
    ("sharded", {"devices": ["cpu"] * 3}), ("streaming", {"chunk_size": 3})])
def test_state_bit_identical_across_backends(recorded, backend, kw):
    got = run_batch(KEY, CFG_ST, sim.DISTRIBUTED, N, RUNS, backend=backend,
                    **kw, **CPU)
    for k in recorded:
        assert torch.equal(got[k], recorded[k]), k


def test_interrupted_streaming_sweep_preserves_state(tmp_path, recorded):
    spec = SweepSpec.build("stateresume", CFG_ST,
                           strategies=(sim.DISTRIBUTED,), num_runs=RUNS)
    (pt,) = spec.expand()
    store = ResultStore(str(tmp_path))
    with pytest.raises(SweepInterrupted):
        run_point(pt, backend="streaming", store=store, chunk_size=2,
                  max_chunks=1, **CPU)
    done, accum = store.load_partial(point_digest(pt))
    assert done == 1
    assert accum["trace_state"].shape == \
        (2, N_EPOCHS, N, schema.NUM_STATE_GAUGES)
    resumed = run_point(pt, backend="streaming", store=store, chunk_size=2,
                        **CPU)
    want = _np(recorded)
    np.testing.assert_array_equal(resumed["trace_state"],
                                  want["trace_state"])
    # the result.json round trip is bit for bit: no slack to trim
    hit = run_point(pt, backend="vmap", store=store, **CPU)
    for k in ("trace_state", "trace_state_sys", "trace_state_epochs"):
        np.testing.assert_array_equal(hit[k], want[k], err_msg=k)


def _bench_bytes(path, res):
    write_bench_json(path, "sweep:cmp", build_report(res))
    with open(path, "rb") as f:
        return f.read()


def test_two_worker_dispatch_reports_identically_with_gauges(tmp_path):
    """A traced sweep (all three streams) over two spawned CPU workers
    gives a report byte-identical to one process's, and the workers and
    the streaming chunks surface the swarm-health gauges."""
    spec = SweepSpec.build(
        "statedisp", dataclasses.replace(
            CFG, sim_time_s=1.0, num_workers=6, trace_state_every=2,
            trace_capacity=256, trace_hop_capacity=256),
        axes={"gamma": (0.02, 0.1)}, strategies=(0, 4), num_runs=3)
    ref = _bench_bytes(str(tmp_path / "ref.json"), execute(spec, **CPU))
    for key in (b"phi_residual_curve", b"task_latency_cdf_s",
                b"hop_transfer_time_s_quantiles"):
        assert key in ref
    prog = str(tmp_path / "progress.jsonl")
    res = dispatch(spec, ResultStore(str(tmp_path / "store")), workers=2,
                   progress_path=prog, **CPU)
    assert _bench_bytes(str(tmp_path / "disp.json"), res) == ref
    rows = read_progress(prog)
    gauges = [r for r in rows if r.get("event") == "gauges"]
    assert len(gauges) == len(spec.expand())
    assert all(0 <= r["completion_rate"] <= 1 and r["sim_t"] == 1.0
               for r in gauges)
    from repro_torch.fleet import progress_summary, render_progress
    s = progress_summary(rows)
    assert s["gauges"]["sim_t"] == 1.0 and "done" in render_progress(s)
    chunk_prog = str(tmp_path / "chunks.jsonl")
    from repro_torch.fleet import ProgressWriter
    run_point(spec.expand()[0], backend="streaming", chunk_size=2,
              progress=ProgressWriter(chunk_prog), **CPU)
    chunks = [r for r in read_progress(chunk_prog)
              if r.get("event") == "chunk"]
    assert len(chunks) == 2 and all("queue_depth_mean" in r for r in chunks)


# ---------------------------------------------------------------------------
# report + export
# ---------------------------------------------------------------------------


def test_report_carries_state_indices(recorded, plain, sdec):
    doc = build_report({"pt": _np(recorded)})["points"]["pt"]
    assert "trace_state" not in doc
    assert doc["state_sample_count"] == N_EPOCHS
    assert doc["state_nodes"] == N
    curve = doc["phi_residual_curve"]
    assert len(curve) == N_EPOCHS and curve[-1] == 0.0
    assert doc["queue_jain_final"] == pytest.approx(
        float(sdec["queue_jain"][:, -1].mean()), rel=1e-4)
    assert np.asarray(doc["queue_depth_heatmap"]).shape == (N_EPOCHS, N)
    assert doc["completion_rate_final"] > 0
    doc0 = build_report({"pt": _np(plain)})["points"]["pt"]
    assert not any(k.startswith(("state_", "phi_")) for k in doc0)


def test_state_counter_track_export(tmp_path, sdec):
    empty = {k: np.zeros((0,)) for k in
             ("seq", "src", "dst", "created_t", "completed_t", "latency_s",
              "exit_label", "layers", "hops", "is_dropped")}
    path = write_chrome_trace(str(tmp_path / "t.json"), empty, state=sdec)
    with open(path) as f:
        doc = json.load(f)
    counters = [e for e in doc["traceEvents"] if e.get("ph") == "C"]
    assert counters and all(e["pid"] == 1 and e["ts"] >= 0
                            for e in counters)
    names = {e["name"] for e in counters}
    assert "swarm queue depth" in names and "swarm phi" in names
    lane = [e for e in counters if e["name"] == "swarm queue depth"]
    assert len(lane) == N_EPOCHS and set(lane[0]["args"]) == {"mean", "max"}
    assert doc["otherData"]["state_sys_schema"] == list(schema.SYS_GAUGES)


def test_counter_events_standalone_without_sys():
    state = np.zeros((3, 2, schema.NUM_STATE_GAUGES))
    state[:, :, schema.ST_PHI] = 1.0
    ev = state_counter_events(decode_state(state))
    assert any(e["name"] == "uav 0 phi" for e in ev)
    assert not any(e["name"].startswith("swarm ") for e in ev
                   if e.get("ph") == "C")


def test_serve_stats_share_the_state_gauge_schema():
    from repro_torch.splitcompute.serve_engine import ServeStats
    st = ServeStats()
    st._generated = 4
    st.record_state(t=0.05, queue_depths=[3, 1, 0], load=[0.5, 0.2, 0.1])
    st._completed = 2
    st.record_state(t=0.10, queue_depths=[1, 1, 0], load=[0.4, 0.3, 0.1])
    dec = decode_state(st.stage_state, st.state_records)
    assert dec["completed"][0, -1] == 2
    assert dec["queue_depth_max"][0, 0] == 3
    np.testing.assert_allclose(dec["phi"][0, 0], [0.5, 0.2, 0.1])
    idx = state_indices(dec)
    assert idx["state_sample_count"] == 2 and idx["state_nodes"] == 3
    assert any(e.get("ph") == "C" for e in state_counter_events(dec))


def test_run_point_fills_spans_only_when_computing(tmp_path):
    (pt,) = SweepSpec.build("spans", CFG_ST, strategies=(sim.DISTRIBUTED,),
                            num_runs=2).expand()
    store = ResultStore(str(tmp_path))
    spans = {}
    first = run_point(pt, store=store, spans=spans, **CPU)
    assert spans["_compile_s"] == 0.0 and spans["_execute_s"] > 0
    hit_spans = {}
    hit = run_point(pt, store=store, spans=hit_spans, **CPU)
    assert hit_spans == {} and sorted(hit) == sorted(first)


# ---------------------------------------------------------------------------
# benchmarks/fig_state.py's sweep shape (30 UAVs, 4 runs, stride 1, every
# node) at 10 s, Distributed, against the live reference
# ---------------------------------------------------------------------------


def test_fig_state_point_against_live_reference():
    base = SwarmConfig(num_workers=30, sim_time_s=10.0, trace_state_every=1)
    spec = SweepSpec.build("fig_state", base, strategies=(sim.DISTRIBUTED,),
                           num_runs=4)
    jspec = jfleet.SweepSpec.build(
        "fig_state", JCfg(**dataclasses.asdict(base)),
        strategies=(sim.DISTRIBUTED,), num_runs=4)
    label = "strategy=Distributed"
    got = build_report(execute(spec, **CPU))["points"][label]
    want = jfleet.build_report(jfleet.execute(jspec))["points"][label]
    assert len(got["phi_residual_curve"]) == 50
    np.testing.assert_allclose(got["phi_residual_curve"],
                               want["phi_residual_curve"], rtol=1e-5,
                               atol=1e-6)
    assert got["phi_epochs_to_eps"] == want["phi_epochs_to_eps"]
    assert got["completion_rate_final"] == pytest.approx(
        want["completion_rate_final"], rel=1e-5)
    assert_reports_match(
        {k: got[k] for k in ("completed", "generated", "dropped")},
        {k: want[k] for k in ("completed", "generated", "dropped")})
