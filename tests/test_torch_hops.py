"""The port's HopRecord stream against the JAX reference's
(``tests/test_hops.py``, case for case where the case concerns the
simulator or the fleet), on the CPU at N = 8, 4 runs, 2 s.

Integer hop fields (seq, src, dst, boundary_layer, stall_ticks) and the
overflow counter must equal JAX's exactly; floats (times, bits) are within
rtol 1e-5.  Within the port, hop capture changes no untraced metric
(``torch.equal``) and the backends give ``torch.equal`` buffers.
"""
import dataclasses
import json

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
from repro_torch.swarm import simulator as sim  # noqa: E402
from repro_torch.swarm import transfer as transfer_mod  # noqa: E402
from repro_torch.swarm.tasks import make_profile  # noqa: E402
from repro_torch.trace import (decode, decode_hops, hop_airtime_s,  # noqa: E402
                               hop_energy_j, hop_indices, link_energy_j,
                               schema, split_runs, trace_indices,
                               write_chrome_trace)

torch.set_num_threads(1)
KEY = rng.PRNGKey(0)
N, RUNS = 8, 4
CFG = dataclasses.replace(SwarmConfig(), sim_time_s=2.0, num_workers=N)
CFG_HOP = dataclasses.replace(CFG, trace_hop_capacity=512)
CFG_BOTH = dataclasses.replace(CFG_HOP, trace_capacity=512)
CPU = dict(device="cpu")


def _np(tree):
    return {k: (v.numpy() if torch.is_tensor(v) else np.asarray(v))
            for k, v in tree.items()}


def _ref(cfg):
    jc = JCfg(**dataclasses.asdict(cfg))
    return _np(jfleet.run_batch(jax.random.PRNGKey(0), jc,
                                jnp.int32(sim.DISTRIBUTED), N, RUNS))


def assert_hops_match(got, want):
    """[R, C, F] hop buffers: integer fields exact, floats rtol 1e-5."""
    assert got.shape == want.shape and got.dtype == want.dtype
    for i, f in enumerate(schema.HOP_FIELDS):
        if f in schema.HOP_INT_FIELDS:
            np.testing.assert_array_equal(got[..., i], want[..., i],
                                          err_msg=f)
        else:
            np.testing.assert_allclose(got[..., i], want[..., i], rtol=1e-5,
                                       err_msg=f)


@pytest.fixture(scope="module")
def hopped():
    return run_batch(KEY, CFG_HOP, sim.DISTRIBUTED, N, RUNS, **CPU)


@pytest.fixture(scope="module")
def plain():
    return run_batch(KEY, CFG, sim.DISTRIBUTED, N, RUNS, **CPU)


@pytest.fixture(scope="module")
def ref_both():
    return _ref(CFG_BOTH)


# ---------------------------------------------------------------------------
# hop capture off == no hop state; on perturbs nothing
# ---------------------------------------------------------------------------


def test_capacity_zero_emits_no_hop_state(plain):
    assert not any(k.startswith("trace_") for k in plain)


def test_hop_capture_does_not_perturb_metrics(hopped, plain):
    for k in plain:
        assert torch.equal(hopped[k], plain[k]), k


def test_hop_stream_independent_of_task_stream(hopped):
    both = run_batch(KEY, CFG_BOTH, sim.DISTRIBUTED, N, RUNS, **CPU)
    assert torch.equal(both["trace_hops"], hopped["trace_hops"])
    assert torch.equal(both["trace_hop_overflow"],
                       hopped["trace_hop_overflow"])


# ---------------------------------------------------------------------------
# against the live reference (both streams on: the hops and the task
# records of the same run)
# ---------------------------------------------------------------------------


def test_hops_match_reference(hopped, ref_both):
    got = _np(hopped)
    assert_hops_match(got["trace_hops"], ref_both["trace_hops"])
    np.testing.assert_array_equal(got["trace_hop_overflow"],
                                  ref_both["trace_hop_overflow"])
    assert got["trace_hop_overflow"].dtype == \
        ref_both["trace_hop_overflow"].dtype


def test_hop_report_matches_reference_report(ref_both):
    """build_report's hop section (transfer-time and link quantiles, the
    queue-wait / in-flight split, airtime energy) and the latency segments
    against the reference's report of the same point."""
    from test_torch_trace import assert_reports_match
    got = _np(run_batch(KEY, CFG_BOTH, sim.DISTRIBUTED, N, RUNS, **CPU))
    jc = JCfg(**dataclasses.asdict(CFG_BOTH))
    kw = dict(tick_s=CFG.tick_s, tx_power_dbm=CFG.tx_power_dbm)
    want = jfleet.build_report({"pt": ref_both}, cfg=jc, **kw)
    doc = build_report({"pt": got}, cfg=CFG_BOTH, **kw)
    assert_reports_match(doc, want)
    assert doc["points"]["pt"]["hop_count"] > 0
    assert doc["points"]["pt"]["latency_segments"]["stall_s_share"] >= 0


# ---------------------------------------------------------------------------
# hop accounting against the scalar accumulators
# ---------------------------------------------------------------------------


def test_hops_account_for_every_delivery(hopped):
    m = _np(hopped)
    hdec = decode_hops(m["trace_hops"], m["trace_hop_overflow"])
    delivered = m["transfers_delivered"].sum()
    assert hdec["seq"].size + int(hdec["overflow"]) == int(delivered)
    assert np.all(m["transfers_delivered"] <= m["transfers"])
    tsum = m["avg_transfer_time_s"] * np.maximum(m["transfers_delivered"],
                                                 1.0)
    for run, s, d in zip(split_runs(m["trace_hops"], hops=True), tsum,
                         m["transfers_delivered"], strict=True):
        if d > 0:
            assert np.isclose(run["transfer_time_s"].sum(), s, rtol=1e-4)
        assert np.all(np.diff(run["seq"]) > 0)


def test_hop_fields_are_physical(hopped):
    hdec = decode_hops(hopped["trace_hops"], hopped["trace_hop_overflow"])
    assert hdec["seq"].size > 0
    assert np.all(hdec["t_arrive"] > hdec["t_depart"])
    assert np.all((hdec["src"] >= 0) & (hdec["src"] < N))
    assert np.all((hdec["dst"] >= 0) & (hdec["dst"] < N))
    assert np.all(hdec["src"] != hdec["dst"])
    assert np.all(hdec["bits"] > 0)
    assert np.all(hdec["boundary_layer"] >= 0)
    assert np.all(hdec["boundary_layer"] <= CFG.task_layers)
    assert np.all(hdec["stall_ticks"] >= 0)
    assert np.all(hdec["stall_ticks"] * CFG.tick_s
                  <= hdec["transfer_time_s"] + 1e-6)


def test_hop_overflow_saturates_capture_exactly(hopped):
    cap = 4
    cfg = dataclasses.replace(CFG_HOP, trace_hop_capacity=cap)
    m = _np(run_batch(KEY, cfg, sim.DISTRIBUTED, N, RUNS, **CPU))
    hdec = decode_hops(m["trace_hops"], m["trace_hop_overflow"])
    assert int(hdec["overflow"]) > 0
    assert hdec["seq"].size + int(hdec["overflow"]) == int(
        m["transfers_delivered"].sum())
    assert np.all(hdec["seq"] < cap)
    want = _ref(cfg)
    np.testing.assert_array_equal(m["trace_hop_overflow"],
                                  want["trace_hop_overflow"])
    assert_hops_match(m["trace_hops"], want["trace_hops"])
    for small, big in zip(split_runs(m["trace_hops"], hops=True),
                          split_runs(_np(hopped)["trace_hops"], hops=True),
                          strict=True):
        keep = big["seq"] < cap
        for f in schema.HOP_FIELDS:
            np.testing.assert_array_equal(small[f], big[f][keep], err_msg=f)


# ---------------------------------------------------------------------------
# backends + resume
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("backend,kw", [
    ("sharded", {"devices": ["cpu"] * 3}), ("streaming", {"chunk_size": 3})])
def test_hops_bit_identical_across_backends(hopped, backend, kw):
    got = run_batch(KEY, CFG_HOP, sim.DISTRIBUTED, N, RUNS, backend=backend,
                    **kw, **CPU)
    for k in hopped:
        assert torch.equal(got[k], hopped[k]), k


def test_interrupted_streaming_sweep_preserves_hops(tmp_path, hopped,
                                                    monkeypatch):
    monkeypatch.setenv("REPRO_CODE_VERSION", "test-torch-hops")
    from repro_torch.fleet.store import code_version
    code_version.cache_clear()
    spec = SweepSpec.build("hopresume", CFG_HOP,
                           strategies=(sim.DISTRIBUTED,), num_runs=RUNS)
    (pt,) = spec.expand()
    store = ResultStore(str(tmp_path))
    with pytest.raises(SweepInterrupted):
        run_point(pt, backend="streaming", store=store, chunk_size=2,
                  max_chunks=1, **CPU)
    done, accum = store.load_partial(point_digest(pt))
    assert done == 1
    assert accum["trace_hops"].shape == (2, 512, schema.NUM_HOP_FIELDS)
    resumed = run_point(pt, backend="streaming", store=store, chunk_size=2,
                        **CPU)
    want = _np(hopped)
    np.testing.assert_array_equal(resumed["trace_hops"], want["trace_hops"])
    hit = run_point(pt, backend="vmap", store=store, **CPU)
    dh, dt = decode_hops(hit["trace_hops"]), decode_hops(want["trace_hops"])
    for f in schema.HOP_FIELDS:
        np.testing.assert_array_equal(dh[f], dt[f], err_msg=f)
    code_version.cache_clear()


# ---------------------------------------------------------------------------
# transfer accounting: contended delivery, the delivered denominator, the
# per-hop energy join
# ---------------------------------------------------------------------------


def _contention_state(cfg, bits, rate):
    """Two senders (0, 1) -> one receiver (2), same bits, same tick; one
    run."""
    st = sim.init_state(rng.split(rng.PRNGKey(1), 1), cfg, 3)
    st["tx_active"] = torch.tensor([[True, True, False]])
    st["tx_dst"] = torch.tensor([[2, 2, 0]], dtype=torch.int32)
    st["tx_bits"] = torch.tensor([[bits, bits, 0.0]])
    st["tx_start"] = torch.zeros((1, 3))
    st["tx_count"] = torch.tensor([2], dtype=torch.int32)
    if "hop_seq" in st:
        st["hop_seq"] = torch.tensor([[0, 1, 0]], dtype=torch.int32)
        st["hop_bits"] = st["tx_bits"].clone()
        st["hop_counter"] = torch.tensor([2], dtype=torch.int32)
    cap = torch.full((1, 3, 3), rate)
    alive = torch.ones((1, 3), dtype=torch.bool)
    return st, cap, alive


def test_contended_delivery_energy_pins_to_single_transfer_value():
    cfg = dataclasses.replace(SwarmConfig(), num_workers=3,
                              trace_capacity=64, trace_hop_capacity=64)
    tick = cfg.tick_s
    tx_w = 10.0 ** (cfg.tx_power_dbm / 10.0) * 1e-3
    st, cap, alive = _contention_state(cfg, bits=100.0, rate=100.0 / tick)
    transfer_mod.progress(st, cap, alive, cfg, tick)
    assert bool(st["tx_active"][0, 1]) and not bool(st["tx_active"][0, 0])
    assert float(st["e_tx"].sum()) == pytest.approx(2 * tx_w * tick)
    bits_frozen = float(st["tx_bits"][0, 1])
    transfer_mod.progress(st, cap, alive, cfg, 2 * tick)
    assert not bool(st["tx_active"][0, 1])
    assert float(st["e_tx"].sum()) == pytest.approx(2 * tx_w * tick)
    assert float(st["tx_bits"][0, 1]) == pytest.approx(bits_frozen)
    assert float(st["tx_energy"][0, 0]) == pytest.approx(tx_w * tick)
    assert float(st["tx_energy"][0, 1]) == pytest.approx(tx_w * tick)
    assert int(st["tx_delivered"]) == 2
    assert float(st["tx_time_sum"]) == pytest.approx(tick + 2 * tick)
    hdec = decode_hops(st["trace_hops"][:, :-1])
    assert hdec["seq"].size == 2
    assert hdec["stall_ticks"].tolist() == [0, 1]
    assert np.allclose(hdec["transfer_time_s"], [tick, 2 * tick])


def test_avg_transfer_time_uses_delivered_denominator():
    cfg = dataclasses.replace(SwarmConfig(), num_workers=3)
    profile = make_profile(cfg)
    tick = cfg.tick_s
    st, cap, alive = _contention_state(cfg, bits=100.0, rate=100.0 / tick)
    st["tx_dst"] = torch.tensor([[2, 0, 0]], dtype=torch.int32)
    st["tx_bits"] = torch.tensor([[100.0, 1e12, 0.0]])
    transfer_mod.progress(st, cap, alive, cfg, tick)
    out = {k: float(v) for k, v in sim.summarize(st, cfg, profile).items()}
    assert out["transfers"] == 2.0
    assert out["transfers_delivered"] == 1.0
    assert out["avg_transfer_time_s"] == pytest.approx(tick)


def test_hop_energy_join_reproduces_e_tx():
    cfg = dataclasses.replace(SwarmConfig(), num_workers=3,
                              trace_hop_capacity=64)
    tick = cfg.tick_s
    tx_w = 10.0 ** (cfg.tx_power_dbm / 10.0) * 1e-3
    st, cap, alive = _contention_state(cfg, bits=100.0,
                                       rate=100.0 / (2 * tick))
    for i in range(1, 8):
        transfer_mod.progress(st, cap, alive, cfg, i * tick)
    assert int(st["tx_delivered"]) == 2
    hdec = decode_hops(st["trace_hops"][:, :-1])
    air = hop_airtime_s(hdec, tick)
    e = hop_energy_j(hdec, tick, cfg.tx_power_dbm)
    np.testing.assert_allclose(e, air * tx_w)
    assert e.sum() == pytest.approx(float(st["e_tx"].sum()))
    assert np.any(air < hdec["transfer_time_s"])
    le = link_energy_j(hdec, tick, cfg.tx_power_dbm)
    assert set(le) == {"0->2", "1->2"}
    assert sum(le.values()) == pytest.approx(float(st["e_tx"].sum()))


def test_hop_energy_in_report_and_schema(hopped):
    m = _np(hopped)
    doc = build_report({"pt": m}, tick_s=CFG.tick_s,
                       tx_power_dbm=CFG.tx_power_dbm)["points"]["pt"]
    assert doc["hop_energy_j_quantiles"]["p50"] > 0
    assert doc["link_energy_j_quantiles"]["p50"] > 0
    tx_w = 10.0 ** (CFG.tx_power_dbm / 10.0) * 1e-3
    assert doc["tx_energy_total_j"] == pytest.approx(
        doc["tx_airtime_total_s"] * tx_w)
    bare = build_report({"pt": m}, tick_s=CFG.tick_s)["points"]["pt"]
    assert sorted(bare) == sorted(doc)
    assert bare["tx_airtime_total_s"] is not None
    assert bare["tx_energy_total_j"] is None
    assert bare["hop_energy_j_quantiles"] is None


def test_trace_indices_schema_is_stable():
    drop_row = schema.pack_np(0, 1, 2, 0.0, 0.5, schema.DROPPED, 0, 1)
    done_row = schema.pack_np(1, 0, 0, 0.0, 0.2, 0, 60, 0)
    all_drop = trace_indices(decode(np.asarray([drop_row])))
    populated = trace_indices(decode(np.asarray([drop_row, done_row])))
    assert sorted(all_drop) == sorted(populated)
    assert all_drop["task_count"] == 0
    assert all_drop["task_latency_cdf_s"] is None
    assert all_drop["hop_histogram"] == {}
    empty = hop_indices(decode_hops(schema.empty_hop_buffer(4)))
    full = hop_indices(decode_hops(torch.tensor(
        [[0, 0, 1, 0.0, 0.1, 8e6, 3, 2]])), tick_s=0.01)
    assert sorted(empty) == sorted(full)
    assert empty["hop_count"] == 0
    assert full["hop_queue_wait_s_quantiles"]["p50"] == pytest.approx(0.02)
    assert full["hop_in_flight_s_quantiles"]["p50"] == pytest.approx(0.08)


# ---------------------------------------------------------------------------
# report + export
# ---------------------------------------------------------------------------


def test_report_gains_hop_resolved_indices(hopped, plain):
    m = _np(hopped)
    doc = build_report({"pt": m}, tick_s=CFG.tick_s)["points"]["pt"]
    assert "trace_hops" not in doc
    hdec = decode_hops(m["trace_hops"], m["trace_hop_overflow"])
    assert doc["hop_count"] == hdec["seq"].size
    assert doc["hop_transfer_time_s_quantiles"]["p50"] == pytest.approx(
        float(np.quantile(hdec["transfer_time_s"], 0.5)))
    doc0 = build_report({"pt": _np(plain)})["points"]["pt"]
    assert not any(k.startswith("hop_") for k in doc0)


def test_perhop_chrome_trace_export(tmp_path):
    m = run_batch(KEY, CFG_BOTH, sim.DISTRIBUTED, N, 1, **CPU)
    dec = decode(m["trace_records"][0], m["trace_overflow"][0])
    hdec = decode_hops(m["trace_hops"][0], m["trace_hop_overflow"][0])
    path = write_chrome_trace(str(tmp_path / "t.json"), dec, hdec,
                              CFG.tick_s)
    with open(path) as f:
        ev = json.load(f)["traceEvents"]
    hops = [e for e in ev if e.get("cat") == "hop"]
    flows = [e for e in ev if e.get("cat") == "transfer"]
    queues = [e for e in ev if e.get("cat") == "queue"]
    assert len(hops) == hdec["seq"].size > 0
    assert len(flows) == 2 * hdec["seq"].size
    assert all(e["tid"] == e["args"]["src"] for e in hops)
    assert len(queues) == int((hdec["stall_ticks"] > 0).sum())
    assert all(e["tid"] == e["args"]["dst"] and e["dur"] > 0 for e in queues)
