"""The port's copies of the reference's host-side trace functions
(``repro_torch.trace.decode`` / ``aggregate`` / ``critical`` / ``export``)
against the originals on the same numpy inputs: equal output, and
byte-identical JSON from ``write_chrome_trace``.  Also the cases of
``tests/test_critical.py`` that need neither ``obs.loadgen`` nor
``benchmarks/perf_gate.py``: per-task segment reconciliation, stable key
sets under degraded inputs, and segment attribution.  Pure numpy: exact.
"""
import importlib
import json

import numpy as np
import pytest

torch = pytest.importorskip("torch")
from repro.trace import aggregate as jagg  # noqa: E402
from repro.trace import critical as jcrit  # noqa: E402
from repro.trace import export as jexp  # noqa: E402
from repro.trace import schema as jschema  # noqa: E402
from repro_torch.trace import aggregate as tagg  # noqa: E402
from repro_torch.trace import critical as tcrit  # noqa: E402
from repro_torch.trace import export as texp  # noqa: E402
from repro_torch.trace import schema  # noqa: E402

# the packages export a function named ``decode`` over the module's name
jdec = importlib.import_module("repro.trace.decode")
tdec = importlib.import_module("repro_torch.trace.decode")

TICK = 0.05


def _task_rows(n=400, dropped_every=0, tx_frac=0.3, seed=3):
    g = np.random.default_rng(seed)
    rows = []
    for i in range(n):
        created = float(g.uniform(0, 20))
        lat = float(g.lognormal(-1.0, 1.0))
        drop = dropped_every and i % dropped_every == 0
        rows.append(schema.pack_np(
            i, int(g.integers(0, 8)), int(g.integers(0, 8)), created,
            created + lat, schema.DROPPED if drop else int(g.integers(0, 3)),
            0 if drop else 30, int(g.integers(0, 4)),
            energy_j=float(g.uniform(0, 1)), tx_time_s=tx_frac * lat))
    return np.stack(rows)


def _hop_rows(n=200, stall_ticks=2, seed=4):
    g = np.random.default_rng(seed)
    rows = np.zeros((n, schema.NUM_HOP_FIELDS), np.float64)
    rows[:, schema.HOP_SEQ] = np.arange(n)
    rows[:, schema.HOP_SRC] = g.integers(0, 8, n)
    rows[:, schema.HOP_DST] = (rows[:, schema.HOP_SRC] + 1) % 8
    rows[:, schema.HOP_T_DEPART] = g.uniform(0.0, 0.4, n)
    rows[:, schema.HOP_T_ARRIVE] = g.uniform(0.5, 1.5, n)
    rows[:, schema.HOP_BITS] = g.uniform(1e5, 1e7, n)
    rows[:, schema.HOP_BOUNDARY_LAYER] = g.integers(0, 60, n)
    rows[:, schema.HOP_STALL_TICKS] = stall_ticks
    return rows


def _state(R=2, S=12, M=5, seed=5):
    g = np.random.default_rng(seed)
    st = g.uniform(0, 4, size=(R, S, M, schema.NUM_STATE_GAUGES))
    sy = np.cumsum(g.uniform(0, 2, size=(R, S, schema.NUM_SYS_GAUGES)),
                   axis=1)
    ep = np.tile(np.arange(S, dtype=np.float64), (R, 1))
    ep[:, -2:] = -1.0                      # the scan ended before them
    return st.astype(np.float32), sy.astype(np.float32), ep


def assert_same(got, want, path="out"):
    """Equal structures: dicts by key, arrays and numbers exactly."""
    if isinstance(want, dict):
        assert sorted(got) == sorted(want), path
        for k in want:
            assert_same(got[k], want[k], f"{path}.{k}")
    elif isinstance(want, (list, tuple)):
        assert len(got) == len(want), path
        for i, (g, w) in enumerate(zip(got, want, strict=True)):
            assert_same(g, w, f"{path}[{i}]")
    elif isinstance(want, np.ndarray):
        assert isinstance(got, np.ndarray) and got.dtype == want.dtype, path
        np.testing.assert_array_equal(got, want, err_msg=path)
    else:
        assert type(got) is type(want) and got == want, path


def test_schema_vocabulary_matches_reference():
    for name in ("FIELDS", "INT_FIELDS", "HOP_FIELDS", "HOP_INT_FIELDS",
                 "STATE_GAUGES", "SYS_GAUGES", "DROPPED", "NUM_FIELDS",
                 "NUM_HOP_FIELDS", "NUM_STATE_GAUGES", "NUM_SYS_GAUGES"):
        assert getattr(schema, name) == getattr(jschema, name), name
    assert tcrit.SEGMENTS == jcrit.SEGMENTS == schema.SEGMENTS
    assert tagg.QS == jagg.QS and tagg.PHI_EPS == jagg.PHI_EPS


def test_tensor_packers_match_reference():
    args = (np.arange(3), 1, np.array([2, 0, 1]), 0.5, np.array([1., 2., 3.]),
            3, 0, np.array([1, 0, 2]), 0.25, 0.0)
    want = np.asarray(jschema.pack(*args))
    got = schema.pack(*(torch.as_tensor(a) if isinstance(a, np.ndarray)
                        else a for a in args)).numpy()
    np.testing.assert_array_equal(got, want)
    hargs = (np.arange(2), 0, 1, 0.1, np.array([0.2, 0.3]), 8e6, 3, 2)
    np.testing.assert_array_equal(
        schema.pack_hop(*(torch.as_tensor(a) if isinstance(a, np.ndarray)
                          else a for a in hargs)).numpy(),
        np.asarray(jschema.pack_hop(*hargs)))
    np.testing.assert_array_equal(schema.empty_buffer(4)[0].numpy(),
                                  np.asarray(jschema.empty_buffer(4)))
    np.testing.assert_array_equal(schema.empty_hop_buffer(4)[0].numpy(),
                                  np.asarray(jschema.empty_hop_buffer(4)))


@pytest.mark.parametrize("dropped_every", [0, 7, 1])
def test_decode_and_task_indices_match_reference(dropped_every):
    rows = _task_rows(dropped_every=dropped_every)
    buf = np.concatenate([rows, np.full((5, schema.NUM_FIELDS), -1.0)])
    want = jdec.decode(buf[None], np.array([3]))
    got = tdec.decode(torch.from_numpy(buf[None]), torch.tensor([3]))
    assert_same(got, want)
    assert_same(tagg.trace_indices(got), jagg.trace_indices(want))
    assert_same(tdec.split_runs(np.stack([buf, buf])),
                jdec.split_runs(np.stack([buf, buf])))


@pytest.mark.parametrize("tick,power", [(None, None), (TICK, None),
                                        (TICK, 20.0)])
def test_decode_hops_and_hop_indices_match_reference(tick, power):
    rows = _hop_rows()
    want = jdec.decode_hops(rows, np.int32(2))
    got = tdec.decode_hops(torch.from_numpy(rows), 2)
    assert_same(got, want)
    assert_same(tagg.hop_indices(got, tick, power),
                jagg.hop_indices(want, tick, power))
    assert_same(tagg.link_bits(got), jagg.link_bits(want))
    if tick is not None:
        assert_same(tagg.link_energy_j(got, tick, 20.0),
                    jagg.link_energy_j(want, tick, 20.0))
        assert_same(tdec.split_runs(rows, hops=True),
                    jdec.split_runs(rows, hops=True))


@pytest.mark.parametrize("which", ["all", "sys", "state"])
def test_decode_state_and_state_indices_match_reference(which):
    st, sy, ep = _state()
    kw = {"all": dict(state=st, sys=sy, epochs=ep), "sys": dict(sys=sy),
          "state": dict(state=st)}[which]
    want = jdec.decode_state(**kw)
    got = tdec.decode_state(**{k: torch.from_numpy(np.asarray(v))
                               for k, v in kw.items()})
    assert_same(got, want)
    assert_same(tagg.state_indices(got), jagg.state_indices(want))


def test_histograms_and_fairness_match_reference():
    x = np.random.default_rng(0).integers(0, 5, 100)
    assert_same(tagg.int_histogram(x), jagg.int_histogram(x))
    assert tagg.jain_fairness(x) == jagg.jain_fairness(x)
    assert tagg.jain_fairness([]) == jagg.jain_fairness([]) == 0.0
    assert tagg.quantile_summary([]) is None


@pytest.mark.parametrize("hops,kw", [
    (True, dict(tick_s=TICK, gflops_per_layer=0.2, capability_gflops=400.0)),
    (False, dict(gflops_per_layer=0.2, capability_gflops=400.0)),
    (False, {})])
def test_critical_path_matches_reference(hops, kw):
    dec = jdec.decode(_task_rows(dropped_every=7))
    hdec = jdec.decode_hops(_hop_rows()) if hops else None
    assert_same(tcrit.decompose(dec, hdec, **kw),
                jcrit.decompose(dec, hdec, **kw))
    assert_same(tcrit.segment_indices(dec, hdec, **kw),
                jcrit.segment_indices(dec, hdec, **kw))
    if hdec is not None:
        assert tcrit.hop_stall_fraction(hdec, TICK) == \
            jcrit.hop_stall_fraction(hdec, TICK)


def test_decompose_reconciles_per_task():
    dec = tdec.decode(_task_rows(dropped_every=7))
    hdec = tdec.decode_hops(_hop_rows())
    seg = tcrit.decompose(dec, hdec, tick_s=TICK, gflops_per_layer=0.2,
                          capability_gflops=400.0)
    total = sum(seg[name] for name in tcrit.SEGMENTS)
    np.testing.assert_allclose(total, seg["latency_s"], rtol=0, atol=1e-9)
    assert seg["latency_s"].size == int((~dec["is_dropped"]).sum())
    for name in tcrit.SEGMENTS:
        assert (seg[name] >= -1e-12).all()


def test_hop_stall_fraction_bounds():
    assert tcrit.hop_stall_fraction(
        tdec.decode_hops(_hop_rows(stall_ticks=0)), TICK) == 0.0
    assert tcrit.hop_stall_fraction(
        tdec.decode_hops(_hop_rows(stall_ticks=1000)), TICK) == 1.0
    empty = tdec.decode_hops(np.full((4, schema.NUM_HOP_FIELDS), -1.0))
    assert tcrit.hop_stall_fraction(empty, TICK) == 0.0


def test_segment_indices_stable_keys_and_attribution():
    dec = tdec.decode(_task_rows())
    out = tcrit.segment_indices(dec, tdec.decode_hops(_hop_rows()),
                                tick_s=TICK, gflops_per_layer=0.2,
                                capability_gflops=400.0)
    assert out["reconcile_max_err_s"] < 1e-9
    assert sum(out[f"{n}_share"] for n in tcrit.SEGMENTS) == \
        pytest.approx(1.0)
    empty = tcrit.segment_indices(tdec.decode(_task_rows(n=5,
                                                         dropped_every=1)))
    assert sorted(empty) == sorted(out) and empty["task_count"] == 0
    cur = dict(out)
    cur["queue_wait_s_quantiles"] = dict(out["queue_wait_s_quantiles"])
    cur["queue_wait_s_quantiles"]["p50"] += 1.0
    hit = tcrit.attribute(out, cur)
    assert hit == jcrit.attribute(out, cur)
    assert hit["segment"] == "queue_wait_s"
    assert tcrit.attribute(out, out) is None
    assert tcrit.attribute({}, {}) is None


@pytest.mark.parametrize("with_hops,with_state", [
    (False, False), (True, False), (True, True)])
def test_chrome_trace_is_byte_identical_to_reference(tmp_path, with_hops,
                                                     with_state):
    dec = jdec.decode(_task_rows(n=60, dropped_every=5))
    hdec = jdec.decode_hops(_hop_rows(n=30)) if with_hops else None
    sdec = jdec.decode_state(*_state()) if with_state else None
    want = jexp.write_chrome_trace(str(tmp_path / "j.json"), dec, hdec,
                                   TICK, sdec)
    got = texp.write_chrome_trace(str(tmp_path / "t.json"), dec, hdec,
                                  TICK, sdec)
    with open(got, "rb") as f, open(want, "rb") as g:
        assert f.read() == g.read()
    with open(got) as f:
        assert json.load(f)["traceEvents"]
    assert texp.hop_trace_events(hdec or jdec.decode_hops(_hop_rows(5))) \
        == jexp.hop_trace_events(hdec or jdec.decode_hops(_hop_rows(5)))
