"""The port's SLO observatory (``repro_torch.obs``: histograms, registry,
Prometheus exposition, SLO report, open-loop load generator) against the
JAX package's ``repro.obs``, on the CPU.

Everything here is integer counts and float64 host arithmetic on the same
float32 edge grid, so every comparison is exact: the torch ``fill`` equals
``fill_np`` and JAX's ``fill`` bucket for bucket; the arrival processes
draw the same ``default_rng`` streams; a ``run_open_loop`` of 20,000 rows
through both synthetic engines gives equal ``slo_indices``, key for key,
equal histograms, records and flight-recorder rows, and byte-identical
Prometheus text.
"""
import dataclasses

import numpy as np
import pytest

torch = pytest.importorskip("torch")
import jax.numpy as jnp  # noqa: E402

from repro import obs as jobs  # noqa: E402
from repro.obs import hist as jhist  # noqa: E402
from repro.obs import loadgen as jloadgen  # noqa: E402
from repro.obs import prom as jprom  # noqa: E402
from repro.obs import slo as jslo  # noqa: E402
from repro_torch import obs as tobs  # noqa: E402
from repro_torch.obs import hist as thist  # noqa: E402
from repro_torch.obs import loadgen as tloadgen  # noqa: E402
from repro_torch.obs import prom as tprom  # noqa: E402
from repro_torch.obs import slo as tslo  # noqa: E402

SPECS = [(1e-4, 1e4, 384), (1e-3, 10.0, 40), (0.5, 2.0, 3)]


def _specs(lo, hi, buckets):
    return jhist.HistSpec(lo, hi, buckets), thist.HistSpec(lo, hi, buckets)


def _values(seed=0, n=5000):
    rng = np.random.default_rng(seed)
    v = np.exp(rng.uniform(np.log(1e-6), np.log(1e6), n))
    special = [0.0, -1.0, 1e-4, 1e4, np.inf, -np.inf, np.nan, 0.5, 2.0]
    edges = jhist.edges(jhist.HistSpec())[::37].astype(np.float64)
    return np.concatenate([v, special, edges, np.nextafter(edges, 0)])


@pytest.mark.parametrize("lo,hi,buckets", SPECS)
def test_edges_and_derived_match_reference(lo, hi, buckets):
    js, ts = _specs(lo, hi, buckets)
    assert ts.num_bins == js.num_bins and ts.growth == js.growth
    for name in ("edges", "upper_edges", "lower_edges"):
        np.testing.assert_array_equal(getattr(thist, name)(ts),
                                      getattr(jhist, name)(js))


@pytest.mark.parametrize("weighted", [False, True])
@pytest.mark.parametrize("lo,hi,buckets", SPECS)
def test_torch_fill_equals_fill_np_and_jax(lo, hi, buckets, weighted):
    js, ts = _specs(lo, hi, buckets)
    v = _values(buckets)
    w = np.random.default_rng(1).integers(0, 5, v.shape) if weighted \
        else None
    want_idx = np.asarray(jhist.bucket_of(js, v))
    got_idx = thist.bucket_of(ts, torch.from_numpy(v))
    np.testing.assert_array_equal(got_idx.numpy(), want_idx)
    want = np.asarray(jhist.fill(js, jhist.empty(js), v, w))
    empty = thist.empty(ts, device="cpu")
    assert empty.dtype == torch.int32 and empty.shape == (ts.num_bins,)
    got = thist.fill(ts, empty, torch.from_numpy(v),
                     None if w is None else torch.from_numpy(w))
    assert got.dtype == torch.int32 and not empty.any()     # not written
    np.testing.assert_array_equal(got.numpy(), want)
    host = thist.fill_np(ts, thist.empty_np(ts), v, w)
    np.testing.assert_array_equal(host, want)
    # a scalar weight broadcasts
    np.testing.assert_array_equal(
        thist.fill(ts, empty, torch.from_numpy(v), 3).numpy(),
        np.asarray(jhist.fill(js, jhist.empty(js), v, 3)))


def test_merge_total_quantiles_match_reference():
    js, ts = _specs(1e-4, 1e4, 384)
    parts = [thist.fill_np(ts, thist.empty_np(ts), _values(s, 700))
             for s in range(4)]
    whole = thist.fill_np(ts, thist.empty_np(ts),
                          np.concatenate([_values(s, 700) for s in range(4)]))
    merged = thist.merge(*parts[:2], torch.from_numpy(parts[2]), parts[3])
    np.testing.assert_array_equal(merged, whole)
    np.testing.assert_array_equal(merged, jhist.merge(*parts))
    assert thist.total(merged) == jhist.total(whole)
    for q in (0.0, 0.5, 0.9, 0.99, 0.999, 1.0):
        assert thist.quantile(ts, merged, q) == jhist.quantile(js, whole, q)
        assert thist.quantile_bucket(ts, merged, q) == \
            jhist.quantile_bucket(js, whole, q)
    assert thist.summary(ts, merged) == jhist.summary(js, whole)
    assert thist.quantile_bucket(ts, thist.empty_np(ts), 0.5) is None


def test_empty_needs_cuda_by_default():
    if torch.cuda.is_available():
        pytest.skip("this machine has CUDA: the default device is valid")
    with pytest.raises(RuntimeError, match="CUDA"):
        thist.empty(thist.HistSpec())


def _fill_registry(mod, hist_mod):
    reg = mod.Registry()
    c = reg.counter("reqs_total", "requests", {"route": 'a"b\\c\nd'})
    c.inc(3)
    c.inc(0.5)
    assert reg.counter("reqs_total") is c
    g = reg.gauge("depth", "queue depth")
    g.set(7)
    g.dec(2)
    g.inc(0.25)
    h = reg.histogram("lat_seconds", "latency", {"p": "x"},
                      spec=hist_mod.HistSpec(1e-3, 10.0, 40))
    h.observe(0.02, 3)
    h.observe_many(_values(2, 300)[np.isfinite(_values(2, 300))])
    h.observe_many([0.5, 0.7], [2, 0])
    h.merge_from(np.arange(h.spec.num_bins), 1.5)
    reg.histogram("empty_seconds")
    return reg


def test_registry_semantics_and_prometheus_text_match_reference():
    treg, jreg = _fill_registry(tobs, thist), _fill_registry(jobs, jhist)
    with pytest.raises(ValueError):
        treg.counter("reqs_total").inc(-1)
    with pytest.raises(TypeError):
        treg.gauge("reqs_total")
    assert "depth" in treg and treg["depth"].value == jreg["depth"].value
    h = treg["lat_seconds"]
    assert h.count == jreg["lat_seconds"].count
    assert h.sum == jreg["lat_seconds"].sum
    assert h.summary() == jreg["lat_seconds"].summary()
    assert h.quantile(0.5) == jreg["lat_seconds"].quantile(0.5)
    text = treg.to_prometheus()
    assert text == jprom.render(jreg) == tprom.render(treg)
    assert tprom.parse(text) == jprom.parse(text)
    parsed = tprom.parse(text)
    assert parsed["types"]["lat_seconds"] == "histogram"


@pytest.mark.parametrize("bad", [
    "x{a=\"1\"} 1 2 3\n",                                   # malformed sample
    "# TYPE h histogram\nh_count 1\n",                      # no buckets
    "# TYPE h histogram\nh_bucket{le=\"1\"} 2\n"
    "h_bucket{le=\"+Inf\"} 1\nh_count 1\n",                 # not cumulative
    "# TYPE h histogram\nh_bucket{le=\"+Inf\"} 2\nh_count 1\n",  # != count
    "# TYPE h\n",                                           # malformed TYPE
])
def test_strict_parse_rejects_what_the_reference_rejects(bad):
    with pytest.raises(ValueError):
        jprom.parse(bad)
    with pytest.raises(ValueError):
        tprom.parse(bad)


def test_host_class_matches_reference(monkeypatch):
    monkeypatch.delenv("REPRO_HOST_CLASS", raising=False)
    assert tobs.host_class() == jobs.host_class()
    monkeypatch.setenv("REPRO_HOST_CLASS", "h100-sxm")
    assert tobs.host_class() == jobs.host_class() == "h100-sxm"


@pytest.mark.parametrize("seed", [0, 7, 1100])
def test_arrival_processes_match_reference(seed):
    for rate, horizon in ((6400.0, 3.0), (50.0, 40.0), (0.0, 5.0)):
        np.testing.assert_array_equal(
            tloadgen.poisson_arrivals(rate, horizon, seed=seed),
            jloadgen.poisson_arrivals(rate, horizon, seed=seed))
        kw = dict(mean_lo_s=1.5, mean_hi_s=0.5, seed=seed)
        np.testing.assert_array_equal(
            tloadgen.mmpp_arrivals(0.8 * rate, 1.6 * rate, horizon, **kw),
            jloadgen.mmpp_arrivals(0.8 * rate, 1.6 * rate, horizon, **kw))
    trace = np.random.default_rng(seed).uniform(-1.0, 10.0, 500)
    for horizon in (None, 6.0):
        np.testing.assert_array_equal(
            tloadgen.replay_arrivals(trace, horizon),
            jloadgen.replay_arrivals(trace, horizon))


def _run(loadgen, slo, times, rate, **kw):
    eng = loadgen.SyntheticServeEngine(**kw)
    st = loadgen.run_open_loop(eng, times, dt=0.01, max_batch=64)
    idx = slo.slo_indices(st, horizon_s=float(eng.clock),
                          offered_rows=int(times.size), rate_rps=rate,
                          max_queue=kw.get("max_queue"))
    return eng, st, idx


@pytest.mark.parametrize("process,mult,max_queue", [
    ("poisson", 1.1, 16),             # past the knee: drops, early exits
    ("poisson", 0.8, None),
    ("mmpp", 0.95, 64),
])
def test_open_loop_through_both_synthetic_engines(process, mult, max_queue):
    """About 20,000 rows at the loadtest's rule (capacity max_batch / dt,
    seed + round(1000 · mult))."""
    rate = mult * 64 / 0.01
    horizon = 20_000 / rate
    seed = int(round(1000 * mult))
    if process == "poisson":
        times = jloadgen.poisson_arrivals(rate, horizon, seed=seed)
    else:
        times = jloadgen.mmpp_arrivals(0.8 * rate, 1.6 * rate, horizon,
                                       mean_lo_s=0.6, mean_hi_s=0.2,
                                       seed=seed)
    kw = dict(n_stages=4, max_queue=max_queue, state_every=3,
              max_records=5_000)
    jeng, jst, jidx = _run(jloadgen, jslo, times, rate, **kw)
    teng, tst, tidx = _run(tloadgen, tslo, times, rate, **kw)
    assert tidx == jidx                              # key for key, exact
    assert tst.exit_counts == jst.exit_counts
    assert (tst.completed, tst.dropped, tst.record_overflow) == \
        (jst.completed, jst.dropped, jst.record_overflow)
    np.testing.assert_array_equal(tst.latency_counts, jst.latency_counts)
    for name, counts in jst.segment_counts.items():
        np.testing.assert_array_equal(tst.segment_counts[name], counts)
    np.testing.assert_array_equal(tst.records, jst.records)
    np.testing.assert_array_equal(tst.state_records, jst.state_records)
    np.testing.assert_array_equal(tst.stage_state, jst.stage_state)
    np.testing.assert_array_equal(np.asarray(teng.cong.D),
                                  np.asarray(jeng.cong.D))
    treg = tslo.fill_registry(tobs.Registry(), tst, process=process)
    jreg = jslo.fill_registry(jobs.Registry(), jst, process=process)
    assert tprom.render(treg) == jprom.render(jreg)
    tprom.parse(tprom.render(treg))
    assert tslo.perfetto_counter_events(tst) == \
        jslo.perfetto_counter_events(jst)
    if max_queue and mult > 1.0:
        assert tst.dropped > 0 and tst.exit_counts[2] > 0


def test_slo_report_of_an_empty_run_matches_reference():
    jidx = jslo.slo_indices(jloadgen.SyntheticServeEngine().stats,
                            horizon_s=0.0, offered_rows=0)
    tidx = tslo.slo_indices(tloadgen.SyntheticServeEngine().stats,
                            horizon_s=0.0, offered_rows=0)
    assert tidx == jidx
    assert tslo.perfetto_counter_events(
        tloadgen.SyntheticServeEngine().stats) == []


def test_synthetic_engine_needs_no_tensor():
    """The load generator's engine keeps float64 numpy congestion state and
    steps without a tensor round trip (the serve engine's host reads take
    numpy and tensors alike)."""
    eng = tloadgen.SyntheticServeEngine(n_stages=2, layers_per_stage=3)
    assert eng.cong.D.dtype == np.float64
    for t in range(5):
        eng.submit(rows=4, t_now=0.01 * t)
        eng.step(dt=0.01, t_now=0.01 * (t + 1))
    eng.drain(dt=0.01)
    assert eng.stats.completed == 20
    assert isinstance(eng.cong.D, np.ndarray)
    assert dataclasses.is_dataclass(tobs.HistSpec())
    assert jnp.asarray(eng.stats.latency_counts).sum() == 20
