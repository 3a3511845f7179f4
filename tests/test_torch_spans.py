"""The port's timing spans and device counters (``repro_torch.obs.spans``)
on the CPU, and on the card where there is one.

* Off (the default) is a no-op: ``span`` returns the shared no-op,
  ``grad_mark`` its argument, and nothing is recorded.
* Spans nest per thread; counters stay tensors until ``collect()``, which
  clears the buffers and folds them into a ``Registry``.
* The MoE block's ``.bwd`` marks open and close in the order its regions
  ran backward; meta tensors record nothing.
* Spans on and off give ``torch.equal`` logits (split engine), loss and
  gradients (train step) and parameters after ``apply_updates``.
* The split engine's ``serve.queue`` / ``serve.request`` spans cover each
  request once per stage it traversed.
* On the card: host and card intervals lie on one clock, and spans opened
  under ``torch.profiler`` appear as its ``user_annotation`` events.
"""
import dataclasses
import threading

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro_torch.configs import get_config, reduced  # noqa: E402
from repro_torch.launch.step import (TrainState, make_train_step,  # noqa: E402
                                     trainable)
from repro_torch.models import build_model  # noqa: E402
from repro_torch.models import moe as moe_mod  # noqa: E402
from repro_torch.obs import prom, spans  # noqa: E402
from repro_torch.obs.registry import Registry  # noqa: E402
from repro_torch.optim import OptConfig, apply_updates, init_opt  # noqa: E402
from repro_torch.splitcompute import SplitServeEngine, plan_stages  # noqa: E402
from repro_torch.trace import schema  # noqa: E402

torch.set_num_threads(1)

MOE_PARTS = ("moe.route", "moe.dispatch", "moe.experts", "moe.combine")


@pytest.fixture(autouse=True)
def clean():
    """Every test starts and ends with tracing off and nothing recorded."""
    spans.disable()
    spans.collect()
    yield
    spans.disable()
    spans.collect()


def _granite(layers=4, cf=1.0):
    """A reduced granite-moe of ``layers`` layers whose capacity factor
    ``cf`` drops assignments."""
    cfg = reduced(get_config("granite-moe-1b-a400m"))
    return dataclasses.replace(
        cfg, num_layers=layers,
        moe=dataclasses.replace(cfg.moe, capacity_factor=cf))


def _moe_inputs(cfg, T=24, seed=0, device="cpu"):
    g = torch.Generator().manual_seed(seed)
    p = moe_mod.init_moe(g, cfg, torch.float32, "cpu")
    x = torch.randn(T, cfg.d_model, generator=g)
    return (x.to(device).requires_grad_(True),
            *[p[k].detach().to(device).requires_grad_(True)
              for k in ("router", "w_gate", "w_up", "w_down")])


def _empty(got):
    """Whether a ``collect()`` result holds no span and no counter."""
    return got["spans"] == [] and got["counters"] == {}


def _names(got):
    """The names of a ``collect()`` result's spans, or of a list of
    spans, in order."""
    return [s["name"] for s in (got["spans"] if isinstance(got, dict)
                                else got)]


def test_off_is_a_no_op():
    x = torch.ones(3, requires_grad=True)
    assert not spans.enabled()
    assert spans.span("a", True, stage=1) is spans.OFF
    with spans.span("a") as s:
        assert s is spans.OFF
    assert spans.grad_mark("a", x) is x
    assert spans.grad_mark("a", x, end=True) is x
    assert spans.begin("q", request=1) is None
    spans.end(None, spans.OFF)
    spans.count("c", 3)
    spans.count("c", torch.tensor(3))
    assert _empty(spans.collect())


def test_grad_mark_passes_through_where_no_grad_flows():
    spans.enable()
    x = torch.ones(3, requires_grad=True)
    with torch.no_grad():
        assert spans.grad_mark("a", x) is x
    y = torch.ones(3)
    assert spans.grad_mark("a", y) is y
    assert spans.grad_mark("a", x) is not x


def test_spans_nest_per_thread():
    spans.enable()
    seen = {}

    def other():
        with spans.span("t.outer", stage=7):
            with spans.span("t.inner"):
                pass
        seen["ident"] = threading.get_ident()

    with spans.span("m.outer", stage=2):
        th = threading.Thread(target=other)
        th.start()
        th.join()
        with spans.span("m.inner", request=5):
            pass
    got = spans.collect()["spans"]
    by = {s["name"]: (i, s) for i, s in enumerate(got)}
    assert set(by) == {"t.outer", "t.inner", "m.outer", "m.inner"}
    assert by["t.inner"][1]["parent"] == by["t.outer"][0]
    assert by["t.outer"][1]["parent"] is None      # not the main thread's
    assert by["m.inner"][1]["parent"] == by["m.outer"][0]
    assert by["m.outer"][1]["parent"] is None
    assert by["t.outer"][1]["thread"] == seen["ident"]
    assert by["m.outer"][1]["thread"] == threading.get_ident()
    assert by["t.outer"][1]["attrs"] == {"stage": 7}
    assert by["m.inner"][1]["attrs"] == {"request": 5}
    for _, s in by.values():
        assert s["host"][0] <= s["host"][1]
        assert s["card"] is None                       # host spans
    outer, inner = by["m.outer"][1]["host"], by["m.inner"][1]["host"]
    assert outer[0] <= inner[0] <= inner[1] <= outer[1]


def test_device_spans_on_the_cpu_take_the_host_interval():
    spans.enable()
    with spans.span("d", True):
        pass
    with spans.span("t", torch.ones(2)):
        pass
    with spans.span("m", torch.ones(2, device="meta")):
        pass
    got = spans.collect()["spans"]
    assert _names(got) == ["d", "t"]
    # a CPU tensor's span always; device=True's where no card is there
    cpu = got[1:] if torch.cuda.is_available() else got
    assert all(s["card"] == s["host"] for s in cpu)
    assert all(s["card"] is not None for s in got)


def test_begin_end_lend_the_card_end():
    """``end`` reads no clock: a wait ends where the open span beside it
    opened; a request ends where its closed head ended, on the host and
    on the card."""
    spans.enable()
    rec = spans.begin("req", request=3)
    wait = spans.begin("wait", stage=0, request=3)
    with spans.span("stage", True) as stage:
        spans.end(wait, stage)
    with spans.span("head", True) as head:
        pass
    spans.end(rec, head)
    got = {s["name"]: s for s in spans.collect()["spans"]}
    req, w = got["req"], got["wait"]
    assert req["parent"] is None and req["attrs"] == {"request": 3}
    assert w["attrs"] == {"stage": 0, "request": 3} and w["card"] is None
    assert w["host"][1] == got["stage"]["host"][0]
    assert req["host"][1] == got["head"]["host"][1]
    assert req["card"][0] == req["host"][0]
    assert req["card"][1] == got["head"]["card"][1]
    assert w["host"][0] <= w["host"][1] <= req["host"][1]


def test_counters_stay_tensors_until_collect():
    spans.enable()
    with torch.inference_mode():
        spans.count("c", torch.tensor(5))
    spans.count("c", torch.tensor(2))
    spans.count("h", 4)
    spans.count("h", 1)
    spans.count("m", torch.tensor(9, device="meta"))
    acc = spans._dev_counts["c"]
    assert isinstance(acc, torch.Tensor) and acc.dim() == 0
    assert acc.dtype == torch.int64
    reg = Registry()
    got = spans.collect(reg)
    assert got["counters"] == {"c": 7, "h": 5}
    assert reg["c"].value == 7 and reg["h"].value == 5
    parsed = prom.parse(reg.to_prometheus())
    assert parsed["types"] == {"h": "counter", "c": "counter"}


def test_collect_clears_the_buffers():
    spans.enable()
    with spans.span("a"):
        spans.count("c", 1)
    first = spans.collect()
    assert _names(first) == ["a"] and first["counters"] == {"c": 1}
    assert _empty(spans.collect())
    # a span still open is left out, and lands in the next collect
    s = spans.span("late")
    s.__enter__()
    assert spans.collect()["spans"] == []
    s.__exit__(None, None, None)
    assert _names(spans.collect()) == ["late"]


def test_spans_appear_as_profiler_ranges():
    from torch.profiler import ProfilerActivity, profile
    spans.enable()
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        with spans.span("prof.outer"):
            with spans.span("prof.inner", True):
                torch.ones(4).add_(1)
    names = {e.name for e in prof.events()}
    assert {"prof.outer", "prof.inner"} <= names
    with spans.span("after"):        # no profiler: no range, still a span
        pass
    assert _names(spans.collect()) == ["prof.inner", "prof.outer", "after"]


def test_moe_bwd_marks_follow_the_backward_order():
    cfg = _granite()
    x, *w = _moe_inputs(cfg)
    spans.enable()
    y, aux, dropped = moe_mod._moe_shard(x, *w, cfg)
    names = _names(spans.collect())
    assert names == list(MOE_PARTS)
    (y.square().sum() + aux).backward()
    got = spans.collect()["spans"]
    assert _names(got) == [
        "moe.combine.bwd", "moe.experts.bwd", "moe.dispatch.bwd",
        "moe.route.bwd"]
    for a, b in zip(got, got[1:]):               # one after the other
        assert a["host"][1] <= b["host"][0]
    assert all(s["parent"] is None for s in got)


def test_moe_counters_count_assignments_and_drops():
    cfg = _granite(cf=0.5)
    x, *w = _moe_inputs(cfg, T=32)
    A = 32 * cfg.moe.experts_per_token
    spans.enable()
    _, _, dropped = moe_mod._moe_shard(x, *w, cfg)
    _, _, dropped2 = moe_mod._moe_shard(x, *w, cfg)
    c = spans.collect()["counters"]
    assert c["moe.assignments"] == 2 * A
    assert c["moe.dropped"] == round(float(dropped) * A) * 2
    assert c["moe.dropped"] > 0
    assert float(dropped2) == float(dropped)


def test_moe_on_meta_records_nothing():
    cfg = _granite()
    x, *w = _moe_inputs(cfg, device="meta")
    spans.enable()
    y, _, _ = moe_mod._moe_shard(x, *w, cfg)
    assert y.is_meta
    assert _empty(spans.collect())


def _engine_run(cfg, params, on: bool, tau=(1.0, 3.0)):
    """Submit 6 requests in two bursts and step until drained; returns the
    engine and its completions in order."""
    F = np.maximum(np.random.default_rng(0).normal(400, 100, 4), 50.0)
    eng = SplitServeEngine(cfg, params, plan_stages(cfg, F), tau_med=tau[0],
                           tau_high=tau[1])
    if on:
        spans.enable()
    g = torch.Generator().manual_seed(1)
    done = []
    for r in range(6):
        toks = torch.randint(0, cfg.vocab_size, (2, 8 + 8 * (r % 3)),
                             generator=g)
        eng.submit({"tokens": toks}, t_now=0.01 * r)
        if r % 3 == 2:
            done += eng.step(dt=0.05)
    while any(eng.queues):
        done += eng.step(dt=0.05)
    spans.disable()
    return eng, done


@pytest.mark.parametrize("tau", [(1e30, 1e30), (0.5, 1.0)])
def test_engine_logits_are_the_same_with_spans_on(tau):
    cfg = _granite(layers=4)
    params = build_model(cfg).init(torch.Generator().manual_seed(0), "cpu")
    _, off = _engine_run(cfg, params, False, tau)
    _, on = _engine_run(cfg, params, True, tau)
    assert [r for r, _ in on] == [r for r, _ in off]
    for (_, a), (_, b) in zip(off, on):
        assert torch.equal(a, b)


def test_engine_queue_spans_cover_each_request_per_stage():
    cfg = _granite(layers=4)
    params = build_model(cfg).init(torch.Generator().manual_seed(0), "cpu")
    eng, done = _engine_run(cfg, params, True, (0.5, 1.0))
    got = spans.collect()["spans"]
    col = {f: schema.FIELDS.index(f) for f in ("seq", "hops")}
    hops = {int(r[col["seq"]]): int(r[col["hops"]])
            for r in eng.stats.records}
    assert sorted(hops) == sorted(r for r, _ in done)
    for rid, h in hops.items():
        waits = [s for s in got if s["name"] == "serve.queue"
                 and s["attrs"]["request"] == rid]
        assert sorted(s["attrs"]["stage"] for s in waits) == \
            list(range(h + 1))
        stages = [s for s in got if s["name"] == "serve.stage"
                  and s["attrs"]["request"] == rid]
        assert sorted(s["attrs"]["stage"] for s in stages) == \
            list(range(h + 1))
        req = [s for s in got if s["name"] == "serve.request"
               and s["attrs"]["request"] == rid]
        assert len(req) == 1
        r0, r1 = req[0]["card"]
        assert sum(s["host"][1] - s["host"][0] for s in waits) <= r1 - r0
        heads = [s for s in got if s["name"] == "serve.head"
                 and s["attrs"]["request"] == rid]
        assert len(heads) == 1
    names = set(_names(got))
    assert {"serve.submit", "serve.step", "serve.stage", "serve.head",
            "serve.queue", "serve.request"} <= names
    assert set(MOE_PARTS) <= names                 # no backward in serving
    steps = [i for i, s in enumerate(got) if s["name"] == "serve.step"]
    for s in got:
        if s["name"] in ("serve.stage", "serve.head"):
            assert s["parent"] in steps


def _train_setup(cfg, seed=0):
    model = build_model(cfg)
    params = trainable(model.init(torch.Generator().manual_seed(seed),
                                  "cpu"))
    g = torch.Generator().manual_seed(seed + 1)
    toks = torch.randint(0, cfg.vocab_size, (2, 16), generator=g)
    batch = {"tokens": toks, "labels": torch.roll(toks, -1, 1)}
    return model, params, batch


def _loss_and_grads(on: bool):
    model, params, batch = _train_setup(_granite(layers=2))
    if on:
        spans.enable()
    names, leaves = zip(*params.named_parameters())
    loss, _ = model.loss(params, batch)
    grads = torch.autograd.grad(loss, leaves, allow_unused=True)
    spans.disable()
    return params, loss, dict(zip(names, grads))


def test_loss_and_gradients_are_the_same_with_spans_on():
    _, loss_off, g_off = _loss_and_grads(False)
    _, loss_on, g_on = _loss_and_grads(True)
    got = spans.collect()["spans"]
    assert torch.equal(loss_off, loss_on)
    for n in g_off:
        assert (g_off[n] is None) == (g_on[n] is None), n
        if g_off[n] is not None:
            assert torch.equal(g_off[n], g_on[n]), n
    names = _names(got)
    # one backward a layer; the forward once, or twice where the layers'
    # remat policy recomputes it in the backward pass
    for part in MOE_PARTS:
        assert names.count(part + ".bwd") == 2, part
        assert names.count(part) in (2, 4), part
    assert names.count("lm.head_loss") == names.count("lm.head_loss.bwd") \
        == 1


def test_apply_updates_is_the_same_with_spans_on():
    outs = []
    for on in (False, True):
        params, _, grads = _loss_and_grads(False)
        state = init_opt(params)
        if on:
            spans.enable()
        apply_updates(params, grads, state, OptConfig())
        spans.disable()
        outs.append(dict(params.named_parameters()))
    for n, p in outs[0].items():
        assert torch.equal(p, outs[1][n]), n
    assert _names(spans.collect()) == ["optim.apply_updates"]


def test_train_step_is_the_same_with_spans_on():
    outs = []
    for on in (False, True):
        model, params, batch = _train_setup(_granite(layers=2))
        step = make_train_step(model, OptConfig())
        state = TrainState(params, init_opt(params))
        if on:
            spans.enable()
        for _ in range(2):
            state, met = step(state, batch)
        spans.disable()
        outs.append((met["loss"], dict(state.params.named_parameters())))
    assert torch.equal(outs[0][0], outs[1][0])
    for n, p in outs[0][1].items():
        assert torch.equal(p, outs[1][1][n]), n
    got = spans.collect()["spans"]
    steps = [i for i, s in enumerate(got) if s["name"] == "train.step"]
    assert len(steps) == 2
    opt = [s for s in got if s["name"] == "optim.apply_updates"]
    assert len(opt) == 2 and all(s["parent"] in steps for s in opt)


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    return torch.device("cuda")


@pytest.mark.cuda
def test_host_and_card_intervals_lie_on_one_clock(cuda):
    cfg = _granite(layers=2)
    x, *w = _moe_inputs(cfg, T=4096, device=cuda)
    spans.enable()
    for _ in range(3):
        with spans.span("outer", True):
            y, aux, _ = moe_mod._moe_shard(x, *w, cfg)
            big = torch.randn(2048, 2048, device=cuda)
            with spans.span("mm", True):
                for _ in range(8):
                    big = big @ big / 64.0
        (y.float().square().sum() + aux).backward()
    res = spans.collect()
    spans.disable()
    got = res["spans"]
    # the bound on the two clocks' offset: half the narrowest bracket of
    # the origin events (about 6 us on an H100), under the 50 us allowed;
    # plus the events' resolution, half a microsecond
    assert 0 < res["clock_error_s"] <= 50e-6
    tol = res["clock_error_s"] + 1e-6
    card = [s for s in got if s["card"] is not None]
    assert {s["name"] for s in card} >= set(MOE_PARTS) | {
        p + ".bwd" for p in MOE_PARTS} | {"outer", "mm"}
    # each event is recorded after its host read: a card time lies no
    # earlier than its host time, but for the offset (a span opened
    # after= another starts at that one's card end instead)
    for s in card:
        c0, c1 = s["card"]
        if s["name"] not in MOE_PARTS[1:]:
            assert c0 >= s["host"][0] - tol, s["name"]
        assert c1 >= s["host"][1] - tol, s["name"]
        assert c1 >= c0, s["name"]
    # spans that do not nest ran one after the other on the stream
    for thread in {s["thread"] for s in card}:
        top = sorted((s for s in card if s["thread"] == thread
                      and s["parent"] is None), key=lambda s: s["host"][0])
        for a, b in zip(top, top[1:]):
            assert b["card"][0] >= a["card"][1] - 1e-6, (a["name"],
                                                          b["name"])
    # the host ran ahead of the card on the matmuls
    mm = [s for s in card if s["name"] == "mm"]
    assert all(s["card"][1] > s["host"][1] + tol for s in mm)
    # the MoE block's parts share their boundary events (after=)
    fwd = [s for s in card if s["name"] in MOE_PARTS]
    assert [s["name"] for s in fwd] == list(MOE_PARTS) * 3
    for a, b in zip(fwd, fwd[1:]):
        if b["name"] != MOE_PARTS[0]:
            assert b["card"][0] == a["card"][1], (a["name"], b["name"])


@pytest.mark.cuda
def test_spans_are_user_annotations_in_a_card_trace(cuda):
    import json
    import os
    import tempfile

    from torch.profiler import ProfilerActivity, profile
    spans.enable()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        with spans.span("annot.step", True):
            torch.ones(1 << 20, device=cuda).mul_(2)
        torch.cuda.synchronize()
    spans.disable()
    fd, path = tempfile.mkstemp(suffix=".json")
    os.close(fd)
    try:
        prof.export_chrome_trace(path)
        with open(path) as f:
            events = json.load(f)["traceEvents"]
    finally:
        os.remove(path)
    cats = {e.get("cat") for e in events if e.get("name") == "annot.step"}
    assert "user_annotation" in cats
    assert _names(spans.collect()) == ["annot.step"]
