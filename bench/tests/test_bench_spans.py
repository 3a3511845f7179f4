"""The readers of the program's spans (``harness.spans``) on the CPU at
the reduced sizes: over a span window of a cell (spans on, a short
schedule served or one training step), every reader of the cell reads a
number, and every one reads None, without an error, where the program
has no ``repro_torch.obs.spans`` (as before it had one).

    PYTHONPATH=src python -m pytest -q bench/tests/test_bench_spans.py
"""
from __future__ import annotations

import sys

import pytest

import bench_tiny
from harness import spans

torch = pytest.importorskip("torch")

CELLS = sorted({c for _, cells in spans.READERS.values() for c in cells})
SEED = 2**31 + 17


def _tiny_window(name):
    """(whether the spans went on, what they collected) over a span window
    of cell ``name`` at the reduced sizes, on the CPU."""
    from harness import program, serve
    from harness.weights import draw_weights, train_tokens
    cpu = torch.device("cpu")
    cell = bench_tiny.tiny_cell(name)
    model = bench_tiny.tiny_model(cell.model)
    cfg = program.port_config(model)
    tree = draw_weights(model, SEED, cpu)
    if cell.mix["driver"] == "train":
        state = program.train_state(cfg, tree)
        step = program.train_step(cfg, cell.mix)
        tokens, labels = train_tokens(SEED, 1, model["train"]["batch"],
                                      model["train"]["seq"],
                                      model["vocab_size"], cpu)
        on = spans.spans_on()
        step(state, {"tokens": tokens, "labels": labels})
        return on, spans.collect_spans()
    engine = program.serve_engine(cfg, tree, cell.mix)
    drv = serve.Driver(engine, model, cell.mix, SEED, cpu)
    times, lens = serve.schedule(cell.mix, model["serve"]["knee_hz"], 1.5,
                                 "spans")
    on = spans.spans_on()
    drv.drive(times, lens, 1.5, drain=True)
    return on, spans.collect_spans()


@pytest.mark.parametrize("name", CELLS)
def test_every_span_reader_reads_a_number(name):
    on, got = _tiny_window(name)
    assert on and got["spans"]
    read = spans.readings(got, name)
    assert read and all(isinstance(v, float) and v >= 0
                        for v in read.values()), read
    for k in ("moe_route_share.surge", "moe_experts_share.surge",
              "moe_dispatch_share.train", "moe_combine_share.train",
              "head_loss_share.train", "queue_wait_share.serve",
              "moe_drop_share.surge"):
        if k in read:
            assert read[k] <= 100.0, (k, read[k])


@pytest.mark.parametrize("name", CELLS)
def test_span_readers_read_none_without_the_programs_spans(name,
                                                           monkeypatch):
    import repro_torch.obs
    from harness import program  # noqa: F401  (the program, loaded first)
    monkeypatch.delattr(repro_torch.obs, "spans", raising=False)
    monkeypatch.setitem(sys.modules, "repro_torch.obs.spans", None)
    assert spans.spans_on() is False
    assert spans.collect_spans() is None
    on, got = _tiny_window(name)
    assert on is False and got is None
    read = spans.readings(got or {}, name)
    assert read and all(v is None for v in read.values())


def test_readers_of_a_made_up_window():
    """Each reader's arithmetic on spans laid out by hand."""
    def sp(name, host, card=None, parent=None, **attrs):
        return {"name": name, "attrs": attrs, "parent": parent,
                "thread": 1, "host": list(host),
                "card": list(card) if card else None}
    ctx = {"spans": [
        sp("serve.step", (0.0, 0.010), (0.001, 0.030)),          # 0
        sp("serve.stage", (0.001, 0.004), (0.002, 0.012), 0,
           stage=0, request=7),
        sp("serve.head", (0.004, 0.006), (0.012, 0.020), 0, request=7),
        sp("moe.route", (0.001, 0.002), (0.002, 0.005), 1),
        sp("moe.experts", (0.002, 0.003), (0.005, 0.011), 1),
        sp("serve.queue", (-0.010, -0.004), stage=0, request=7),
        sp("serve.queue", (-0.001, 0.0), stage=0, request=8),      # not done
        sp("serve.request", (-0.010, 0.006), (-0.010, 0.020), request=7),
        sp("train.step", (0.0, 1.0), (0.0, 2.0)),
        sp("moe.dispatch", (0.1, 0.2), (0.1, 0.3)),
        sp("moe.dispatch.bwd", (0.3, 0.4), (0.5, 0.7)),
        sp("moe.combine.bwd", (0.2, 0.3), (0.3, 0.5)),
        sp("optim.apply_updates", (0.8, 0.9), (1.8, 1.9)),
        sp("lm.head_loss", (0.5, 0.6), (1.0, 1.2)),
        sp("lm.head_loss.bwd", (0.6, 0.7), (1.2, 1.3)),
    ], "counters": {"moe.assignments": 400, "moe.dropped": 9}}
    approx = pytest.approx
    assert spans.stage_ms(ctx) == approx(10.0)
    assert spans.head_ms(ctx) == approx(8.0)
    assert spans.engine_host_ms(ctx) == approx(10.0 - 3.0 - 2.0)
    assert spans.queue_wait_share(ctx) == approx(100 * 0.006 / 0.030)
    assert spans.moe_route_share(ctx) == approx(100 * 0.003 / 0.029)
    assert spans.moe_experts_share(ctx) == approx(100 * 0.006 / 0.029)
    assert spans.moe_drop_share(ctx) == approx(2.25)
    assert spans.moe_dispatch_share_train(ctx) == approx(100 * 0.4 / 2.0)
    assert spans.moe_combine_share_train(ctx) == approx(100 * 0.2 / 2.0)
    assert spans.optimizer_ms(ctx) == approx(100.0)
    assert spans.head_loss_share(ctx) == approx(100 * 0.3 / 2.0)
    assert all(v is None for c in CELLS
               for v in spans.readings({}, c).values())
