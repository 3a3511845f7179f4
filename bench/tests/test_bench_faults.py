"""The comparison that decides ``correct`` catches a broken timed path.

Each test skips the harness's look for a card and drives the rest of a
run on the CPU at reduced sizes (``bench_tiny``), with the program broken
underneath, and sees ``correct`` come out false under the cell's own
limits; the broken run's failing number also reads well above what the
sound run reads.  The faults are those a one-card cell can have: a
training step that returns its state unchanged, a step that leaves out
half of the batch (the mean taken over the rest), and a served answer
altered where the program produces it.

    PYTHONPATH=src python -m pytest -q bench/tests/test_bench_faults.py
"""
from __future__ import annotations

import pytest
import torch

import bench_tiny

TRAIN = "train.qwen3-1.7b.seq4k"


def state_unchanged(step):
    def broken(state, batch):
        _, metrics = step(state, batch)
        return state, metrics
    return broken


def half_batch(step):
    def broken(state, batch):
        n = batch["tokens"].shape[0] // 2
        return step(state, {k: v[:n] for k, v in batch.items()})
    return broken


def answer_altered(engine):
    head = engine._head_fn

    def broken(h):
        return -head(h)          # every position served its worst token
    engine._head_fn = broken


@pytest.fixture(scope="module")
def sound_train():
    return bench_tiny.run_tiny(TRAIN, seconds=0.2).compared


@pytest.mark.parametrize("fault", [state_unchanged, half_batch],
                         ids=lambda f: f.__name__)
def test_a_broken_training_step_is_not_correct(fault, sound_train):
    out = bench_tiny.run_tiny(TRAIN, seconds=0.2, fault=fault)
    assert out.correct is False
    failing = [k for k, c in out.compared.items() if c["value"] > c["limit"]]
    assert failing
    assert any(out.compared[k]["value"] >= 3 * sound_train[k]["value"]
               for k in failing)


@pytest.mark.parametrize("name", ["split.qwen3-1.7b.steady",
                                  "split.granite-moe-1b-a400m.surge"])
def test_an_altered_answer_is_not_correct(name):
    sound = bench_tiny.run_tiny(name, seconds=2.0).compared
    out = bench_tiny.run_tiny(name, seconds=2.0, fault=answer_altered)
    assert out.correct is False
    failing = [k for k, c in out.compared.items() if c["value"] > c["limit"]]
    assert failing
    for k in failing:
        gap = out.compared[k]["value"]
        assert torch.isfinite(torch.tensor(gap))
        assert gap >= 3 * sound[k]["value"]
