"""The control of each cell's comparison, at reduced sizes on the CPU: the
reference computed in float8 (``bench/control.py``'s ``readings``, the
same code that reads it on the card at the cell's size, the serve cells
at every depth the engine can serve at) reads at least three times what
the sound program reads on one of the numbers the cell compares, and
under limits set between the two by the rule of ``bench/limits/``
(``limit_between``) the sound run comes out correct and the control,
judged by ``control.py`` itself, does not.

    PYTHONPATH=src python -m pytest -q bench/tests/test_bench_control.py
"""
from __future__ import annotations

import pytest

import bench_tiny
import control
from harness.common import compare, limit_between, verdict

SEED = 2**31 + 5
CELLS = ["train.qwen3-1.7b.seq4k", "train.granite-moe-1b-a400m.seq4k",
         "split.qwen3-1.7b.steady", "split.granite-moe-1b-a400m.surge"]


@pytest.mark.parametrize("name", CELLS)
def test_the_control_reads_well_above_the_program(name):
    cell = bench_tiny.tiny_cell(name)
    model = bench_tiny.tiny_model(cell.model)
    seconds = 2.0 if cell.mix["driver"] == "split" else 0.2
    sound = {k: c["value"] for k, c in bench_tiny.run_tiny(
        name, seed=SEED, seconds=seconds).compared.items()}
    fp8 = control.readings(cell, model, SEED, "cpu", seconds=seconds)["fp8"]
    low = {k: c["value"] for k, c in fp8["compared"].items()}
    limits = {k: limit_between(sound[k], low[k]) for k in sound
              if 0 < 3 * sound[k] <= low[k]}
    assert limits, (low, sound)
    assert verdict(compare(sound, limits))
    assert control.judged(fp8["read"], limits)["correct"] is False
