"""The benchmark's frozen arithmetic: arrival and length draws, weights and
batches from a seed, and the FLOP and byte counts behind ``mfu.*`` and
``*_roofline.*``.

    PYTHONPATH=src python -m pytest -q bench/tests/test_bench_arith.py
"""
from __future__ import annotations

import sys
from pathlib import Path

import numpy as np
import pytest
import torch

BENCH = Path(__file__).resolve().parents[1]
sys.path[:0] = [str(BENCH)]

from harness import arrivals as arr  # noqa: E402
from harness import flops  # noqa: E402
from harness.common import load_json  # noqa: E402
from harness.weights import (derive, draw_weights,  # noqa: E402
                             request_tokens, train_tokens)

BIG_SEED = 2**31 + 12345          # more than 32 signed bits hold


def _steady(seed, stream="arrivals"):
    return (arr.poisson_arrivals(8.0, 30.0, arr.rng_for(seed, stream)),
            arr.lognormal_lengths(240, 1024, 0.5, 256, 2048, 256,
                                  arr.rng_for(seed, stream + ".len")))


def _surge(seed):
    return arr.mmpp_arrivals(10.0, 60.0, 30.0, arr.rng_for(seed, "a"),
                             mean_lo_s=6.0, mean_hi_s=2.0, start_high=True)


@pytest.mark.parametrize("seed", [0, 7, BIG_SEED])
def test_draws_repeat_for_a_seed(seed):
    for a, b in zip(_steady(seed), _steady(seed)):
        np.testing.assert_array_equal(a, b)
    np.testing.assert_array_equal(_surge(seed)[0], _surge(seed)[0])


def test_seeds_change_the_order_not_the_work():
    (t1, l1), (t2, l2) = _steady(1), _steady(2)
    assert not np.array_equal(l1, l2)
    np.testing.assert_array_equal(np.sort(l1), np.sort(l2))
    assert len(t1) == len(t2) == 239
    assert not np.allclose(t1, t2)
    np.testing.assert_allclose(np.sort(np.diff(t1)), np.sort(np.diff(t2)),
                               rtol=0, atol=0.5)


def test_poisson_arrivals_span_the_horizon_at_the_rate():
    t, _ = _steady(3)
    assert np.all(np.diff(t) > 0) and 0 < t[0] and t[-1] < 30.0
    gaps = np.diff(np.concatenate([[0.0], t]))
    assert abs(gaps.mean() - 1 / 8.0) < 0.01


def test_mmpp_starts_high_and_alternates():
    times, dwells = _surge(4)
    assert dwells[0][2] is True
    assert all(a[2] != b[2] for a, b in zip(dwells, dwells[1:]))
    assert dwells[-1][1] == 30.0
    hi = sum(e - s for s, e, h in dwells if h)
    n_hi = sum(np.sum((times >= s) & (times < e)) for s, e, h in dwells if h)
    assert abs(n_hi / hi - 60.0) < 6.0


def test_lengths_are_clipped_rounded_and_seven_buckets():
    lens = _steady(5)[1]
    assert lens.min() >= 256 and lens.max() <= 2048
    assert np.all(lens % 256 == 0)
    assert arr.length_buckets(256, 2048, 256) == [256 * k for k in
                                                  range(1, 9)]
    assert set(lens.tolist()) <= set(arr.length_buckets(256, 2048, 256))
    assert abs(np.median(lens) - 1024) <= 256


def test_flash_forward_bound_is_perf_row_3():
    # PERF.md §6 row 3: (4, 512, 16, 8, 128) bf16 causal, 0.007512 ms
    assert round(flops.flash_fwd_bound_s(4, 512, 16, 8, 128) * 1e3, 6) == \
        0.007512


def test_flash_backward_bound_is_perf_row_8():
    # PERF.md §6 row 8: the same shape's backward, 0.015024 ms
    assert round(flops.flash_bwd_bound_s(4, 512, 16, 8, 128) * 1e3, 6) == \
        0.015024


def test_model_flops_of_the_dense_config():
    m = load_json(BENCH / "configs" / "qwen3-1.7b.json")
    d, L, V = 2048, 28, 151936
    per_token = (2 * d * 128 * (2 * 16 + 2 * 8) + 2 * 3 * d * 6144)
    attn = 4 * 128 * 16 * (4096 * 4097 // 2)
    want = 3 * (L * (2 * 4096 * per_token + 2 * attn) + 2 * 8192 * d * V)
    assert flops.train_step_flops(m, 2, 4096) == want
    # the weight products are 6 N T with N the non-embedding parameters
    n_layer = d * 128 * (2 * 16 + 2 * 8) + 3 * d * 6144
    assert flops.forward_flops(m, 1, 1, L) == pytest.approx(
        2 * L * n_layer + 2 * d * V + L * 4 * 128 * 16)


def test_model_flops_count_the_active_experts():
    m = load_json(BENCH / "configs" / "granite-moe-1b-a400m.json")
    dense = flops.layer_flops(m, 1, 1) - 4 * 64 * 16
    assert dense == 2 * 1024 * 64 * 48 + 2 * 1024 * 32 + 2 * 8 * 3 * 1024 * 512


def test_weights_and_batches_repeat_for_a_seed():
    m = load_json(BENCH / "configs" / "qwen3-1.7b.json")
    m = dict(m, num_hidden_layers=2, hidden_size=32, num_attention_heads=2,
             num_key_value_heads=1, head_dim=16, vocab_size=64,
             intermediate_size=24)
    a, b = draw_weights(m, BIG_SEED, "cpu"), draw_weights(m, BIG_SEED, "cpu")
    torch.testing.assert_close(a["layers"]["attn"]["wq"],
                               b["layers"]["attn"]["wq"], rtol=0, atol=0)
    c = draw_weights(m, BIG_SEED + 1, "cpu")
    assert not torch.equal(a["embed"], c["embed"])
    x1, y1 = train_tokens(BIG_SEED, 3, 2, 16, 64, "cpu")
    x2, _ = train_tokens(BIG_SEED, 3, 2, 16, 64, "cpu")
    assert torch.equal(x1, x2) and torch.equal(x1[:, 1:], y1[:, :-1])
    assert not torch.equal(x1, train_tokens(BIG_SEED, 4, 2, 16, 64, "cpu")[0])
    assert torch.equal(request_tokens(5, 9, 2, 8, 64, "cpu"),
                       request_tokens(5, 9, 2, 8, 64, "cpu"))
    assert derive(BIG_SEED, "w", "embed") < 2**63
