"""The port's split-serve stack (``repro_torch.splitcompute``,
``repro_torch.launch.serve``) against the JAX package's, on the CPU.

* ``plan_stages``: boundaries and executors exactly the reference's, φ
  within rtol 1e-5 (the φ tests of test_torch_core.py hold the same).
* The reduced launcher's whole run on the reference's bridged weights,
  with the same request keys: submitted tokens, completed rows, exit
  counts, records, state records and latency histograms are exact (the
  engine's clock and exit decisions do not depend on the numbers the
  model computes, and its host bookkeeping rounds as the reference's eager
  JAX does); the stashed logits agree within 2e-2, the bf16 tolerance of
  tests/test_models_smoke.py.
* The burst early exit of tests/test_splitcompute.py:59.
"""
import dataclasses

import numpy as np
import pytest

torch = pytest.importorskip("torch")
import jax  # noqa: E402

from repro.configs import get_config as jget_config  # noqa: E402
from repro.configs import reduced as jreduced  # noqa: E402
from repro.models import build_model as jbuild_model  # noqa: E402
from repro.splitcompute import SplitServeEngine as JEngine  # noqa: E402
from repro.splitcompute import plan_stages as jplan_stages  # noqa: E402
from repro_torch import bridge  # noqa: E402
from repro_torch.configs import get_config, reduced  # noqa: E402
from repro_torch.launch import serve as tserve  # noqa: E402
from repro_torch.launch.step import (make_decode_step,  # noqa: E402
                                     make_prefill_step)
from repro_torch.models import build_model  # noqa: E402
from repro_torch.splitcompute import SplitServeEngine as TEngine  # noqa: E402
from repro_torch.splitcompute import plan_stages  # noqa: E402

torch.set_num_threads(1)


@pytest.fixture(scope="module")
def weights():
    """(JAX cfg, JAX params, port cfg, port params) on the same weights."""
    jcfg = jreduced(jget_config("qwen3-1.7b"))
    jparams = jbuild_model(jcfg).init(jax.random.PRNGKey(0))
    tcfg = reduced(get_config("qwen3-1.7b"))
    return jcfg, jparams, tcfg, bridge.params_from_numpy(
        jax.tree.map(np.asarray, jparams), tcfg, device="cpu")


@pytest.mark.parametrize("F", [
    [100.0, 100.0, 800.0, 100.0],
    [412.6, 386.8, 464.0, 410.5],
    [400.0, 420.0],
    [300.0, 300.0, 300.0],
    list(np.maximum(np.random.default_rng(7).normal(400, 100, 8), 50.0)),
])
@pytest.mark.parametrize("full", [True, False])
def test_plan_stages_matches_reference(F, full):
    jcfg, tcfg = jget_config("qwen3-1.7b"), get_config("qwen3-1.7b")
    if not full:
        jcfg, tcfg = jreduced(jcfg), reduced(tcfg)
    want, got = jplan_stages(jcfg, F), plan_stages(tcfg, F)
    assert got.boundaries == want.boundaries
    assert got.executors == want.executors
    np.testing.assert_allclose(got.phi, want.phi, rtol=1e-5)


def _jax_launcher(cfg, params, requests, batch, seq, executors, burst):
    """The body of repro.launch.serve.main, returning what it built."""
    F = np.maximum(np.random.default_rng(0).normal(400, 100, executors),
                   50.0)
    plan = jplan_stages(cfg, F)
    eng = JEngine(cfg, params, plan)
    key, tokens = jax.random.PRNGKey(1), []
    for r in range(requests + burst):
        key, k = jax.random.split(key)
        toks = jax.random.randint(k, (batch, seq), 0, cfg.vocab_size)
        tokens.append(np.asarray(toks))
        eng.submit({"tokens": toks})
        if r < requests:
            eng.step()
    eng.drain()
    return F, plan, eng, tokens


def _same_stats(got, want):
    assert got.completed == want.completed
    assert got.generated == want.generated
    assert got.generated_rows == want.generated_rows
    assert got.dropped == want.dropped
    assert got.exit_counts == want.exit_counts
    assert got.latency_sum == want.latency_sum
    np.testing.assert_array_equal(got.records, want.records)
    np.testing.assert_array_equal(got.state_records, want.state_records)
    np.testing.assert_array_equal(got.stage_state, want.stage_state)
    np.testing.assert_array_equal(got.latency_counts, want.latency_counts)
    for seg, counts in want.segment_counts.items():
        np.testing.assert_array_equal(got.segment_counts[seg], counts)
    assert got.segment_sums == want.segment_sums
    assert got.latency_quantiles() == want.latency_quantiles()


@pytest.mark.parametrize("requests,batch,seq,executors,burst", [
    (6, 2, 64, 4, 0),
    (4, 2, 40, 3, 6),
])
def test_launcher_run_matches_reference(weights, requests, batch, seq,
                                        executors, burst):
    jcfg, jparams, tcfg, tparams = weights
    F, jplan, jeng, jtoks = _jax_launcher(jcfg, jparams, requests, batch,
                                          seq, executors, burst)
    run = tserve.serve(tcfg, requests, batch, seq, executors, burst,
                       device="cpu", params=tparams)
    np.testing.assert_array_equal(run.F, F)
    assert run.plan.boundaries == jplan.boundaries
    assert run.plan.executors == jplan.executors
    assert len(run.tokens) == len(jtoks) == requests + burst
    for got, want in zip(run.tokens, jtoks, strict=True):
        np.testing.assert_array_equal(got.numpy(), want)
    _same_stats(run.engine.stats, jeng.stats)
    assert run.engine.stats.completed == (requests + burst) * batch
    assert sorted(run.engine.results) == sorted(jeng.results)
    for rid, want in jeng.results.items():
        np.testing.assert_allclose(
            run.engine.results[rid].float().numpy(),
            np.asarray(want, np.float32), rtol=2e-2, atol=2e-2)


def test_burst_early_exit_matches_reference(weights):
    """12 requests at t = 0 with two service steps first
    (test_splitcompute.py:59): the early exit fires, identically."""
    jcfg, jparams, tcfg, tparams = weights
    engines = (JEngine(jcfg, jparams, jplan_stages(jcfg, [400.0, 420.0]),
                       tau_med=0.5, tau_high=1.5),
               TEngine(tcfg, tparams, plan_stages(tcfg, [400.0, 420.0]),
                       tau_med=0.5, tau_high=1.5))
    key = jax.random.PRNGKey(2)
    for r in range(12):
        key, k = jax.random.split(key)
        toks = np.asarray(jax.random.randint(k, (2, 16), 0,
                                             jcfg.vocab_size))
        engines[0].submit({"tokens": toks}, 0.0)
        engines[1].submit({"tokens": torch.tensor(toks).long()}, 0.0)
        if r < 2:
            for eng in engines:
                eng.step()
    want, got = (eng.drain() for eng in engines)
    assert got.completed == 12 * 2
    assert got.exit_counts[1] + got.exit_counts[2] > 0
    _same_stats(got, want)


def test_request_advances_at_most_one_stage_per_epoch(weights):
    """test_splitcompute.py's one-epoch-traversal regression, on the port."""
    _, _, tcfg, tparams = weights
    eng = TEngine(tcfg, tparams, plan_stages(tcfg, [400.0, 420.0]),
                  tau_med=1e9, tau_high=2e9)
    eng.submit({"tokens": torch.zeros(2, 16, dtype=torch.long)})
    assert eng.step() == []
    assert len(eng.queues[1]) == 1
    done = eng.step()
    assert [rid for rid, _ in done] == [0]
    assert eng.stats.completed == 2


def test_serve_steps_match_model_api(weights):
    _, _, tcfg, tparams = weights
    m = build_model(tcfg)
    toks = torch.from_numpy(np.random.default_rng(0).integers(
        0, 256, (2, 8))).long()
    last, caches = make_prefill_step(m)(tparams, {"tokens": toks})
    want_last, _ = m.prefill(tparams, {"tokens": toks})
    assert torch.equal(last, want_last)
    cache = m.init_cache(2, 9, device="cpu")
    for name in ("k", "v"):
        cache[name][:, :, :8] = caches[name]
    logits, _ = make_decode_step(m)(tparams, cache, {"token": toks[:, :1],
                                                     "pos": 8})
    assert logits.shape == (2, tcfg.vocab_size)


def test_serve_needs_cuda_by_default():
    if torch.cuda.is_available():
        pytest.skip("this machine has CUDA: the default device is valid")
    with pytest.raises(RuntimeError, match="CUDA"):
        tserve.serve(reduced(get_config("qwen3-1.7b")), 1, 1, 8, 2, 0)


def test_cli_runs_the_reduced_model_on_the_cpu(capsys):
    tserve.main(["--requests", "2", "--seq", "16", "--device", "cpu"])
    out = capsys.readouterr().out
    assert "served 8 sequences" in out and "exit label counts" in out


@pytest.mark.parametrize("family", ["ssm", "hybrid", "encdec", "moe",
                                    "vlm"])
def test_engine_refuses_other_families(weights, family, capsys):
    """The reference's engine takes the decoder-only dense, moe and vlm
    families (serve_engine.py:254): the port refuses ssm, hybrid and encdec
    as it does, and its launcher serves the reduced granite-moe and
    qwen2-vl (the vlm from token ids, as the reference's launcher does)
    equal to the reference's launcher: plan, tokens, counters, records and
    histograms exact; logits in float32 compute at rtol 1e-4 / atol 1e-5
    (the routing decisions then agree)."""
    jcfg, jparams, tcfg, tparams = weights
    if family in ("ssm", "hybrid", "encdec"):
        with pytest.raises(AssertionError):
            JEngine(dataclasses.replace(jcfg, family=family), jparams,
                    jplan_stages(jcfg, [400.0]))
        with pytest.raises(NotImplementedError, match="decoder-only families"):
            TEngine(dataclasses.replace(tcfg, family=family), tparams,
                    plan_stages(tcfg, [400.0]))
        return
    arch = {"moe": "granite-moe-1b-a400m", "vlm": "qwen2-vl-2b"}[family]
    jcfg = dataclasses.replace(jreduced(jget_config(arch)),
                               compute_dtype="float32")
    tcfg = dataclasses.replace(reduced(get_config(arch)),
                               compute_dtype="float32")
    jparams = jbuild_model(jcfg).init(jax.random.PRNGKey(0))
    tparams = bridge.params_from_numpy(jax.tree.map(np.asarray, jparams),
                                       tcfg, device="cpu")
    args = (4, 2, 32, 3, 4)                # requests, batch, seq, execs, burst
    F, jplan, jeng, jtoks = _jax_launcher(jcfg, jparams, *args)
    run = tserve.serve(tcfg, *args, device="cpu", params=tparams)
    np.testing.assert_array_equal(run.F, F)
    assert run.plan.boundaries == jplan.boundaries
    assert run.plan.executors == jplan.executors
    for got, want in zip(run.tokens, jtoks, strict=True):
        np.testing.assert_array_equal(got.numpy(), want)
    _same_stats(run.engine.stats, jeng.stats)
    assert run.engine.stats.completed == 8 * 2
    assert sorted(run.engine.results) == sorted(jeng.results)
    for rid, want in jeng.results.items():
        np.testing.assert_allclose(run.engine.results[rid].numpy(),
                                   np.asarray(want), rtol=1e-4, atol=1e-5)
    tserve.main(["--arch", arch, "--requests", "2", "--seq", "16",
                 "--device", "cpu"])
    out = capsys.readouterr().out
    assert "served 8 sequences" in out and "exit label counts" in out
