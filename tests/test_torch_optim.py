"""The port's optimizer, data pipeline, gradient compression, checkpoints
and restart driver (``repro_torch.optim``, ``.data``, ``.runtime``,
``.checkpoint``) against the JAX package's, on the CPU.

* AdamW, its schedule and the global-norm clip, fed the same seeded
  parameters and gradients for five steps: params, m and v within rtol
  1e-6 (XLA may fuse a multiply-add where the port rounds twice: an ulp a
  step), with an atol of 1e-6 of the leaf's largest entry (with the clip
  active the two norms, summed in other orders, may differ in the last
  bit, and m's entries near zero are sums of cancelling terms); the lr
  within rtol 1e-6 at the warm-up boundary, on the cosine and on its
  floor.
* The synthetic batches equal the reference's exactly, host sharding
  included.
* int8 compression: the int8 values equal the reference's, the residuals
  within 1e-7.
* Checkpoints: a train state round trip is exact; retention keeps the
  newest; a stale ``.tmp`` is ignored and overwritten; a differing tree
  raises as the reference's does.
* The driver: a run killed once and resumed equals the uninterrupted run;
  the straggler counter counts as the reference's.
"""
import os
import tempfile

import numpy as np
import pytest

torch = pytest.importorskip("torch")
import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from repro.data import DataConfig as JDataConfig  # noqa: E402
from repro.data import batch_at as jbatch_at  # noqa: E402
from repro.optim import OptConfig as JOptConfig  # noqa: E402
from repro.optim import apply_updates as japply  # noqa: E402
from repro.optim import clip_by_global_norm as jclip  # noqa: E402
from repro.optim import init_opt as jinit_opt  # noqa: E402
from repro.optim import schedule as jschedule  # noqa: E402
from repro.runtime import StepStats as JStepStats  # noqa: E402
from repro.runtime import compress_grads as jcompress  # noqa: E402
from repro.runtime import init_compression as jinit_comp  # noqa: E402
from repro.runtime import quantize as jquantize  # noqa: E402
from repro_torch.checkpoint import (all_steps, latest_step,  # noqa: E402
                                    restore_into, save)
from repro_torch.configs import get_config, reduced  # noqa: E402
from repro_torch.data import DataConfig, Prefetcher, batch_at  # noqa: E402
from repro_torch.launch.step import init_train_state  # noqa: E402
from repro_torch.models import build_model  # noqa: E402
from repro_torch.optim import (OptConfig, apply_updates,  # noqa: E402
                               clip_by_global_norm, init_opt, schedule)
from repro_torch.runtime import (DriverConfig, FailureInjected,  # noqa: E402
                                 StepStats, compress_grads,
                                 init_compression, quantize,
                                 run_with_restarts)

torch.set_num_threads(1)
SHAPES = {"a": (16, 12), "b": (7,), "c": (3, 5, 4)}


def _tree(seed, scale=1.0):
    g = np.random.default_rng(seed)
    return {k: (g.standard_normal(s) * scale).astype(np.float32)
            for k, s in SHAPES.items()}


def _t(tree):
    return {k: torch.from_numpy(v.copy()) for k, v in tree.items()}


@pytest.mark.parametrize("grad_scale", [0.01, 3.0])   # clip idle / active
@pytest.mark.parametrize("weight_decay", [0.1, 0.0])
def test_adamw_matches_jax_for_five_steps(grad_scale, weight_decay):
    kw = dict(lr=1e-2, warmup_steps=2, total_steps=4, grad_clip=1.0,
              weight_decay=weight_decay)
    jcfg, cfg = JOptConfig(**kw), OptConfig(**kw)
    p0 = _tree(0)
    jp = {k: jnp.asarray(v) for k, v in p0.items()}
    jst = jinit_opt(jp)
    p = _t(p0)
    st = init_opt(p)
    for step in range(5):
        g = _tree(100 + step, grad_scale)
        jp, jst, jm = japply(jp, {k: jnp.asarray(v) for k, v in g.items()},
                             jst, jcfg)
        p, st, m = apply_updates(p, _t(g), st, cfg)
        np.testing.assert_allclose(float(m["lr"]), float(jm["lr"]),
                                   rtol=1e-6)
        np.testing.assert_allclose(float(m["grad_norm"]),
                                   float(jm["grad_norm"]), rtol=1e-6)
        assert int(st.step) == int(jst.step) == step + 1
        for k in SHAPES:
            for got, want in ((p[k], jp[k]), (st.m[k], jst.m[k]),
                              (st.v[k], jst.v[k])):
                want = np.asarray(want)
                np.testing.assert_allclose(
                    got.numpy(), want, rtol=1e-6,
                    atol=1e-6 * float(np.abs(want).max()))


def test_schedule_matches_jax_at_its_boundaries():
    cfg = dict(lr=3e-4, warmup_steps=100, total_steps=1000,
               min_lr_frac=0.1)
    for step in (0, 1, 99, 100, 101, 550, 999, 1000, 1005):
        want = float(jschedule(JOptConfig(**cfg), jnp.int32(step)))
        got = float(schedule(OptConfig(**cfg), step))
        np.testing.assert_allclose(got, want, rtol=1e-6, err_msg=str(step))
    assert float(schedule(OptConfig(**cfg), 1000)) == pytest.approx(3e-5)
    # warmup_steps = 0: full lr from the first step
    assert float(schedule(OptConfig(lr=1.0, warmup_steps=0), 1)) == \
        pytest.approx(float(jschedule(JOptConfig(lr=1.0, warmup_steps=0),
                                      jnp.int32(1))), rel=1e-6)


@pytest.mark.parametrize("max_norm", [0.5, 100.0])
def test_clip_matches_jax(max_norm):
    g = _tree(7)
    jg, jn = jclip({k: jnp.asarray(v) for k, v in g.items()}, max_norm)
    names = list(SHAPES)
    got, gn = clip_by_global_norm([torch.from_numpy(g[k].copy())
                                   for k in names], max_norm)
    np.testing.assert_allclose(float(gn), float(jn), rtol=1e-6)
    for k, t in zip(names, got):
        np.testing.assert_allclose(t.numpy(), np.asarray(jg[k]), rtol=1e-6)


@pytest.mark.parametrize("hosts", [1, 2, 4])
def test_batches_equal_jax(hosts):
    for host in range(hosts):
        kw = dict(vocab_size=1000, seq_len=33, global_batch=8, seed=3,
                  num_hosts=hosts, host_id=host)
        for step in (0, 1, 17):
            got = batch_at(DataConfig(**kw), step, device="cpu")
            want = jbatch_at(JDataConfig(**kw), step)
            for k in ("tokens", "labels"):
                assert got[k].dtype == torch.int32
                np.testing.assert_array_equal(got[k].numpy(),
                                              np.asarray(want[k]))


def test_prefetcher_yields_batch_at():
    cfg = DataConfig(vocab_size=50, seq_len=8, global_batch=2, seed=1)
    pf = Prefetcher(cfg, start_step=5, device="cpu")
    try:
        for want_step in (5, 6, 7):
            step, b = next(pf)
            assert step == want_step
            ref = batch_at(cfg, step, device="cpu")
            assert all(torch.equal(b[k], ref[k]) for k in ref)
    finally:
        pf.close()


def test_compression_matches_jax():
    g = {k: v * 1e-3 for k, v in _tree(11).items()}
    g["b"][3] = 0.5                  # an outlier sets one leaf's scale
    jres = jinit_comp({k: jnp.asarray(v) for k, v in g.items()})
    res = init_compression(_t(g))
    for step in range(3):
        gs = {k: v * (step + 1) for k, v in g.items()}
        jdeq, jres = jcompress({k: jnp.asarray(v) for k, v in gs.items()},
                               jres)
        deq, res = compress_grads(_t(gs), res)
        for k in SHAPES:
            q, s = quantize(_t(gs)[k] + 0)
            jq, js = jquantize(jnp.asarray(gs[k]))
            assert q.dtype == torch.int8
            np.testing.assert_array_equal(q.numpy(), np.asarray(jq))
            np.testing.assert_allclose(float(s), float(js), rtol=1e-7)
            np.testing.assert_allclose(deq[k].numpy(), np.asarray(jdeq[k]),
                                       rtol=1e-7, atol=1e-12)
            np.testing.assert_allclose(res.residual[k].numpy(),
                                       np.asarray(jres.residual[k]),
                                       rtol=0, atol=1e-7)


def _small_state(seed=0):
    model = build_model(reduced(get_config("qwen3-1.7b")))
    return init_train_state(model, torch.Generator().manual_seed(seed),
                            device="cpu")


def test_checkpoint_round_trip_retention_and_atomicity():
    with tempfile.TemporaryDirectory() as d:
        st = _small_state(0)
        with torch.no_grad():
            for t in st.opt.m.values():
                t.normal_()
        st.opt.step.fill_(7)
        for step in (1, 2, 3, 4):
            save(d, step, st, keep=2)
        assert all_steps(d) == [3, 4] and latest_step(d) == 4
        # a crashed writer's leftover is not a checkpoint, and is replaced
        os.makedirs(os.path.join(d, "step_00000009.tmp"))
        assert latest_step(d) == 4
        save(d, 9, st, keep=5)
        assert all_steps(d) == [3, 4, 9]
        fresh = _small_state(1)
        restored, manifest = restore_into(d, fresh)
        assert restored is fresh and manifest["step"] == 9
        assert int(fresh.opt.step) == 7
        for (n, a), (m, b) in zip(st.params.named_parameters(),
                                  fresh.params.named_parameters()):
            assert n == m and torch.equal(a, b)
        for n in st.opt.m:
            assert torch.equal(st.opt.m[n], fresh.opt.m[n])
            assert torch.equal(st.opt.v[n], fresh.opt.v[n])


def test_checkpoint_tree_mismatch_raises():
    with tempfile.TemporaryDirectory() as d:
        save(d, 1, _small_state())
        other = build_model(reduced(get_config("granite-moe-1b-a400m")))
        like = init_train_state(other, torch.Generator().manual_seed(0),
                                device="cpu")
        with pytest.raises(ValueError, match="tree mismatch"):
            restore_into(d, like)


def _toy_run(d, fail_at, steps=10):
    def init_state():
        return {"w": torch.zeros(4), "n": torch.zeros((), dtype=torch.int32)}

    def train_step(state, batch):
        state["w"].mul_(0.9).add_(batch["x"])
        state["n"] += 1
        return state, {"loss": state["w"].sum()}

    def batch_fn(step):
        g = np.random.default_rng(step)
        return {"x": torch.from_numpy(g.standard_normal(4).astype(
            np.float32))}

    return run_with_restarts(
        DriverConfig(ckpt_dir=d, ckpt_every=3, max_steps=steps,
                     fail_at_step=fail_at),
        init_state=init_state, train_step=train_step, batch_fn=batch_fn)


def test_driver_resume_is_identical():
    with tempfile.TemporaryDirectory() as d1, \
            tempfile.TemporaryDirectory() as d2:
        clean = _toy_run(d1, None)
        resumed = _toy_run(d2, 7)
    assert int(clean["n"]) == int(resumed["n"]) == 10
    assert torch.equal(clean["w"], resumed["w"])


def test_driver_without_checkpoints_and_a_failure_raises():
    with pytest.raises(FailureInjected):
        run_with_restarts(
            DriverConfig(ckpt_dir=None, max_steps=5, fail_at_step=2),
            max_restarts=0, init_state=lambda: {},
            train_step=lambda s, b: (s, {}), batch_fn=lambda step: {})


def test_straggler_counter_matches_jax():
    dts = [1.0, 1.1, 0.9, 5.0, 1.0, 4.2, 1.0, 12.0]
    got, want = StepStats(), JStepStats()
    flags = [(got.update(dt, 3.0), want.update(dt, 3.0)) for dt in dts]
    assert all(a == b for a, b in flags)
    assert got.stragglers == want.stragglers == sum(a for a, _ in flags) > 0
    assert got.steps == want.steps == len(dts)
