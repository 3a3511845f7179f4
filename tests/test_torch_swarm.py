"""repro_torch.swarm stage by stage against repro.swarm, from the same
(bridged) inputs.

Tolerances, from what this machine measures between XLA's and ATen's CPU
float32 math (log10 differs on a third of inputs by up to 2 ulp, log2 on
37 % by 1 ulp, sin on 3 %, sqrt on 0.6 %; ATen's vectorised sqrt is the
one not correctly rounded):

* positions, distances, pathloss, SNR, capacity and d_tx: within 4 ulp of
  the stage's scale.  An SNR inherits the ulps of the pathloss it is
  computed from, so its scale is that of the pathloss.  A capacity
  B·log2(1 + p) is computed by both as log(1 + p)·(1/ln 2), and XLA's log
  is accurate to a fraction of an ulp of 1 near 1, not relative to a small
  result (measured: up to 92 ulp of log2(1 + p) where p ~ 0.01), so its
  scale is max(C, B).  A capacity computed from positions through the
  whole chain compounds these (the SNR's cancellation turns pathloss ulps
  into larger relative SNR errors) and is held at rtol 1e-5;
* adjacency, neighbour lists, queue contents, transfer state and every
  counter: exact, except where an input lies within those ulps of a
  threshold; such entries are detected and named in the failure message.
"""
import dataclasses
import functools

import numpy as np
import pytest

torch = pytest.importorskip("torch")
import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from repro.configs.base import SwarmConfig as JCfg  # noqa: E402
from repro.swarm import channel as jch  # noqa: E402
from repro.swarm import neighbors as jnb  # noqa: E402
from repro.swarm import queues as jq  # noqa: E402
from repro.swarm import scenario as jsc  # noqa: E402
from repro.swarm import tasks as jtasks  # noqa: E402
from repro.swarm import transfer as jtr  # noqa: E402
from repro_torch.bridge import key_from_numpy  # noqa: E402
from repro_torch.configs import SwarmConfig as TCfg  # noqa: E402
from repro_torch.swarm import channel as tch  # noqa: E402
from repro_torch.swarm import neighbors as tnb  # noqa: E402
from repro_torch.swarm import queues as tq  # noqa: E402
from repro_torch.swarm import scenario as tsc  # noqa: E402
from repro_torch.swarm import tasks as ttasks  # noqa: E402
from repro_torch.swarm import transfer as ttr  # noqa: E402

torch.set_num_threads(1)
ULPS = 4
CHAIN_RTOL = 1e-5     # capacities from positions: the stages' ulps compound
R = 2


def _cfgs(**kw):
    j = dataclasses.replace(JCfg(), **kw)
    return j, TCfg(**dataclasses.asdict(j))


def _keys(seed):
    kj = jax.random.split(jax.random.PRNGKey(seed), R)
    return kj, key_from_numpy(np.asarray(kj))


def _np(x):
    return x.numpy() if torch.is_tensor(x) else np.asarray(x)


def assert_ulps(got, want, scale=None, what=""):
    got, want = _np(got).astype(np.float64), _np(want).astype(np.float64)
    scale = np.maximum(np.abs(want), np.abs(got)) if scale is None else \
        np.abs(_np(scale)).astype(np.float64)
    ulp = np.spacing(scale.astype(np.float32)).astype(np.float64)
    err = np.abs(got - want) / ulp
    assert err.max() <= ULPS, f"{what}: {err.max():.1f} ulp at " \
        f"{np.unravel_index(err.argmax(), err.shape)}"


def _cap_scale(cap, cfg):
    return np.maximum(np.abs(np.asarray(cap)), cfg.bandwidth_hz)


def assert_exact_off_threshold(got, want, margin, what):
    """Boolean/integer outputs equal, except where ``margin`` (the stage's
    input measured from its threshold, in ulp) is within ULPS."""
    got, want = _np(got), _np(want)
    diff = got != want
    near = _np(margin) <= ULPS
    bad = diff & ~near
    assert not bad.any(), f"{what}: {bad.sum()} mismatches off threshold"
    if diff.any():
        pytest.fail(f"{what}: {diff.sum()} entries sit within {ULPS} ulp of "
                    f"the threshold at {np.argwhere(diff)[:5].tolist()}; "
                    f"choose another seed for an exact comparison")


# ---------------------------------------------------------------------------
# tasks, mobility, scenario
# ---------------------------------------------------------------------------


def test_profile_and_boundaries_exact():
    jc, tc = _cfgs()
    jp, tp = jtasks.make_profile(jc), ttasks.make_profile(tc)
    for f in ("gflops", "cum_gflops", "act_bits"):
        np.testing.assert_array_equal(getattr(tp, f).numpy(),
                                      np.asarray(getattr(jp, f)))
    assert tp.bits_per_gflop == jp.bits_per_gflop
    cum = np.random.default_rng(0).uniform(0, 12, (R, 30)).astype(np.float32)
    cum[0, :3] = np.asarray(jp.cum_gflops)[[0, 7, 60]]      # on boundaries
    t = torch.from_numpy(cum)
    np.testing.assert_array_equal(ttasks.snap_to_boundary(tp, t).numpy(),
                                  np.asarray(jtasks.snap_to_boundary(jp, cum)))
    np.testing.assert_array_equal(ttasks.boundary_bits(tp, t).numpy(),
                                  np.asarray(jtasks.boundary_bits(jp, cum)))


MOBILITY = ("circular", "random_waypoint", "gauss_markov", "levy_flight")


@pytest.mark.parametrize("model", MOBILITY)
def test_mobility_init_and_steps(model):
    jc, tc = _cfgs(mobility_model=model)
    n = 25
    kj, kt = _keys(3)
    jm, tm = jsc.get_mobility(jc), tsc.get_mobility(tc)
    js = jax.jit(jax.vmap(lambda k: jm.init(k, jc, n)))(kj)
    ts = tm.init(kt, tc, n)
    for name in js:
        assert_ulps(ts[name], js[name], what=f"{model} init {name}")
        if model != "gauss_markov":      # cos/sin-free inits are exact
            np.testing.assert_array_equal(ts[name].numpy(),
                                          np.asarray(js[name]))
    for epoch in (0, 1, 7):
        t0 = float(np.float32(epoch) * np.float32(jc.decision_period_s))
        ks = jax.vmap(lambda k: jax.random.fold_in(k, epoch))(kj)
        jstep = jax.jit(jax.vmap(lambda s, k, t0=t0: jm.step(
            s, k, jc, jnp.float32(t0))))
        js2, jpos = jstep(js, ks)
        ts2, tpos = tm.step(ts, key_from_numpy(np.asarray(ks)), tc, t0)
        scale = np.maximum(np.abs(np.asarray(jpos)), jc.area_m / 16)
        assert_ulps(tpos, jpos, scale, what=f"{model} pos @ {epoch}")
        # carry the reference's state, so each step starts from equal input
        js, ts = js2, {k: torch.from_numpy(np.asarray(v).copy())
                       for k, v in js2.items()}


def test_burst_arrivals_and_fault_chain_exact():
    jc, tc = _cfgs(fault_model="markov")
    n = 40
    kj, kt = _keys(5)
    g = np.random.default_rng(1)
    on = g.uniform(size=(R, n)) < 0.3
    won, warr = jax.vmap(lambda b, k: jsc.burst_arrivals(b, k, jc))(on, kj)
    ton, tarr = tsc.burst_arrivals(torch.from_numpy(on),
                                   tsc.burst_draws(kt, n), tc)
    np.testing.assert_array_equal(ton.numpy(), np.asarray(won))
    np.testing.assert_array_equal(tarr.numpy(), np.asarray(warr))
    jf, tf = jsc.get_fault(jc), tsc.get_fault(tc)
    ja = jax.vmap(lambda k: jf.init(k, jc, n))(kj)
    ta = tf.init(kt, tc, n)
    np.testing.assert_array_equal(ta.numpy(), np.asarray(ja))
    ja2 = jax.vmap(lambda a, k: jf.step(a, k, jc))(ja, kj)
    np.testing.assert_array_equal(tf.step(ta, kt, tc).numpy(),
                                  np.asarray(ja2))
    adj = g.uniform(size=(R, n, n)) < 0.5
    np.testing.assert_array_equal(
        tsc.mask_adjacency(torch.from_numpy(adj), ta).numpy(),
        np.asarray(jax.vmap(jsc.mask_adjacency)(adj, ja2 * 0 + ja)))


def test_unported_models_raise():
    """Every channel of the reference is registered now (none is left
    unported); ``log_normal_corr`` has no per-edge form, in the reference
    either, and unknown names raise ``KeyError``."""
    assert tsc.NOT_PORTED == {}
    assert sorted(tsc.CHANNEL_MODELS) == sorted(jsc.CHANNEL_MODELS) == [
        "free_space", "log_normal", "log_normal_corr", "nakagami",
        "rician", "two_ray"]
    assert sorted(tsc.CHANNEL_EDGE_MODELS) == sorted(jsc.CHANNEL_EDGE_MODELS)
    for name in tsc.CHANNEL_MODELS:
        _, tc = _cfgs(channel_model=name)
        assert tsc.get_channel(tc) is tsc.CHANNEL_MODELS[name]
    _, tc = _cfgs(neighbor_mode="sparse", channel_model="nakagami")
    assert tsc.get_channel_edges(tc) is tch.nakagami_edges
    _, tc = _cfgs(neighbor_mode="sparse", channel_model="log_normal_corr")
    with pytest.raises(KeyError, match="log_normal_corr"):
        tsc.get_channel_edges(tc)
    _, tc = _cfgs(channel_model="teleport")
    with pytest.raises(KeyError):
        tsc.get_channel(tc)
    _, tc = _cfgs(mobility_model="teleport")
    with pytest.raises(KeyError):
        tsc.get_mobility(tc)


# ---------------------------------------------------------------------------
# channel
# ---------------------------------------------------------------------------

CHANNELS = [dict(), dict(altitude_m=10.0), dict(channel_model="free_space"),
            dict(channel_model="log_normal"), dict(channel_model="rician")]


def _positions(n, seed, area=20_000.0):
    g = np.random.default_rng(seed)
    return g.uniform(0, area, (R, n, 2)).astype(np.float32)


@pytest.mark.parametrize("kw", CHANNELS, ids=lambda kw: "-".join(
    f"{k}={v}" for k, v in kw.items()) or "default")
def test_channel_stages_from_equal_inputs(kw):
    jc, tc = _cfgs(**kw)
    n = 24
    pos = _positions(n, 11)
    kj, kt = _keys(7)
    tpos = torch.from_numpy(pos)
    dist_j = np.asarray(jax.jit(jax.vmap(jch.pairwise_distance))(pos))
    assert_ulps(tch.pairwise_distance(tpos), dist_j, what="distance")
    jfn, tfn = jsc.get_channel(jc), tsc.get_channel(tc)
    pl_j = np.asarray(jax.jit(jax.vmap(lambda k, d: jfn(k, d, jc)))(
        kj, dist_j))
    pl_t = tfn(kt, torch.from_numpy(dist_j), tc)
    if "channel_model" in kw and kw["channel_model"] != "free_space":
        # the shadowing/fading draws go through normal(): 2-ulp draws,
        # scaled by sigma and 10·log10 of the fading gain
        np.testing.assert_allclose(pl_t.numpy(), pl_j, rtol=2e-6, atol=1e-4)
    else:
        assert_ulps(pl_t, pl_j, what="pathloss")
    snr_j = np.asarray(jch.snr_from_pathloss_db(pl_j, jc))
    assert_ulps(tch.snr_from_pathloss_db(torch.from_numpy(pl_j), tc), snr_j,
                scale=pl_j, what="snr")
    cap_j = np.asarray(jch.capacity_bps(snr_j, jc))
    assert_ulps(tch.capacity_bps(torch.from_numpy(snr_j), tc), cap_j,
                scale=_cap_scale(cap_j, jc), what="capacity")
    # whole link state from equal positions: adjacency exact off threshold
    adj_j, lcap_j = jax.jit(jax.vmap(lambda p, k: jch.link_state(
        p, jc, key=k, pathloss_fn=jfn)))(pos, kj)
    adj_t, lcap_t = tch.link_state(tpos, tc, key=kt, pathloss_fn=tfn)
    margin = np.abs(snr_j - jc.snr_min_db) / np.spacing(
        np.abs(pl_j).astype(np.float32))
    assert_exact_off_threshold(adj_t, adj_j, margin, "adjacency")
    on = np.asarray(adj_j)
    bpg = ttasks.make_profile(tc).bits_per_gflop
    from repro_torch.core.fp import div
    dtx_t = div(bpg, torch.from_numpy(np.asarray(lcap_j)))
    dtx_j = bpg / np.asarray(lcap_j)
    assert_ulps(dtx_t.numpy()[on], np.asarray(jnp.float32(bpg)
                                              / lcap_j)[on], what="d_tx")
    assert np.isfinite(dtx_j).all()
    np.testing.assert_allclose(lcap_t.numpy()[on], np.asarray(lcap_j)[on],
                               rtol=CHAIN_RTOL)


@pytest.mark.parametrize("n,k,seed", [(12, 11, 0), (64, 8, 1), (300, 16, 2)])
def test_neighbor_lists_and_sparse_links(n, k, seed):
    jc, tc = _cfgs(neighbor_mode="sparse", neighbor_k=k, altitude_m=10.0)
    pos = _positions(n, seed)
    tpos = torch.from_numpy(pos)
    nbr_j, valid_j = jax.jit(jax.vmap(lambda p: jnb.neighbor_lists(p, jc)))(pos)
    nbr_t, valid_t = tnb.neighbor_lists(tpos, tc)
    assert nbr_t.dtype == torch.int32
    np.testing.assert_array_equal(nbr_t.numpy(), np.asarray(nbr_j))
    np.testing.assert_array_equal(valid_t.numpy(), np.asarray(valid_j))
    alive = np.random.default_rng(seed).uniform(size=(R, n)) < 0.9
    vm_j = jax.jit(jax.vmap(jnb.mask_neighbors))(valid_j, nbr_j, alive)
    vm_t = tnb.mask_neighbors(valid_t, nbr_t, torch.from_numpy(alive))
    np.testing.assert_array_equal(vm_t.numpy(), np.asarray(vm_j))
    adj_j, cap_j = jax.jit(jax.vmap(lambda p, nb, v: jch.link_state_sparse(
        p, nb, v, jc)))(pos, nbr_j, vm_j)
    adj_t, cap_t = tch.link_state_sparse(tpos, nbr_t, vm_t, tc)
    np.testing.assert_array_equal(adj_t.numpy(), np.asarray(adj_j))
    on = np.asarray(adj_j)
    np.testing.assert_allclose(cap_t.numpy()[on], np.asarray(cap_j)[on],
                               rtol=CHAIN_RTOL)
    dst = np.asarray(nbr_j)[:, :, 0]
    rate_j = jax.jit(jax.vmap(lambda p, d: jch.edge_rate(p, d, jc)))(pos, dst)
    rate_t = tch.edge_rate(tpos, torch.from_numpy(dst), tc)
    np.testing.assert_allclose(rate_t.numpy(), np.asarray(rate_j),
                               rtol=CHAIN_RTOL)


@pytest.mark.parametrize("model", ["log_normal", "rician"])
def test_stochastic_edge_channels(model):
    jc, tc = _cfgs(neighbor_mode="sparse", channel_model=model)
    n, k = 30, 6
    g = np.random.default_rng(4)
    src = np.broadcast_to(np.arange(n)[:, None], (R, n, k)).astype(np.int32)
    dst = g.integers(0, n, (R, n, k)).astype(np.int32)
    dist = g.uniform(10, 20000, (R, n, k)).astype(np.float32)
    kj, kt = _keys(9)
    want = jax.jit(jax.vmap(lambda kk, d, s, t: jsc.get_channel_edges(jc)(
        kk, d, s, t, jc)))(kj, dist, src, dst)
    got = tsc.get_channel_edges(tc)(kt, *(torch.from_numpy(a) for a in
                                          (dist, src, dst)), tc)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=2e-6,
                               atol=1e-4)


# ---------------------------------------------------------------------------
# queues and transfers, from a synthetic mid-run state
# ---------------------------------------------------------------------------


def _queue_state(n=10, Q=8, seed=0):
    g = np.random.default_rng(seed)
    act = g.uniform(size=(R, n, Q)) < 0.5
    act[0, 0] = True                                   # a full queue
    act[0, 1] = False                                  # an empty one
    seq = np.stack([g.permutation(n * Q).reshape(n, Q) for _ in range(R)])
    dst = (np.arange(n) + g.integers(1, n, (R, n))) % n
    return {
        "F": g.uniform(100, 500, (R, n)).astype(np.float32),
        "q_active": act,
        "q_cum": g.uniform(0, 12, (R, n, Q)).astype(np.float32),
        "q_created": g.uniform(0, 5, (R, n, Q)).astype(np.float32),
        "q_seq": seq.astype(np.int32),
        "q_visited": g.uniform(size=(R, n, Q, n)) < 0.2,
        "seq_counter": np.full((R,), n * Q, np.int32),
        "drop_count": np.zeros((R,), np.int32),
        "tx_active": g.uniform(size=(R, n)) < 0.6,
        "tx_dst": dst.astype(np.int32),
        "tx_bits": g.uniform(-2e5, 6e5, (R, n)).astype(np.float32),
        "tx_cum": g.uniform(0, 12, (R, n)).astype(np.float32),
        "tx_created": g.uniform(0, 5, (R, n)).astype(np.float32),
        "tx_visited": g.uniform(size=(R, n, n)) < 0.2,
        "tx_start": g.uniform(0, 5, (R, n)).astype(np.float32),
        "tx_count": np.zeros((R,), np.int32),
        "tx_delivered": np.zeros((R,), np.int32),
        "tx_time_sum": np.zeros((R,), np.float32),
        "e_tx": g.uniform(0, 3, (R, n)).astype(np.float32),
    }


def _torch_state(st):
    return {k: torch.from_numpy(v.copy()) for k, v in st.items()}


def _compare_state(got, want, what):
    for k, w in want.items():
        w = np.asarray(w)
        g = got[k].numpy()
        assert g.dtype == w.dtype, f"{what}: {k} dtype {g.dtype} != {w.dtype}"
        if w.dtype.kind == "f":
            assert_ulps(g, w, scale=np.maximum(np.abs(w), 1.0),
                        what=f"{what}: {k}")
        else:
            np.testing.assert_array_equal(g, w, err_msg=f"{what}: {k}")


def test_queue_ops_exact():
    st = _queue_state()
    jc, tc = _cfgs()
    jp, tp = jtasks.make_profile(jc), ttasks.make_profile(tc)
    jhead, jhas = jax.jit(jax.vmap(jq.head_slot))(st)
    thead, thas = tq.head_slot(_torch_state(st))
    np.testing.assert_array_equal(thead.numpy(), np.asarray(jhead))
    np.testing.assert_array_equal(thas.numpy(), np.asarray(jhas))
    assert_ulps(tq.queued_gflops(_torch_state(st), tp),
                jax.jit(jax.vmap(lambda s: jq.queued_gflops(s, jp)))(st),
                what="queued_gflops")
    g = np.random.default_rng(3)
    mask = g.uniform(size=(R, 10)) < 0.7
    cum = g.uniform(0, 5, (R, 10)).astype(np.float32)
    created = np.full((R, 10), 1.25, np.float32)
    visited = g.uniform(size=(R, 10, 10)) < 0.3
    want = jax.jit(jax.vmap(jq.push))(st, mask, cum, created, visited)
    got = tq.push(_torch_state(st), *(torch.from_numpy(a) for a in
                                      (mask, cum, created, visited)))
    _compare_state(got, want, "push")
    want = jax.jit(jax.vmap(jq.pop_head))(st, mask)
    got = tq.pop_head(_torch_state(st), torch.from_numpy(mask))
    _compare_state(got, want, "pop_head")


@pytest.mark.parametrize("sparse", [False, True], ids=["dense", "sparse"])
def test_transfer_initiate_and_progress(sparse):
    jc, tc = _cfgs()
    jp, tp = jtasks.make_profile(jc), ttasks.make_profile(tc)
    st = _queue_state(seed=5)
    g = np.random.default_rng(6)
    elig = (g.uniform(size=(R, 10)) < 0.5) & ~st["tx_active"] \
        & st["q_active"].any(-1)
    tgt = st["tx_dst"][:, ::-1].copy()
    want = jax.jit(jax.vmap(lambda s, e, t: jtr.initiate(
        s, e, t, jnp.float32(2.4), jp)))(st, elig, tgt)
    got = ttr.initiate(_torch_state(st), torch.from_numpy(elig),
                       torch.from_numpy(tgt), 2.4, tp)
    _compare_state(got, want, "initiate")
    st = {k: np.asarray(v) for k, v in want.items()}
    cap = g.uniform(1e6, 8e7, (R, 10) if sparse else (R, 10, 10)).astype(
        np.float32)
    alive = g.uniform(size=(R, 10)) < 0.9
    for tick in range(3):
        t_now = float(np.float32(2.4 + 0.01 * (tick + 1)))
        prog = functools.partial(jtr.progress, cfg=jc,
                                 t_now=jnp.float32(t_now))
        want = jax.vmap(lambda s, c, a, f=prog: f(s, c, a))(st, cap, alive)
        got = ttr.progress(_torch_state(st), torch.from_numpy(cap),
                           torch.from_numpy(alive), tc, t_now)
        _compare_state(got, want, f"progress tick {tick}")
        st = {k: np.asarray(v) for k, v in want.items()}
