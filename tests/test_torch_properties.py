"""The five hypothesis properties of tests/test_properties.py on the port,
with the reference's ``settings``: chunked attention is invariant to the
chunk size, M-RoPE with equal streams is RoPE, the simulator conserves
tasks under any strategy, spec sanitization keeps an entry iff its axis
divides the dimension, and a higher congestion never runs more layers.
Inputs are drawn with numpy from the example's seed; each property also
holds the port against the reference where the reference computes the
same function."""
import dataclasses

import hypothesis.strategies as st
import numpy as np
import pytest
from hypothesis import given, settings

torch = pytest.importorskip("torch")
import jax.numpy as jnp  # noqa: E402

from repro.core import exit_boundary_layers as j_layers  # noqa: E402
from repro.core import exit_label as j_label  # noqa: E402
from repro_torch import rng  # noqa: E402
from repro_torch.configs import SwarmConfig  # noqa: E402
from repro_torch.core import exit_boundary_layers, exit_label  # noqa: E402
from repro_torch.kernels import ref  # noqa: E402
from repro_torch.launch.mesh import P, AbstractMesh, sanitize_spec  # noqa: E402
from repro_torch.models.attention import chunked_attention  # noqa: E402
from repro_torch.models.common import apply_rope, rope_angles  # noqa: E402
from repro_torch.swarm import make_profile, run_sim  # noqa: E402

torch.set_num_threads(1)


def _normal(g, shape):
    return torch.from_numpy(g.standard_normal(shape).astype(np.float32))


# ---------------------------------------------------------------------------
# attention: chunked == unchunked, any chunk size
# ---------------------------------------------------------------------------


@settings(max_examples=20, deadline=None)
@given(chunk=st.sampled_from([1, 2, 4, 8, 16, 32, 64]),
       causal=st.booleans(), window=st.sampled_from([0, 8]))
def test_chunked_attention_invariant_to_chunk_size(chunk, causal, window):
    B, S, Hq, Hkv, hd = 2, 32, 4, 2, 16
    g = np.random.default_rng(0)
    q = _normal(g, (B, S, Hq, hd))
    k = _normal(g, (B, S, Hkv, hd))
    v = _normal(g, (B, S, Hkv, hd))
    pos = torch.arange(S)[None].expand(B, S)
    got = chunked_attention(q, k, v, q_positions=pos, k_positions=pos,
                            causal=causal, window=window, chunk=chunk)
    want = ref.flash_attention(q, k, v, causal=causal, window=window)
    np.testing.assert_allclose(got.numpy(), want.numpy(), rtol=3e-5,
                               atol=3e-5)


# ---------------------------------------------------------------------------
# M-RoPE degenerates to RoPE when all position streams agree
# ---------------------------------------------------------------------------


@settings(max_examples=15, deadline=None)
@given(seed=st.integers(0, 1000))
def test_mrope_with_equal_streams_equals_rope(seed):
    B, S, hd = 2, 8, 16
    g = np.random.default_rng(seed)
    x = _normal(g, (B, S, 3, hd))
    pos = torch.from_numpy(g.integers(0, 100, (B, S)))
    c1, s1 = rope_angles(pos, hd, 10_000.0)
    pos3 = pos[None].expand(3, B, S)
    c2, s2 = rope_angles(pos3, hd, 10_000.0, sections=(4, 2, 2))
    np.testing.assert_allclose(apply_rope(x, c1, s1).numpy(),
                               apply_rope(x, c2, s2).numpy(),
                               rtol=1e-5, atol=1e-5)


# ---------------------------------------------------------------------------
# simulator queue conservation under random strategies/params
# ---------------------------------------------------------------------------


@settings(max_examples=6, deadline=None)
@given(strategy=st.integers(0, 4), seed=st.integers(0, 100),
       workers=st.integers(5, 12))
def test_simulator_conservation_property(strategy, seed, workers):
    cfg = dataclasses.replace(SwarmConfig(), sim_time_s=5.0,
                              num_workers=workers)
    m = {k: float(v[0]) for k, v in run_sim(
        rng.PRNGKey(seed)[None], cfg, strategy, workers).items()}
    gen, done, drop = m["generated"], m["completed"], m["dropped"]
    rem_tasks = m["remaining_gflops"] / make_profile(cfg).total_gflops
    assert done + drop <= gen + 1e-3
    assert gen - done - drop <= rem_tasks + workers + 1
    assert m["energy_total_j"] >= 0
    assert 0 <= m["jain_fairness"] <= 1 + 1e-6


# ---------------------------------------------------------------------------
# spec sanitization is idempotent and divisibility-correct
# ---------------------------------------------------------------------------


@settings(max_examples=30, deadline=None)
@given(dim=st.integers(1, 4096))
def test_sanitize_spec_divisibility(dim):
    # an entry survives iff dim % axis_size == 0 for a 16-way axis, and a
    # second pass changes nothing
    mesh = AbstractMesh((2, 16), ("data", "model"))
    spec = sanitize_spec(P("model", None), (dim, 3), mesh)
    assert (spec[0] == "model") == (dim % 16 == 0)
    assert spec[1] is None
    assert sanitize_spec(spec, (dim, 3), mesh) == spec


# ---------------------------------------------------------------------------
# early-exit monotonicity: higher congestion never runs MORE layers
# ---------------------------------------------------------------------------


@settings(max_examples=30, deadline=None)
@given(d1=st.floats(-5, 10), d2=st.floats(-5, 10))
def test_exit_layers_monotone_in_congestion(d1, d2):
    lo, hi = sorted((d1, d2))
    D = np.asarray([lo, hi], np.float32)
    la = exit_label(torch.from_numpy(D), 1.5, 2.5)
    layers = exit_boundary_layers(la, (15, 30, 60), 3)
    assert int(layers[1]) <= int(layers[0])
    want = j_layers(j_label(jnp.asarray(D), 1.5, 2.5), (15, 30, 60), 3)
    np.testing.assert_array_equal(layers.numpy(), np.asarray(want))
