"""The port's stage planner (``repro_torch.splitcompute.planner`` and the
hybrid ``split_points``) against the JAX package's, on the CPU, for every
configuration both packages run (whisper-medium's encdec family is not
ported): the split points and the layer profile equal, and the φ seed
and the refined plans of ``plan_and_refine`` (boundaries, executors and
costs) equal, with φ within rtol 1e-5 (the φ tests of
tests/test_torch_core.py hold the same).  The costs are float64 numpy on
the same boundaries in both packages, so they are equal, not close.
"""
import dataclasses

import numpy as np
import pytest

pytest.importorskip("torch")

from repro.configs import ARCHS as JARCHS  # noqa: E402
from repro.configs import get_config as jget_config  # noqa: E402
from repro.configs import reduced as jreduced  # noqa: E402
from repro.splitcompute import layer_profile as jlayer_profile  # noqa: E402
from repro.splitcompute import plan_and_refine as jplan_and_refine  # noqa: E402
from repro.splitcompute import plan_stages as jplan_stages  # noqa: E402
from repro.splitcompute import split_points as jsplit_points  # noqa: E402
from repro_torch.configs import ARCHS, get_config, reduced  # noqa: E402
from repro_torch.splitcompute import (layer_profile,  # noqa: E402
                                      plan_and_refine, plan_stages,
                                      split_points)

PORTED = sorted(ARCHS)
assert set(PORTED) == set(JARCHS) - {"whisper-medium"}


def _pair(arch, full):
    j, t = jget_config(arch), get_config(arch)
    return (j, t) if full else (jreduced(j), reduced(t))


@pytest.mark.parametrize("full", [True, False])
@pytest.mark.parametrize("arch", PORTED)
def test_split_points_and_profile_match_reference(arch, full):
    j, t = _pair(arch, full)
    assert split_points(t) == jsplit_points(j)
    for seq, batch in ((128, 4), (512, 1)):
        for got, want in zip(layer_profile(t, seq, batch),
                             jlayer_profile(j, seq, batch), strict=True):
            np.testing.assert_array_equal(got, want)


def test_hybrid_splits_between_superblocks():
    cfg = get_config("recurrentgemma-9b")
    pts = split_points(cfg)
    assert pts == list(range(3, 36, 3))   # 12 superblocks, a tail of 2
    plan = plan_stages(cfg, [400.0, 300.0, 500.0, 350.0])
    assert all(b % 3 == 0 for b in plan.boundaries[:-1])
    assert plan.boundaries[-1] == 38


def _same_plan(got, want):
    assert got.boundaries == want.boundaries
    assert got.executors == want.executors
    np.testing.assert_allclose(got.phi, want.phi, rtol=1e-5)


def _capabilities():
    rng = np.random.default_rng(0)
    return [np.maximum(rng.normal(400, 100, n), 50.0) for n in (2, 4, 6)]


@pytest.mark.parametrize("objective", ["throughput", "latency"])
@pytest.mark.parametrize("arch", PORTED)
def test_plan_and_refine_matches_reference(arch, objective):
    j, t = _pair(arch, True)
    for i, F in enumerate(_capabilities()):
        n = len(F)
        bw = None if i == 0 else np.random.default_rng(i).uniform(
            2e8, 2e9, (n, n))
        got = plan_and_refine(t, F, bw, objective=objective)
        want = jplan_and_refine(j, F, bw, objective=objective)
        for g, w in ((got[0], want[0]), (got[2], want[2])):
            _same_plan(g, w)
        for g, w in ((got[1], want[1]), (got[3], want[3])):
            assert dataclasses.asdict(g) == dataclasses.asdict(w)
        # the refinement never makes the objective worse
        if objective == "throughput":
            assert got[3].throughput_rps >= got[1].throughput_rps
        else:
            assert got[3].latency_s <= got[1].latency_s


@pytest.mark.parametrize("arch", ["recurrentgemma-9b", "granite-moe-1b-a400m",
                                  "qwen2-vl-2b"])
def test_plan_stages_of_new_families_matches_reference(arch):
    for full in (True, False):
        j, t = _pair(arch, full)
        for F in _capabilities():
            _same_plan(plan_stages(t, F), jplan_stages(j, F))
