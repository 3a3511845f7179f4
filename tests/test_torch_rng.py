"""repro_torch.rng against live jax.random (threefry2x32, partitionable).

Tolerances: PRNGKey, split, fold_in, bits, uniform, randint and bernoulli
are exact (integer hashing, then exactly rounded float arithmetic).
normal and gumbel agree within 2 float32 ulp at scale max(|x|, 1): they go
through log1p/sqrt/log, whose last bit differs between XLA's and ATen's CPU
implementations (measured here: normal differs from jax on ~1% of draws).
"""
import numpy as np
import pytest

torch = pytest.importorskip("torch")
import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from repro_torch import rng  # noqa: E402
from repro_torch.bridge import key_from_numpy  # noqa: E402

torch.set_num_threads(1)

SEEDS = (0, 1, 42, 2 ** 31 - 1)
SHAPES = ((1,), (3,), (7, 5), (30, 30), (2, 3, 5))
EPS = float(np.finfo(np.float32).eps)


def _pair(seed):
    return jax.random.PRNGKey(seed), rng.PRNGKey(seed)


@pytest.mark.parametrize("seed", SEEDS)
def test_keys_split_fold_in_exact(seed):
    kj, kt = _pair(seed)
    np.testing.assert_array_equal(kt.numpy(), np.asarray(kj))
    for num in (2, 3, 7, 50):
        np.testing.assert_array_equal(rng.split(kt, num).numpy(),
                                      np.asarray(jax.random.split(kj, num)))
    for d in (0, 1, 11, 13, 17, 123457):
        np.testing.assert_array_equal(rng.fold_in(kt, d).numpy(),
                                      np.asarray(jax.random.fold_in(kj, d)))


def test_batched_keys_match_vmap():
    kj = jax.random.split(jax.random.PRNGKey(3), 4)
    kt = key_from_numpy(np.asarray(kj))
    want = jax.vmap(lambda k: jax.vmap(
        lambda i: jax.random.fold_in(k, i))(jnp.arange(20)))(kj)
    np.testing.assert_array_equal(rng.fold_in(kt, torch.arange(20)).numpy(),
                                  np.asarray(want))
    want = jax.vmap(lambda k: jax.random.uniform(k, (5,)))(kj)
    np.testing.assert_array_equal(rng.uniform(kt, (5,)).numpy(),
                                  np.asarray(want))
    lo = torch.tensor([[0, 3], [5, 5], [1, 2], [9, 0]], dtype=torch.int32)
    hi = torch.tensor([[7, 1], [2, 8], [6, 6], [4, 9]], dtype=torch.int32)
    want = jax.vmap(lambda k, a, b: jax.vmap(
        lambda x, y: jax.random.fold_in(jax.random.fold_in(k, x), y))(a, b))(
        kj, jnp.asarray(lo.numpy()), jnp.asarray(hi.numpy()))
    got = rng.fold_in_each(rng.fold_in_each(kt[:, None].expand(4, 2, 2), lo),
                           hi)
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))


@pytest.mark.parametrize("shape", SHAPES)
@pytest.mark.parametrize("seed", SEEDS)
def test_bits_uniform_randint_bernoulli_exact(seed, shape):
    kj, kt = _pair(seed)
    np.testing.assert_array_equal(
        rng.random_bits(kt, shape).numpy(),
        np.asarray(jax.random.bits(kj, shape)).astype(np.int64))
    for lo, hi in ((0.0, 1.0), (0.25, 0.75), (0.0, 2 * np.pi),
                   (float(np.finfo(np.float32).tiny), 1.0), (25.0, 100.0)):
        np.testing.assert_array_equal(
            rng.uniform(kt, shape, lo, hi).numpy(),
            np.asarray(jax.random.uniform(kj, shape, jnp.float32, lo, hi)))
    for lo, hi in ((0, 15), (0, 2), (-5, 100_000), (3, 3)):
        got = rng.randint(kt, shape, lo, hi)
        assert got.dtype == torch.int32
        np.testing.assert_array_equal(
            got.numpy(), np.asarray(jax.random.randint(kj, shape, lo, hi)))
    for p in (0.05, 0.2, 0.5):
        np.testing.assert_array_equal(
            rng.bernoulli(kt, p, shape).numpy(),
            np.asarray(jax.random.bernoulli(kj, p, shape)))


@pytest.mark.parametrize("name", ["normal", "gumbel"])
def test_normal_gumbel_within_2ulp(name):
    shape = (200_001,)                   # odd count on purpose
    kj, kt = _pair(7)
    want = np.asarray(getattr(jax.random, name)(kj, shape, jnp.float32))
    got = getattr(rng, name)(kt, shape).numpy()
    assert got.dtype == np.float32
    err = np.abs(got.astype(np.float64) - want) / np.maximum(np.abs(want), 1)
    assert err.max() <= 2 * EPS, f"{name}: {err.max() / EPS:.2f} ulp"


def test_prngkey_rejects_out_of_range_seed():
    with pytest.raises(ValueError):
        rng.PRNGKey(-1)
    with pytest.raises(ValueError):
        rng.PRNGKey(2 ** 31)
