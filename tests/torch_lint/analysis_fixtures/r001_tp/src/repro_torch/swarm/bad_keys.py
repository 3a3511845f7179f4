"""R001 true positives: one key feeds two independent sinks."""
from repro_torch import rng


def sample_pair(key):
    noise = rng.normal(key, (4,))
    coin = rng.bernoulli(key, 0.5, (4,))    # same key, second sink
    return noise, coin


def split_then_reuse(key):
    k = rng.split(key)
    k1, k2 = k[..., 0, :], k[..., 1, :]
    a = rng.normal(k1, (1,))
    b = rng.uniform(k1, (1,))               # k1 consumed twice
    return a + b + rng.normal(k2, (1,))


def row_reuse(keys):
    k = rng.split(keys, 2)
    a = rng.normal(k[..., 0, :], (1,))
    b = rng.uniform(k[..., 0, :], (1,))     # the same row, twice
    return a + b + rng.normal(k[..., 1, :], (1,))
