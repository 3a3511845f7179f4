"""R001 true negatives: the port's idioms the rule must NOT flag."""
from repro_torch import rng


def split_per_sink(key):
    # one split, one row per sink: rows of k are keys of their own
    k = rng.split(key, 3)
    k1, k2, k3 = k[..., 0, :], k[..., 1, :], k[..., 2, :]
    noise = rng.normal(k1, (4,))
    coin = rng.bernoulli(k2, 0.5, (4,))
    return noise, coin, rng.gumbel(k3, (4,))


def rows_in_place(keys):
    k = rng.split(keys, 2)
    return rng.normal(k[..., 0, :], (2,)), rng.uniform(k[..., 1, :], (2,))


def branch_exclusive(key, flag):
    # one consumption per execution: if/else arms are alternatives
    if flag:
        out = rng.normal(key, (2,))
    else:
        out = rng.uniform(key, (2,))
    return out


def rebind_chain(key):
    # rebinding starts a fresh def: each def is consumed exactly once
    key = rng.fold_in(key, 1)
    return rng.normal(key, (1,))


def closure_single_use(key):
    def body(x):
        return x + rng.normal(key, (1,))
    return body(0.0)
