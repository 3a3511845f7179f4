"""Counter-based port of ``jax.random``'s default PRNG (threefry2x32).

Bit-exact with ``jax.random`` in its partitionable mode
(``jax_threefry_partitionable=True``, the default of the jax the reference
is run with): the same key gives the same bits, so the port can be held
against the reference run for run, not only in distribution.

Keys are ``torch.uint32`` tensors of shape ``[..., 2]``; every leading
dimension is a batch of independent keys (the simulator's run axis), and a
sampler returns ``[..., *shape]``.  torch has no arithmetic on uint32, so
the hash runs on int64 masked to 32 bits and converts back at the edges.

What is exact and what is not:

* ``PRNGKey``, ``split``, ``fold_in``, ``random_bits``, ``uniform``,
  ``randint`` and ``bernoulli`` are integer or exactly-rounded float
  arithmetic: bit-identical to jax on every device.  (jax's uniform scales
  with ``u * (max - min) + min``, which XLA contracts into one fused
  multiply-add; ``core.fp.fma`` rounds the same way.)
* ``normal`` goes through XLA's single-precision ``erf_inv`` polynomial and
  ``gumbel`` through two logarithms, ported op for op; they agree with jax
  to the last few ulp, as the backends' ``log1p``/``sqrt``/``log`` do.
"""
from __future__ import annotations

import math

import numpy as np
import torch

from repro_torch.core.fp import fma

MASK = 0xFFFFFFFF
_ROTATIONS = ((13, 15, 26, 6), (17, 29, 16, 24))
_PARITY = 0x1BD11BDA


def _i64(key: torch.Tensor) -> torch.Tensor:
    return key.to(torch.int64)


def _u32(x: torch.Tensor) -> torch.Tensor:
    return x.to(torch.uint32)


def _rotl(x: torch.Tensor, r: int) -> torch.Tensor:
    return ((x << r) | (x >> (32 - r))) & MASK


def threefry2x32(k1, k2, x1, x2):
    """The Threefry-2x32 block cipher (20 rounds), on int64 tensors holding
    uint32 values; all four operands broadcast.  Returns (y1, y2)."""
    ks = (k1, k2, k1 ^ k2 ^ _PARITY)
    x1 = (x1 + ks[0]) & MASK
    x2 = (x2 + ks[1]) & MASK
    for i in range(5):
        for r in _ROTATIONS[i % 2]:
            x1 = (x1 + x2) & MASK
            x2 = _rotl(x2, r) ^ x1
        x1 = (x1 + ks[(i + 1) % 3]) & MASK
        x2 = (x2 + ks[(i + 2) % 3] + (i + 1)) & MASK
    return x1, x2


def _hash_counts(key: torch.Tensor, shape) -> tuple:
    """threefry over the flat row-major counter of ``shape`` per key: the
    partitionable counter layout (high word 0 below 2**32 elements)."""
    shape = tuple(shape)
    numel = math.prod(shape)
    if numel >= 2 ** 32:
        raise NotImplementedError("random arrays of 2**32 elements or more")
    k = _i64(key)
    pad = (None,) * len(shape)
    k1 = k[..., 0][(..., *pad)]
    k2 = k[..., 1][(..., *pad)]
    lo = torch.arange(numel, dtype=torch.int64, device=key.device)
    return threefry2x32(k1, k2, torch.zeros_like(lo).reshape(shape),
                        lo.reshape(shape))


def PRNGKey(seed: int, device=None) -> torch.Tensor:
    """``jax.random.PRNGKey(seed)`` for a 32-bit seed: ``uint32[2]``."""
    if not 0 <= int(seed) < 2 ** 31:
        raise ValueError(f"seed must be in [0, 2**31), got {seed}")
    return torch.tensor([0, int(seed)], dtype=torch.uint32, device=device)


def split(key: torch.Tensor, num: int = 2) -> torch.Tensor:
    """``jax.random.split``: key [..., 2] -> [..., num, 2]."""
    y1, y2 = _hash_counts(key, (num,))
    return _u32(torch.stack([y1, y2], dim=-1))


def fold_in(key: torch.Tensor, data) -> torch.Tensor:
    """``jax.random.fold_in``.  ``data`` is an int, or an integer tensor
    whose shape is appended after the key's batch dims: key [..., 2],
    data [D...] -> [..., D..., 2]."""
    k = _i64(key)
    d = torch.as_tensor(data, device=key.device).to(torch.int64) & MASK
    pad = (None,) * d.dim()
    y1, y2 = threefry2x32(k[..., 0][(..., *pad)], k[..., 1][(..., *pad)],
                          torch.zeros_like(d), d)
    return _u32(torch.stack([y1, y2], dim=-1))


def fold_in_each(keys: torch.Tensor, data: torch.Tensor) -> torch.Tensor:
    """``fold_in`` element by element: keys [..., 2] with data [...] of the
    same batch shape -> [..., 2]."""
    k = _i64(keys)
    d = data.to(torch.int64) & MASK
    y1, y2 = threefry2x32(k[..., 0], k[..., 1], torch.zeros_like(d), d)
    return _u32(torch.stack([y1, y2], dim=-1))


def random_bits(key: torch.Tensor, shape) -> torch.Tensor:
    """32 random bits per element (``jax.random.bits``), as int64 in
    [0, 2**32): [..., 2] -> [..., *shape]."""
    y1, y2 = _hash_counts(key, shape)
    return y1 ^ y2


def _unit_f32(bits: torch.Tensor) -> torch.Tensor:
    """Top 23 bits as the mantissa of a float in [1, 2), minus 1."""
    return ((bits >> 9) | 0x3F800000).to(torch.int32).view(torch.float32) - 1.0


def _f32(x: float, device) -> torch.Tensor:
    # a fill, not torch.tensor(): no blocking host-to-device copy on CUDA
    return torch.full((), x, dtype=torch.float32, device=device)


def uniform(key: torch.Tensor, shape, minval: float = 0.0,
            maxval: float = 1.0) -> torch.Tensor:
    """``jax.random.uniform`` in float32 on [minval, maxval)."""
    lo = _f32(minval, key.device)
    hi = _f32(maxval, key.device)
    u = _unit_f32(random_bits(key, shape))
    return torch.maximum(lo, fma(u, hi - lo, lo))


def randint(key: torch.Tensor, shape, minval: int, maxval: int
            ) -> torch.Tensor:
    """``jax.random.randint`` to int32 with Python-int bounds in int32
    range: two 32-bit draws folded into [minval, maxval) by jax's modulus
    rule (uint32 wrap-around included)."""
    if not (-2 ** 31 <= minval < 2 ** 31 and -2 ** 31 < maxval < 2 ** 31):
        raise ValueError("randint bounds must lie in int32 range")
    keys = split(key)
    hi = random_bits(keys[..., 0, :], shape)
    lo = random_bits(keys[..., 1, :], shape)
    span = (maxval - minval) & MASK if maxval > minval else 1
    mult = ((2 ** 16 % span) ** 2 & MASK) % span
    off = ((((hi % span) * mult) & MASK) + lo % span) & MASK
    return (minval + off % span).to(torch.int32)


def bernoulli(key: torch.Tensor, p, shape) -> torch.Tensor:
    """``jax.random.bernoulli`` ('low' mode): uniform < p in float32.
    ``p`` is a float or a float32 tensor broadcastable to the result."""
    if not torch.is_tensor(p):
        p = _f32(p, key.device)
    return uniform(key, shape) < p


# XLA's single-precision erf_inv (Giles' polynomial, the CHLO decomposition
# jax lowers ``lax.erf_inv`` to): coefficients for w < 5 and w >= 5
_ERFINV_LT5 = (2.81022636e-08, 3.43273939e-07, -3.5233877e-06,
               -4.39150654e-06, 0.00021858087, -0.00125372503,
               -0.00417768164, 0.246640727, 1.50140941)
_ERFINV_GE5 = (-0.000200214257, 0.000100950558, 0.00134934322,
               -0.00367342844, 0.00573950773, -0.0076224613,
               0.00943887047, 1.00167406, 2.83297682)


def erf_inv(x: torch.Tensor) -> torch.Tensor:
    """float32 inverse error function, op for op as XLA evaluates it."""
    w = -torch.log1p(x * -x)
    lt = w < 5.0
    w = torch.where(lt, w - 2.5, torch.sqrt(w) - 3.0)
    p = torch.where(lt, _f32(_ERFINV_LT5[0], x.device),
                    _f32(_ERFINV_GE5[0], x.device))
    for c_lt, c_ge in zip(_ERFINV_LT5[1:], _ERFINV_GE5[1:], strict=True):
        p = fma(p, w, torch.where(lt, _f32(c_lt, x.device),
                                  _f32(c_ge, x.device)))
    return torch.where(x.abs() == 1.0, x * math.inf, p * x)


def normal(key: torch.Tensor, shape) -> torch.Tensor:
    """``jax.random.normal`` in float32: sqrt(2)·erf_inv(U(-1+ulp, 1))."""
    lo = float(torch.nextafter(torch.tensor(-1.0, dtype=torch.float32),
                               torch.tensor(0.0, dtype=torch.float32)))
    u = uniform(key, shape, lo, 1.0)
    return _f32(math.sqrt(2.0), key.device) * erf_inv(u)


def gumbel(key: torch.Tensor, shape) -> torch.Tensor:
    """``jax.random.gumbel`` ('low' mode) in float32."""
    tiny = torch.finfo(torch.float32).tiny
    return -torch.log(-torch.log(uniform(key, shape, tiny, 1.0)))


def _split2(keys: torch.Tensor):
    k = split(keys)
    return k[..., 0, :], k[..., 1, :]


def _where_key(mask: torch.Tensor, a: torch.Tensor, b: torch.Tensor):
    """``where`` over keys [M, 2] by a mask [M] (CUDA has no uint32
    ``where``, so it selects the same bits as int32)."""
    i32 = torch.int32
    return torch.where(mask[:, None], a.view(i32), b.view(i32)).view(
        torch.uint32)


def _gamma_one(keys: torch.Tensor, alpha: torch.Tensor) -> torch.Tensor:
    """Marsaglia-Tsang draws, one per key of keys [M, 2], op for op as jax's
    ``_gamma_one`` (``jax/_src/random.py``).  jax runs a while loop per
    element; here every element keeps its own key chain and a masked update
    runs until all have accepted, which gives each element the draws jax
    gives it."""
    one = torch.ones_like(alpha)
    boost = alpha >= one
    a = torch.where(boost, alpha, alpha + one)
    d = a - float(np.float32(1.0 / 3.0))
    c = float(np.float32(1.0 / 3.0)) / torch.sqrt(d)
    key, subkey = _split2(keys)

    def rejected(X, V, U):
        return (U >= one - 0.0331 * (X * X)) & (
            torch.log(U) >= X * 0.5 + d * ((one - V) + torch.log(V)))

    # jax's initial carry (X, V, U) = (0, 1, 2) is rejected, so every
    # element runs the body at least once
    X = torch.zeros_like(alpha)
    V = torch.ones_like(alpha)
    U = torch.full_like(alpha, 2.0)
    todo = torch.ones_like(boost)
    while bool(todo.any()):
        k3 = split(key, 3)
        key = _where_key(todo, k3[:, 0], key)
        # the inner loop redraws x while v = 1 + x·c <= 0, from v = -1
        xkey, x, v = k3[:, 1], torch.zeros_like(alpha), -one
        need = todo.clone()
        while bool(need.any()):
            nxt, sub = _split2(xkey)
            xn = normal(sub, ())
            vn = fma(xn, c, one)
            xkey = _where_key(need, nxt, xkey)
            x = torch.where(need, xn, x)
            v = torch.where(need, vn, v)
            need = need & (v <= 0.0)
        u = uniform(k3[:, 2], ())
        X = torch.where(todo, x * x, X)
        V = torch.where(todo, v * v * v, V)
        U = torch.where(todo, u, U)
        todo = todo & rejected(X, V, U)
    samples = one - uniform(subkey, ())
    # XLA's f32 pow agrees with the correctly rounded one far more often
    # than ATen's f32 pow does, so it is taken in f64 and rounded once
    scale = torch.where(boost, one, torch.pow(
        samples.double(), (one / alpha).double()).float())
    return d * V * scale


def gamma(keys: torch.Tensor, a, shape) -> torch.Tensor:
    """``jax.random.gamma(key, a, shape)`` in float32 for keys [..., 2] and
    a scalar shape parameter ``a``: [..., *shape].

    As jax does, each key is split into one key per element (``split(key,
    prod(shape))``, so ``split(key, 1)`` for a scalar draw), and each
    element runs its own rejection loop.  The keys, splits and uniforms are
    exact; ``normal`` and ``log`` are ulp-level (module docstring), so an
    acceptance test can flip on a rare element, whose draw then differs
    entirely."""
    shape = tuple(shape)
    batch = keys.shape[:-1]
    flat = split(keys, math.prod(shape)).reshape(-1, 2)
    alpha = torch.full((flat.shape[0],), float(np.float32(a)),
                       dtype=torch.float32, device=keys.device)
    return _gamma_one(flat, alpha).reshape(*batch, *shape)
