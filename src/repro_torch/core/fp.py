"""Float32 arithmetic as the reference's compiled XLA code rounds it.

Three habits of XLA's CPU backend decide the last bits of the JAX
package's results, and the port follows all three where it computes the
same expression:

* ``a * b + c`` inside a fused loop becomes one fused multiply-add (one
  rounding, not two).  ``fma`` rounds the same way: the product of two f32 is
  exact in f64 and the sum is exact there too for the simulator's operands
  (their exponents lie within 53 bits of each other), so the one rounding
  left is the cast back to f32.
* a float sum is taken in some order of f32 additions that differs between
  XLA, ATen's CPU and ATen's CUDA reductions, and between batch shapes.
  ``fsum`` adds in f64 and rounds once: for up to 2**29 f32 terms of one
  sign the f64 sum is exact, so the result is the correctly rounded sum in
  any order, on any device, at any run count R.  It agrees with XLA's
  order-dependent f32 sum whenever that is exact (e.g. at most two nonzero
  terms) and is within an ulp of it otherwise.
* ``x / c`` by a constant becomes ``x * (1/c)`` (``div``).
"""
from __future__ import annotations

import numpy as np
import torch


def _f64(x):
    """A tensor in f64, or a Python number rounded to f32 first (it enters
    XLA's arithmetic as a weakly typed f32 constant)."""
    return x.double() if torch.is_tensor(x) else float(np.float32(x))


def fma(a, b, c) -> torch.Tensor:
    """fl32(a·b + c) with a single rounding; operands are f32 tensors or
    Python numbers."""
    return (_f64(a) * _f64(b) + _f64(c)).float()


def fsum(x: torch.Tensor, dim=-1) -> torch.Tensor:
    """Order-free f32 sum over ``dim``: f64 accumulation, one rounding."""
    return x.double().sum(dim).float()


def div(a, b) -> torch.Tensor:
    """a / b in f32 as the reference's compiled code divides.

    XLA rewrites a division by a constant into a multiply by the constant's
    f32 reciprocal, so ``tensor / number`` is that multiply here too.  A
    constant over a tensor stays one IEEE division (ATen alone would take
    ``number / tensor`` as ``reciprocal(tensor) * number``, two roundings).
    """
    if not torch.is_tensor(b):
        return a * float(np.float32(1.0) / np.float32(b))
    if not torch.is_tensor(a):
        a = torch.full((), a, dtype=b.dtype, device=b.device)
    return a / b
