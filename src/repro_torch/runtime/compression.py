"""int8 gradient compression with error feedback; port of
``repro/runtime/compression.py``.

Per-leaf symmetric quantization: q = round(g / s), s = max|g| / 127 +
1e-12 (``torch.round`` rounds half to even, as ``jnp.round`` does).  The
residual (g − dequant(q)) is carried to the next step, so compression
noise averages out instead of biasing the descent direction.  On one card
nothing crosses a network: ``compress_grads`` returns what would survive
the int8 all-reduce.  Gradients and residuals are dicts by parameter name.
"""
from __future__ import annotations

from typing import Dict, NamedTuple, Tuple

import torch

from repro_torch.optim.adamw import named_leaves


class CompressionState(NamedTuple):
    residual: Dict[str, torch.Tensor]   # like the gradients, float32


def init_compression(params) -> CompressionState:
    return CompressionState({n: torch.zeros(p.shape, dtype=torch.float32,
                                            device=p.device)
                             for n, p in named_leaves(params).items()})


def quantize(g: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    scale = g.abs().max() / 127.0 + 1e-12
    q = torch.clamp(torch.round(g / scale), -127, 127).to(torch.int8)
    return q, scale


def dequantize(q: torch.Tensor, scale: torch.Tensor) -> torch.Tensor:
    return q.float() * scale


def compress_grads(grads: Dict[str, torch.Tensor], state: CompressionState
                   ) -> Tuple[Dict[str, torch.Tensor], CompressionState]:
    """(the dequantized gradients, the updated residual state)."""
    deq, res = {}, {}
    for n, g in grads.items():
        gf = g.float() + state.residual[n]
        q, s = quantize(gf)
        deq[n] = dequantize(q, s)
        res[n] = gf - deq[n]
    return deq, CompressionState(res)
