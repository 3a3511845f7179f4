"""Shared building blocks: inits, norms, activations, rotary embeddings;
port of ``repro/models/common.py``.

Parameters are ``nn.ParameterDict``s whose keys and leaf layouts are those
of the JAX package's nested dicts, so the two packages can be held against
each other on the same weights (``repro_torch.bridge``).  Norms, the qk-norm
and RoPE compute in float32 and cast back to the input's dtype, cast for
cast as the reference does; that is what keeps bf16 results within a bf16
ulp of it.  The JAX package's sharding specs and scan helpers have no
counterpart on one card: a stage is a slice of an ``nn.ModuleList``
(``slice_layers``) and a loop replaces ``lax.scan``.
"""
from __future__ import annotations

import math
from typing import Tuple

import torch
import torch.nn.functional as F
from torch import nn

# ---------------------------------------------------------------------------
# dtype / init helpers
# ---------------------------------------------------------------------------


def dt(name: str) -> torch.dtype:
    return {"float32": torch.float32, "bfloat16": torch.bfloat16,
            "float16": torch.float16}[name]


def dense_init(gen: torch.Generator, shape, in_axis_size: int, dtype,
               device) -> torch.Tensor:
    """Truncated normal on [-2, 2] times 1/√fan_in (the reference's
    LeCun-style fan-in init), drawn in float32 from ``gen`` on ``device``."""
    std = 1.0 / math.sqrt(max(in_axis_size, 1))
    x = torch.empty(shape, dtype=torch.float32, device=device)
    nn.init.trunc_normal_(x, 0.0, 1.0, -2.0, 2.0, generator=gen)
    return (x * std).to(dtype)


def embed_init(gen: torch.Generator, shape, dtype, device) -> torch.Tensor:
    x = torch.randn(shape, dtype=torch.float32, device=device, generator=gen)
    return (x * 0.02).to(dtype)


def param_dict(**leaves: torch.Tensor) -> nn.ParameterDict:
    """A dict of frozen parameters (serving computes no gradients)."""
    return nn.ParameterDict({k: nn.Parameter(v, requires_grad=False)
                             for k, v in leaves.items()})


# ---------------------------------------------------------------------------
# Norms
# ---------------------------------------------------------------------------


def init_norm(d: int, kind: str, dtype, device) -> nn.ParameterDict:
    p = {"scale": torch.ones((d,), dtype=dtype, device=device)}
    if kind == "layernorm":
        p["bias"] = torch.zeros((d,), dtype=dtype, device=device)
    return param_dict(**p)


def apply_norm(p, x: torch.Tensor, kind: str = "rmsnorm",
               eps: float = 1e-6) -> torch.Tensor:
    xf = x.float()
    if kind == "layernorm":
        mu = xf.mean(dim=-1, keepdim=True)
        var = (xf - mu).square().mean(dim=-1, keepdim=True)
        y = (xf - mu) * torch.rsqrt(var + eps)
        y = y * p["scale"].float() + p["bias"].float()
    else:
        ms = xf.square().mean(dim=-1, keepdim=True)
        y = xf * torch.rsqrt(ms + eps) * p["scale"].float()
    return y.to(x.dtype)


def rms_head_norm(scale: torch.Tensor, x: torch.Tensor,
                  eps: float = 1e-6) -> torch.Tensor:
    """Per-head RMS norm over head_dim (qwen3 qk-norm); scale [head_dim]."""
    xf = x.float()
    ms = xf.square().mean(dim=-1, keepdim=True)
    return (xf * torch.rsqrt(ms + eps) * scale.float()).to(x.dtype)


# ---------------------------------------------------------------------------
# Activations
# ---------------------------------------------------------------------------


def _gelu(x: torch.Tensor) -> torch.Tensor:
    return F.gelu(x, approximate="tanh")      # jax.nn.gelu's default


def act_fn(name: str):
    return {"silu": F.silu, "gelu": _gelu, "swiglu": F.silu,
            "geglu": _gelu}[name]


# ---------------------------------------------------------------------------
# Rotary embeddings (standard RoPE; M-RoPE comes with the vlm family)
# ---------------------------------------------------------------------------


def rope_angles(positions: torch.Tensor, head_dim: int, theta: float
                ) -> Tuple[torch.Tensor, torch.Tensor]:
    """cos/sin tables [B, S, head_dim] (half-rotation layout) for
    positions [B, S]."""
    half = head_dim // 2
    exps = torch.arange(0, half, dtype=torch.float32,
                        device=positions.device) / half
    inv_freq = 1.0 / torch.pow(torch.tensor(theta, dtype=torch.float32,
                                            device=positions.device), exps)
    ang = positions.float()[..., None] * inv_freq          # [B, S, half]
    cos = torch.cat([torch.cos(ang)] * 2, dim=-1)
    sin = torch.cat([torch.sin(ang)] * 2, dim=-1)
    return cos, sin


def rotate_half(x: torch.Tensor) -> torch.Tensor:
    x1, x2 = torch.chunk(x, 2, dim=-1)
    return torch.cat([-x2, x1], dim=-1)


def apply_rope(x: torch.Tensor, cos: torch.Tensor,
               sin: torch.Tensor) -> torch.Tensor:
    """x [B, S, H, hd]; cos/sin [B, S, hd]."""
    c = cos[:, :, None, :].float()
    s = sin[:, :, None, :].float()
    xf = x.float()
    return (xf * c + rotate_half(xf) * s).to(x.dtype)


# ---------------------------------------------------------------------------
# layer utilities
# ---------------------------------------------------------------------------


def slice_layers(layers: nn.ModuleList, start: int, stop: int
                 ) -> nn.ModuleList:
    """Layers [start, stop) of a model: a split-computing stage.  The
    modules are shared, not copied."""
    return layers[start:stop]


def count_params(module: nn.Module) -> int:
    return int(sum(p.numel() for p in module.parameters()))
