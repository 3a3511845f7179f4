"""Shared building blocks: inits, norms, activations, rotary embeddings;
port of ``repro/models/common.py``.

Parameters are ``nn.ParameterDict``s whose keys and leaf layouts are those
of the JAX package's nested dicts, so the two packages can be held against
each other on the same weights (``repro_torch.bridge``).  Norms, the qk-norm
and RoPE compute in float32 and cast back to the input's dtype, cast for
cast as the reference does; that is what keeps bf16 results within a bf16
ulp of it.  Every rmsnorm (``apply_norm``'s and the qk-norm) goes through
``kernels.ops.rmsnorm``: the hand-written CUDA kernel on a CUDA tensor,
the same f32 arithmetic as the reference's inline norm on the CPU.  The
JAX package's sharding specs and scan helpers have no counterpart on one
card: a stage is a slice of an ``nn.ModuleList`` (``slice_layers``) and a
loop replaces ``lax.scan``; ``associative_scan`` is ``lax.associative_scan``'s
algorithm, for the recurrent blocks.
"""
from __future__ import annotations

import contextvars
import functools
import math
from typing import Callable, List, Sequence, Tuple

import torch
import torch.nn.functional as F
import torch.utils.checkpoint as ckpt
from torch import nn

from repro_torch.kernels import ops

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
    if kind != "layernorm":
        return ops.rmsnorm(x, p["scale"], eps)
    xf = x.float()
    mu = xf.mean(dim=-1, keepdim=True)
    var = (xf - mu).square().mean(dim=-1, keepdim=True)
    y = (xf - mu) * torch.rsqrt(var + eps)
    y = y * p["scale"].float() + p["bias"].float()
    return y.to(x.dtype)


def rms_head_norm(scale: torch.Tensor, x: torch.Tensor,
                  eps: float = 1e-6) -> torch.Tensor:
    """Per-head RMS norm over head_dim (qwen3 qk-norm); scale [head_dim]."""
    return ops.rmsnorm(x, scale, eps)


# ---------------------------------------------------------------------------
# Activations
# ---------------------------------------------------------------------------


def _gelu(x: torch.Tensor) -> torch.Tensor:
    """``jax.nn.gelu`` (tanh approximation) op for op: each product, sum and
    the tanh rounded to x's dtype, the constants rounded to it first, so a
    bfloat16 result matches the reference's bit for bit."""
    c1, c2 = torch.tensor([0.044715, math.sqrt(2.0 / math.pi)],
                          dtype=x.dtype).tolist()
    return x * (0.5 * (1.0 + torch.tanh(c2 * (x + c1 * (x * x * x)))))


def softplus(x: torch.Tensor) -> torch.Tensor:
    """``jax.nn.softplus``: logaddexp(x, 0), without torch's linear
    threshold."""
    return torch.logaddexp(x, torch.zeros((), dtype=x.dtype,
                                          device=x.device))


def act_fn(name: str):
    return {"silu": F.silu, "gelu": _gelu, "swiglu": F.silu,
            "geglu": _gelu}[name]


# ---------------------------------------------------------------------------
# Rotary embeddings (RoPE + M-RoPE)
# ---------------------------------------------------------------------------


def rope_angles(positions: torch.Tensor, head_dim: int, theta: float,
                sections: Sequence[int] = ()
                ) -> Tuple[torch.Tensor, torch.Tensor]:
    """cos/sin tables [B, S, head_dim] (half-rotation layout).

    positions: [B, S] (standard RoPE) or [R, B, S] with R ==
    len(sections) (M-RoPE: one position stream per frequency section,
    qwen2-vl's temporal/height/width split); frequency f takes its
    position from stream ``sec_id[f]``.
    """
    half = head_dim // 2
    exps = torch.arange(0, half, dtype=torch.float32,
                        device=positions.device) / half
    inv_freq = 1.0 / torch.pow(torch.tensor(theta, dtype=torch.float32,
                                            device=positions.device), exps)
    ang = positions.float()[..., None] * inv_freq      # [(R,) B, S, half]
    if sections:
        if positions.dim() != 3 or positions.shape[0] != len(sections):
            raise ValueError("M-RoPE expects positions [R, B, S] with R == "
                             f"{len(sections)}; got {tuple(positions.shape)}")
        sec_id = torch.cat([torch.full((n,), i, dtype=torch.int64,
                                       device=positions.device)
                            for i, n in enumerate(sections)])
        ang = ang.gather(0, sec_id.expand(1, *ang.shape[1:]))[0]
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
# associative scan (lax.associative_scan's algorithm)
# ---------------------------------------------------------------------------


def _along(t: torch.Tensor, dim: int, start, stop=None, step=1):
    return t[(slice(None),) * dim + (slice(start, stop, step),)]


def _interleave(even: torch.Tensor, odd: torch.Tensor,
                dim: int) -> torch.Tensor:
    shape = list(even.shape)
    shape[dim] += odd.shape[dim]
    out = even.new_empty(shape)
    _along(out, dim, 0, None, 2).copy_(even)
    _along(out, dim, 1, None, 2).copy_(odd)
    return out


def associative_scan(fn: Callable[[Sequence[torch.Tensor],
                                   Sequence[torch.Tensor]],
                                  Sequence[torch.Tensor]],
                     elems: Sequence[torch.Tensor],
                     dim: int) -> List[torch.Tensor]:
    """Inclusive scan of ``elems`` (tensors of one length along ``dim``)
    under the associative ``fn(left, right)``, combining elements in the
    pairs ``lax.associative_scan`` does: adjacent pairs, the scan of those
    by recursion, then the even positions from the odd ones.  The same
    pairing gives the same rounding as the reference's scans."""
    n = elems[0].shape[dim]
    if n < 2:
        return list(elems)
    reduced = fn([_along(e, dim, 0, -1, 2) for e in elems],
                 [_along(e, dim, 1, None, 2) for e in elems])
    odd = associative_scan(fn, reduced, dim)
    rest = [_along(e, dim, 2, None, 2) for e in elems]
    if n % 2 == 0:
        even = fn([_along(o, dim, 0, -1) for o in odd], rest)
    else:
        even = fn(odd, rest)
    even = [torch.cat([_along(e, dim, 0, 1), r], dim=dim)
            for e, r in zip(elems, even)]
    return [_interleave(e, o, dim) for e, o in zip(even, odd)]


def linear_combine(left: Sequence[torch.Tensor],
                   right: Sequence[torch.Tensor]) -> List[torch.Tensor]:
    """The composition of h -> a1·h + b1 then h -> a2·h + b2: (a1·a2,
    a2·b1 + b2), the recurrent blocks' ``comb``."""
    (a1, b1), (a2, b2) = left, right
    return [a1 * a2, a2 * b1 + b2]


# ---------------------------------------------------------------------------
# layer utilities
# ---------------------------------------------------------------------------


def _dots_saveable(ctx, op, *args, **kwargs):
    """Keep the products with no batch dimension (the weight matmuls, as
    ``jax.checkpoint_policies.dots_with_no_batch_dims_saveable``);
    recompute everything else, the batched attention and expert products
    included."""
    if op in (torch.ops.aten.mm.default, torch.ops.aten.addmm.default):
        return ckpt.CheckpointPolicy.MUST_SAVE
    return ckpt.CheckpointPolicy.PREFER_RECOMPUTE


def remat(fn: Callable, policy: str) -> Callable:
    """The reference's ``remat_wrap`` for one layer's function: ``"none"``
    saves what autograd saves; ``"nothing"`` saves only the layer's inputs
    and recomputes its forward in the backward pass
    (``torch.utils.checkpoint``, non-reentrant); ``"dots"`` recomputes all
    but the weight products.  Without grad mode (serving) ``fn`` runs as
    it is.  The recompute runs in a copy of the forward's context
    variables: on the card the backward pass runs on autograd's device
    thread, where ``ops.reference()`` would otherwise not hold, and the
    recompute would take the kernels where the forward took the plain
    path."""
    if policy not in ("none", "nothing", "dots"):
        raise ValueError(f"unknown remat_policy {policy!r}")
    if policy == "none":
        return fn
    kw = {} if policy == "nothing" else {"context_fn": functools.partial(
        ckpt.create_selective_checkpoint_contexts, _dots_saveable)}

    def wrapped(*args, **kwargs):
        if not torch.is_grad_enabled():
            return fn(*args, **kwargs)
        ctx = contextvars.copy_context()
        return ckpt.checkpoint(ctx.run, fn, *args, use_reentrant=False,
                               **kw, **kwargs)

    return wrapped


def slice_layers(layers: nn.ModuleList, start: int, stop: int
                 ) -> nn.ModuleList:
    """Layers [start, stop) of a model: a split-computing stage.  The
    modules are shared, not copied."""
    return layers[start:stop]


def count_params(module: nn.Module) -> int:
    return int(sum(p.numel() for p in module.parameters()))
