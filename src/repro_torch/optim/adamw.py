"""AdamW + global-norm clip + cosine schedule; port of
``repro/optim/adamw.py``, op for op (not ``torch.optim.AdamW``).

The reference returns new trees; the port updates the parameters, m and v
in place under ``torch.no_grad()`` (and scales the gradients it is given
in place by the clip), which keeps the full-width train state at four
copies of the parameters.  The arithmetic is the reference's, in float32:

* ``schedule``: linear warm-up to ``lr``, then a cosine to
  ``min_lr_frac·lr`` over ``total_steps``;
* ``clip_by_global_norm``: ``gn = sqrt(Σ_leaves Σ g²)``, every leaf times
  ``min(1, grad_clip / max(gn, 1e-9))``;
* the update, with the step counted from 1: ``m = b1·m + (1−b1)·g``, ``v =
  b2·v + (1−b2)·g²``, the bias corrections ``1 − b**step``, ``delta =
  m̂/(sqrt(v̂) + eps) + wd·p``, ``p = p − lr·delta``.

Each elementwise stage is one ``torch._foreach_*`` op over all leaves (the
multi-tensor kernels on the card: the same roundings as a loop over the
leaves, far fewer launches).  The step counter and the schedule live on
the host (0-d tensors on the CPU), so a step reads no scalar back from
the card; the global norm and the clip scale stay on the device.  XLA's
CPU backend may fuse ``a·b + c`` into one rounding where the port rounds
twice (``core/fp.py``), so the two packages agree to an ulp a step.
"""
from __future__ import annotations

import dataclasses
import math
from typing import Dict, List, NamedTuple, Tuple

import torch
from torch import nn


@dataclasses.dataclass(frozen=True)
class OptConfig:
    lr: float = 3e-4
    beta1: float = 0.9
    beta2: float = 0.95
    eps: float = 1e-8
    weight_decay: float = 0.1
    grad_clip: float = 1.0
    warmup_steps: int = 100
    total_steps: int = 10_000
    min_lr_frac: float = 0.1


class OptState(NamedTuple):
    step: torch.Tensor              # [] int32, on the host
    m: Dict[str, torch.Tensor]      # float32, by parameter name
    v: Dict[str, torch.Tensor]


def named_leaves(params) -> Dict[str, torch.Tensor]:
    """{name: leaf} of an ``nn.Module`` (``named_parameters``) or a dict."""
    if isinstance(params, nn.Module):
        return dict(params.named_parameters())
    return dict(params)


def init_opt(params) -> OptState:
    zeros = {n: torch.zeros_like(p, dtype=torch.float32)
             for n, p in named_leaves(params).items()}
    return OptState(torch.zeros((), dtype=torch.int32), zeros,
                    {n: z.clone() for n, z in zeros.items()})


def schedule(cfg: OptConfig, step) -> torch.Tensor:
    """The learning rate at ``step`` (an int or an int tensor), float32 on
    the host."""
    step = torch.as_tensor(step).to(device="cpu", dtype=torch.float32)
    warm = torch.clamp(step / max(cfg.warmup_steps, 1), max=1.0)
    prog = torch.clamp((step - cfg.warmup_steps)
                       / max(cfg.total_steps - cfg.warmup_steps, 1),
                       0.0, 1.0)
    cos = 0.5 * (1.0 + torch.cos(math.pi * prog))
    frac = cfg.min_lr_frac + (1 - cfg.min_lr_frac) * cos
    return cfg.lr * warm * frac


def global_norm(leaves: List[torch.Tensor]) -> torch.Tensor:
    """sqrt of the sum over leaves of each leaf's float32 sum of squares."""
    sums = [torch.sum(torch.square(x.float())) for x in leaves]
    return torch.sqrt(torch.sum(torch.stack(sums)))


def clip_by_global_norm(grads: List[torch.Tensor], max_norm: float
                        ) -> Tuple[List[torch.Tensor], torch.Tensor]:
    """Scale the float32 gradients in place by ``min(1, max_norm / max(gn,
    1e-9))``; returns (the gradients, gn)."""
    gn = global_norm(grads)
    scale = torch.clamp(max_norm / torch.clamp(gn, min=1e-9), max=1.0)
    grads = [g.float() for g in grads]
    torch._foreach_mul_(grads, scale)
    return grads, gn


@torch.no_grad()
def apply_updates(params, grads: Dict[str, torch.Tensor], state: OptState,
                  cfg: OptConfig):
    """One AdamW step on ``params`` (updated in place), from ``grads`` by
    parameter name (a missing or None gradient counts as zero; the given
    gradients are clipped in place).  Returns (params, the new OptState,
    {"grad_norm", "lr"})."""
    leaves = named_leaves(params)
    names = list(leaves)
    ps = [leaves[n] for n in names]
    gs = [grads[n] if grads.get(n) is not None else torch.zeros_like(
        leaves[n], dtype=torch.float32) for n in names]
    ms = [state.m[n] for n in names]
    vs = [state.v[n] for n in names]
    gs, gn = clip_by_global_norm(gs, cfg.grad_clip)
    step = state.step + 1
    lr = schedule(cfg, step)
    b1, b2 = cfg.beta1, cfg.beta2
    bc1 = float(1.0 - b1 ** step.float())
    bc2 = float(1.0 - b2 ** step.float())

    torch._foreach_mul_(ms, b1)                         # m = b1·m + (1−b1)·g
    tmp = torch._foreach_mul(gs, 1 - b1)
    torch._foreach_add_(ms, tmp)
    tmp = torch._foreach_mul(gs, gs)                    # v = b2·v + (1−b2)·g²
    torch._foreach_mul_(tmp, 1 - b2)
    torch._foreach_mul_(vs, b2)
    torch._foreach_add_(vs, tmp)
    del tmp, gs
    den = torch._foreach_div(vs, bc2)                   # sqrt(v̂) + eps
    torch._foreach_sqrt_(den)
    torch._foreach_add_(den, cfg.eps)
    delta = torch._foreach_div(ms, bc1)                 # m̂ / den
    torch._foreach_div_(delta, den)
    del den
    p32 = [p.float() for p in ps]
    if cfg.weight_decay:
        wd = torch._foreach_mul(p32, cfg.weight_decay)
        torch._foreach_add_(delta, wd)
        del wd
    torch._foreach_mul_(delta, float(lr))
    torch._foreach_sub_(p32, delta)
    for p, q in zip(ps, p32):
        if q is not p:                                  # a non-f32 leaf
            p.copy_(q)
    return params, OptState(step, state.m, state.v), {"grad_norm": gn,
                                                      "lr": lr}
