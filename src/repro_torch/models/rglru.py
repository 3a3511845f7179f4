"""Griffin/RecurrentGemma recurrent block: conv1d + RG-LRU + gated output;
port of ``repro/models/rglru.py``.

RG-LRU (arXiv:2402.19427 eq. 1-4):
    r_t = sigmoid(W_a x_t)          (recurrence gate, block-diag W_a)
    i_t = sigmoid(W_x x_t)          (input gate,      block-diag W_x)
    a_t = a^(c * r_t),  a = sigmoid(Λ)    (elementwise)
    h_t = a_t * h_{t-1} + sqrt(1 - a_t^2) * (i_t * x_t)

The recurrence over a sequence (``rglru_scan_ref``) has two paths, as
attention has: from a zero state on a CUDA tensor (prefill) it launches the
hand-written CUDA kernel (``kernels/csrc/rglru_scan.cu``); on the CPU,
under ``ops.reference()`` and from a given state, it is the reference's
associative scan (``common.associative_scan``, the same pairing as
``lax.associative_scan``).  Decode with a state is the one-step update.
The gate matrices are block-diagonal with 16 blocks, a plain batched
product.
"""
from __future__ import annotations

from typing import Optional, Tuple

import torch
from torch import nn

from repro_torch.configs import ModelConfig
from repro_torch.kernels import ops
from repro_torch.launch.mesh import P
from repro_torch.models.common import (act_fn, associative_scan, dense_init,
                                       linear_combine, param_dict, softplus)

N_GATE_BLOCKS = 16


def init_rec_block(gen: torch.Generator, cfg: ModelConfig, dtype,
                   device) -> nn.ParameterDict:
    """The reference's init: Λ from u ~ U[0.9, 0.999] as
    logit(u^(1/c)), so that a = sigmoid(Λ) lies in 0.9..0.999 (a random Λ
    would blow the scan up); fan-in truncated normals elsewhere."""
    h = cfg.hybrid
    d, w = cfg.d_model, (h.lru_width or cfg.d_model)
    nb = min(N_GATE_BLOCKS, w)
    bs = w // nb
    u = torch.rand((w,), generator=gen, dtype=torch.float32,
                   device=device) * (0.999 - 0.9) + 0.9
    uc = u ** (1.0 / h.c)
    lam = torch.log(uc / (1 - uc))
    return param_dict(
        w_in_x=dense_init(gen, (d, w), d, dtype, device),   # recurrence
        w_in_g=dense_init(gen, (d, w), d, dtype, device),   # gelu gate
        conv_w=dense_init(gen, (h.conv_width, w), h.conv_width, dtype,
                          device),
        conv_b=torch.zeros((w,), dtype=dtype, device=device),
        gate_a=dense_init(gen, (nb, bs, bs), bs, dtype, device),
        gate_x=dense_init(gen, (nb, bs, bs), bs, dtype, device),
        lam=lam,
        w_out=dense_init(gen, (w, d), w, dtype, device))


def specs_rec_block(cfg: ModelConfig):
    return {
        "w_in_x": P("data", "model"), "w_in_g": P("data", "model"),
        "conv_w": P(None, "model"), "conv_b": P("model"),
        "gate_a": P("model", None, None), "gate_x": P("model", None, None),
        "lam": P("model"), "w_out": P("model", "data"),
    }


# ---------------------------------------------------------------------------
# RG-LRU recurrence
# ---------------------------------------------------------------------------


def _gates(p, x: torch.Tensor, cfg: ModelConfig):
    """Block-diagonal gate projections. x [B,S,w] -> r, i [B,S,w] (f32)."""
    w = x.shape[-1]
    nb = p["gate_a"].shape[0]
    xb = x.reshape(*x.shape[:-1], nb, w // nb)
    r = torch.einsum("bsnd,nde->bsne", xb, p["gate_a"].to(x.dtype))
    i = torch.einsum("bsnd,nde->bsne", xb, p["gate_x"].to(x.dtype))
    r = torch.sigmoid(r.reshape(x.shape).float())
    i = torch.sigmoid(i.reshape(x.shape).float())
    return r, i


def rglru_coeffs(p, x: torch.Tensor, cfg: ModelConfig):
    """a_t, b_t of the linear recurrence h_t = a_t h + b_t (fp32)."""
    r, i = _gates(p, x, cfg)
    log_a = -cfg.hybrid.c * softplus(p["lam"]) * r        # log a_t <= 0
    a = torch.exp(log_a)
    # sqrt(1 - a^2) computed stably via expm1: 1-a^2 = -expm1(2 log a)
    norm = torch.sqrt(-torch.expm1(2.0 * log_a))
    b = norm * (i * x.float())
    return a, b


def rglru_scan_ref(a: torch.Tensor, b: torch.Tensor,
                   h0: Optional[torch.Tensor] = None
                   ) -> Tuple[torch.Tensor, torch.Tensor]:
    """h_t = a_t h_{t-1} + b_t over axis 1 (seq).  a, b [B, S, w] fp32; h0
    [B, w] initial state.  Returns (h_seq, h_last).

    From a zero state on a CUDA tensor (outside ``ops.reference()``) the
    CUDA kernel computes h_seq; otherwise the associative scan."""
    if h0 is None and ops.takes_kernel(a):
        h = ops.rglru_scan(a, b)
        return h, h[:, -1].clone()
    if h0 is not None:
        b = torch.cat([b[:, :1] + a[:, :1] * h0[:, None], b[:, 1:]], dim=1)
    _, hh = associative_scan(linear_combine, [a, b], dim=1)
    return hh, hh[:, -1].clone()


def rglru_step(a: torch.Tensor, b: torch.Tensor,
               h: torch.Tensor) -> torch.Tensor:
    """One decode step: a, b [B, w]; h [B, w]."""
    return a * h + b


# ---------------------------------------------------------------------------
# temporal conv (depthwise, causal, width cw)
# ---------------------------------------------------------------------------


def causal_conv1d(x: torch.Tensor, conv_w: torch.Tensor,
                  conv_b: torch.Tensor,
                  state: Optional[torch.Tensor] = None):
    """x [B,S,w]; conv_w [cw, w] depthwise causal conv.

    state: [B, cw-1, w] trailing inputs from the previous segment (decode).
    Returns (y [B,S,w], new_state [B, cw-1, w]).  The cw shifted products
    are summed in x's dtype from 0 in order, as the reference's ``sum``.
    """
    cw = conv_w.shape[0]
    B, S, w = x.shape
    if state is None:
        state = torch.zeros((B, cw - 1, w), dtype=x.dtype, device=x.device)
    xp = torch.cat([state, x], dim=1)                  # [B, S+cw-1, w]
    y = sum(xp[:, i:i + S, :] * conv_w[i][None, None, :].to(x.dtype)
            for i in range(cw))
    y = y + conv_b.to(x.dtype)
    new_state = xp[:, -(cw - 1):, :].clone() if cw > 1 else state
    return y, new_state


def apply_rec_block(p, cfg: ModelConfig, x: torch.Tensor, *,
                    conv_state=None, h_state=None, return_state=False,
                    reduce=None):
    """Full recurrent block. x [B,S,d] -> y [B,S,d] (+ states).  Under
    tensor parallelism the leaves hold this rank's W channels and gate
    blocks (the conv, lam and the scan then run on them) and ``reduce``
    sums the partial outputs over the ranks."""
    cd = x.dtype
    xr = x @ p["w_in_x"].to(cd)                        # recurrence branch
    xg = act_fn("gelu")(x @ p["w_in_g"].to(cd))        # gate branch
    xr, new_conv = causal_conv1d(xr, p["conv_w"], p["conv_b"], conv_state)
    a, b = rglru_coeffs(p, xr, cfg)
    if x.shape[1] == 1 and h_state is not None:        # decode fast path
        h_last = rglru_step(a[:, 0], b[:, 0], h_state)
        h = h_last[:, None, :]
    else:
        h, h_last = rglru_scan_ref(a, b, h_state)
    y = (h.to(cd) * xg) @ p["w_out"].to(cd)
    if reduce is not None:
        y = reduce(y)
    if return_state:
        return y, new_conv, h_last
    return y

