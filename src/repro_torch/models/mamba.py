"""Mamba-1 block (falcon-mamba-7b) with a selective scan; port of
``repro/models/mamba.py``.

    x, z = split(in_proj(u))                # d_inner = expand * d_model
    x    = silu(causal_conv1d(x))
    Δ,B,C = x_proj(x)  ;  Δ = softplus(dt_proj(Δ))
    h_t  = exp(Δ_t A) h_{t-1} + Δ_t B_t x_t      (A diag-negative, [d_in, N])
    y_t  = C_t · h_t + D x_t
    out  = out_proj(y * silu(z))

The scan over a sequence (``selective_scan_fused``) has two paths, as
attention has.  From a zero state on a CUDA tensor (prefill) it computes
the decay ``a``, drive ``b`` and readout ``C`` over the whole sequence with
``ssm_coeffs`` and launches the hand-written CUDA kernel
(``kernels/csrc/mamba_scan.cu``), which returns y and the last state.  That
materialises ``a`` and ``b`` in full, [B, S, d_in, N] float32 each: 1.074
GB apiece at falcon-mamba-7b's prefill of 4 x 512 tokens (d_in = 8192, N =
16), a transient of each layer; fusing the expansion into the kernel is
later work.  On the CPU, under ``ops.reference()`` and from a given state,
it is the reference's chunked scan: an associative scan inside chunks of
``cfg.ssm.chunk`` tokens and a loop carrying the state across chunks, so no
more than one chunk of [B, chunk, d_in, N] exists at a time (one chunk of
the whole sequence when S is not a multiple of the chunk).  Decode with a
state is the one-step update.
"""
from __future__ import annotations

import math

import torch
import torch.nn.functional as F
from torch import nn

from repro_torch.configs import ModelConfig
from repro_torch.kernels import ops
from repro_torch.launch.mesh import P
from repro_torch.models.common import (associative_scan, dense_init,
                                       linear_combine, param_dict, softplus)
from repro_torch.models.rglru import causal_conv1d


def dt_rank_of(cfg: ModelConfig) -> int:
    return cfg.ssm.dt_rank or math.ceil(cfg.d_model / 16)


def init_mamba_block(gen: torch.Generator, cfg: ModelConfig, dtype,
                     device) -> nn.ParameterDict:
    """The reference's init: A = -(1..N) per channel (S4D-real, stored as
    A_log = log(1..N)), dt_bias the inverse softplus of a log-uniform dt in
    [1e-3, 0.1], D = 1; fan-in truncated normals elsewhere.  Random A_log
    would blow the scan up."""
    s, d = cfg.ssm, cfg.d_model
    d_in = s.expand * d
    R, N = dt_rank_of(cfg), s.d_state
    f32 = dict(dtype=torch.float32, device=device)
    A = torch.arange(1, N + 1, **f32)[None, :].repeat(d_in, 1)
    dt = torch.exp(torch.rand((d_in,), generator=gen, **f32)
                   * (math.log(0.1) - math.log(1e-3)) + math.log(1e-3))
    dt_bias = dt + torch.log(-torch.expm1(-dt))      # inverse softplus
    return param_dict(
        in_proj=dense_init(gen, (d, 2 * d_in), d, dtype, device),
        conv_w=dense_init(gen, (s.d_conv, d_in), s.d_conv, dtype, device),
        conv_b=torch.zeros((d_in,), dtype=dtype, device=device),
        x_proj=dense_init(gen, (d_in, R + 2 * N), d_in, dtype, device),
        dt_proj=dense_init(gen, (R, d_in), R, dtype, device),
        dt_bias=dt_bias,
        A_log=torch.log(A),
        D=torch.ones((d_in,), **f32),
        out_proj=dense_init(gen, (d_in, d), d_in, dtype, device))


def specs_mamba_block(cfg: ModelConfig):
    return {
        "in_proj": P("data", "model"),
        "conv_w": P(None, "model"), "conv_b": P("model"),
        "x_proj": P("model", None),
        "dt_proj": P(None, "model"), "dt_bias": P("model"),
        "A_log": P("model", None), "D": P("model"),
        "out_proj": P("model", "data"),
    }


# ---------------------------------------------------------------------------
# selective scan
# ---------------------------------------------------------------------------


def _low_rank(p, cfg: ModelConfig, x: torch.Tensor):
    """dt [B,S,d_in] (f32), B and C [B,S,N] from x [B,S,d_in] (post-conv,
    fp32): the x_proj and dt_proj products, in x's dtype."""
    N = cfg.ssm.d_state
    R = dt_rank_of(cfg)
    dbc = x @ p["x_proj"].to(x.dtype)                     # [B,S,R+2N]
    dt_raw, Bc, Cc = torch.split(dbc, [R, N, N], dim=-1)
    dt = softplus((dt_raw @ p["dt_proj"].to(x.dtype)).float()
                  + p["dt_bias"])                          # [B,S,d_in]
    return dt, Bc, Cc


def ssm_coeffs(p, cfg: ModelConfig, x: torch.Tensor):
    """x [B,S,d_in] (post-conv, fp32) -> decay a [B,S,d_in,N], drive b
    [.,N], readout C [B,S,N]."""
    dt, Bc, Cc = _low_rank(p, cfg, x)
    A = -torch.exp(p["A_log"])                            # [d_in, N]
    a = torch.exp(dt[..., None] * A[None, None])          # [B,S,d_in,N]
    b = (dt[..., None] * Bc.float()[:, :, None, :]
         * x.float()[..., None])                          # [B,S,d_in,N]
    return a, b, Cc.float()


def _chunk_len(S: int, chunk: int) -> int:
    """The reference's chunking: ``chunk`` tokens, or the whole sequence
    when S is not a multiple of it."""
    chunk = min(chunk, S)
    return chunk if S % chunk == 0 else S


def _scan_chunk(a_i, b_i, C_i, h):
    """One chunk of the plain scan from state h: (y_i [B,c,d], h_last).
    ``b_i`` is updated in place."""
    b_i[:, 0] += a_i[:, 0] * h
    _, hh = associative_scan(linear_combine, [a_i, b_i], dim=1)
    return torch.einsum("bsdn,bsn->bsd", hh, C_i), hh[:, -1].clone()


def selective_scan_fused(p, cfg: ModelConfig, x: torch.Tensor, h0=None):
    """x [B, S, d_in] (post-conv, fp32) -> (y [B, S, d_in], h_last
    [B, d_in, N]).

    From a zero state on a CUDA tensor (outside ``ops.reference()``):
    ``ssm_coeffs`` over the whole sequence, then the CUDA kernel.
    Otherwise the reference's chunked scan: the low-rank products over the
    full sequence, the [chunk, d_in, N] decay/drive expansion and an
    associative scan per chunk, the state carried from chunk to chunk.
    """
    if h0 is None and ops.takes_kernel(x):
        a, b, C = ssm_coeffs(p, cfg, x)
        # C is a column slice of the x_proj product; the kernel reads it
        # as whole rows
        return ops.mamba_scan_with_state(a, b, C.contiguous())
    Bb, S, d_in = x.shape
    chunk = _chunk_len(S, cfg.ssm.chunk)
    h = h0 if h0 is not None else torch.zeros(
        (Bb, d_in, cfg.ssm.d_state), dtype=torch.float32, device=x.device)
    dt, Bc, Cc = _low_rank(p, cfg, x)
    A = -torch.exp(p["A_log"])                            # [d_in, N]
    Bc, Cc = Bc.float(), Cc.float()
    ys = []
    for c0 in range(0, S, chunk):
        sl = slice(c0, c0 + chunk)
        dt_i = dt[:, sl]
        a_i = torch.exp(dt_i[..., None] * A[None, None])  # [B,c,d,N]
        b_i = dt_i[..., None] * Bc[:, sl, None, :] \
            * x[:, sl].float()[..., None]
        y_i, h = _scan_chunk(a_i, b_i, Cc[:, sl], h)
        ys.append(y_i)
    return torch.cat(ys, dim=1), h


def selective_scan_ref(a: torch.Tensor, b: torch.Tensor, C: torch.Tensor,
                       h0=None, chunk: int = 64):
    """Chunked scan. a,b [B,S,d,N]; C [B,S,N]; h0 [B,d,N].

    Returns y [B,S,d] = C_t · h_t and final state h_last [B,d,N].
    """
    Bb, S, d, N = a.shape
    h = h0 if h0 is not None else torch.zeros(
        (Bb, d, N), dtype=torch.float32, device=a.device)
    chunk = _chunk_len(S, chunk)
    ys = []
    for c0 in range(0, S, chunk):
        sl = slice(c0, c0 + chunk)
        y_i, h = _scan_chunk(a[:, sl], b[:, sl].clone(), C[:, sl], h)
        ys.append(y_i)
    return torch.cat(ys, dim=1), h


def selective_scan_step(a, b, C, h):
    """Decode: a,b [B,d,N]; C [B,N]; h [B,d,N] -> (y [B,d], h')."""
    h = a * h + b
    y = torch.einsum("bdn,bn->bd", h, C)
    return y, h


def apply_mamba_block(p, cfg: ModelConfig, u: torch.Tensor, *,
                      conv_state=None, h_state=None, return_state=False):
    """u [B,S,d] -> y [B,S,d] (+ conv/ssm states when return_state)."""
    cd = u.dtype
    xz = u @ p["in_proj"].to(cd)
    x, z = torch.chunk(xz, 2, dim=-1)
    x, new_conv = causal_conv1d(x, p["conv_w"], p["conv_b"], conv_state)
    x = F.silu(x.float())
    if u.shape[1] == 1 and h_state is not None:        # decode fast path
        a, b, C = ssm_coeffs(p, cfg, x)
        y1, h_last = selective_scan_step(a[:, 0], b[:, 0], C[:, 0], h_state)
        y = y1[:, None, :]
    else:
        y, h_last = selective_scan_fused(p, cfg, x, h0=h_state)
    y = y + p["D"] * x
    y = (y * F.silu(z.float())).to(cd)
    out = y @ p["out_proj"].to(cd)
    if return_state:
        return out, new_conv, h_last
    return out
