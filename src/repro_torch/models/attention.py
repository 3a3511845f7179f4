"""Attention: GQA with qk-norm / bias / sliding window; port of
``repro/models/attention.py``.

Two execution paths, as in the reference:

* ``chunked_attention`` (train / prefill): on a CUDA tensor it launches the
  hand-written flash-attention kernel (``kernels/csrc/flash_attention.cu``)
  at every length, since the kernel masks its ragged edge; the Pallas
  condition "length % 128 == 0" existed only for the TPU's tiling.  On the
  CPU, and under ``ops.reference()``, it is the reference's chunked plain
  path: a loop over q chunks of ``chunk`` rows with full-row f32 softmax.
* ``decode_attention_ref`` (one new token against a KV cache): on a CUDA
  tensor the decode kernel (``kernels/csrc/decode_attention.cu``), else
  the exact row softmax.

The kernels assume the standard layout (positions ``arange`` from 0 for
both q and k); ``standard_layout=False`` keeps any other layout on the
plain path, as in the reference.  Under M-RoPE the plain path masks by the
temporal row ``positions[0]`` and the kernel by index, as the reference's
Pallas path does: a prompt whose temporal row is not an arange attends
differently on the two paths (ROADMAP.md, reference-side caveats).
"""
from __future__ import annotations

import math
from typing import Union

import torch
from torch import nn

from repro_torch.configs import ModelConfig
from repro_torch.kernels import ops
from repro_torch.launch.mesh import P
from repro_torch.models.common import (apply_rope, dense_init, param_dict,
                                       rms_head_norm, rope_angles)

NEG_INF = -1e30


# ---------------------------------------------------------------------------
# parameters
# ---------------------------------------------------------------------------


def init_attention(gen: torch.Generator, cfg: ModelConfig, dtype,
                   device) -> nn.ParameterDict:
    d, hd = cfg.d_model, cfg.head_dim_
    Hq, Hkv = cfg.num_heads, cfg.num_kv_heads
    p = {"wq": dense_init(gen, (d, Hq, hd), d, dtype, device),
         "wk": dense_init(gen, (d, Hkv, hd), d, dtype, device),
         "wv": dense_init(gen, (d, Hkv, hd), d, dtype, device),
         "wo": dense_init(gen, (Hq, hd, d), Hq * hd, dtype, device)}
    zeros = dict(dtype=dtype, device=device)
    if cfg.qkv_bias:
        p["bq"] = torch.zeros((Hq, hd), **zeros)
        p["bk"] = torch.zeros((Hkv, hd), **zeros)
        p["bv"] = torch.zeros((Hkv, hd), **zeros)
    if cfg.attn_out_bias:
        p["bo"] = torch.zeros((d,), **zeros)
    if cfg.qk_norm:
        p["q_norm"] = torch.ones((hd,), **zeros)
        p["k_norm"] = torch.ones((hd,), **zeros)
    return param_dict(**p)


def specs_attention(cfg: ModelConfig):
    # q heads sharded over 'model'; kv heads are few (1..16), so they are
    # replicated over 'model'; all weights FSDP over 'data'.
    s = {"wq": P("data", "model", None), "wk": P("data", None, None),
         "wv": P("data", None, None), "wo": P("model", None, "data")}
    if cfg.qkv_bias:
        s.update({"bq": P("model", None), "bk": P(None, None),
                  "bv": P(None, None)})
    if cfg.attn_out_bias:
        s["bo"] = P(None)
    if cfg.qk_norm:
        s.update({"q_norm": P(None), "k_norm": P(None)})
    return s


# ---------------------------------------------------------------------------
# projections
# ---------------------------------------------------------------------------


def _heads(x: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
    """einsum("bsd,dhk->bshk") as one matmul."""
    d, H, hd = w.shape
    return (x @ w.to(x.dtype).reshape(d, H * hd)).reshape(
        *x.shape[:-1], H, hd)


def qkv_project(p, cfg: ModelConfig, x: torch.Tensor,
                positions: torch.Tensor, *, rope: bool = True):
    """x [B,S,d] -> q [B,S,Hq,hd], k,v [B,S,Hkv,hd] (rope applied;
    positions [B,S], or [R,B,S] under M-RoPE)."""
    cd = x.dtype
    q, k, v = _heads(x, p["wq"]), _heads(x, p["wk"]), _heads(x, p["wv"])
    if cfg.qkv_bias:
        q = q + p["bq"].to(cd)
        k = k + p["bk"].to(cd)
        v = v + p["bv"].to(cd)
    if cfg.qk_norm:
        q = rms_head_norm(p["q_norm"], q)
        k = rms_head_norm(p["k_norm"], k)
    if rope:
        cos, sin = rope_angles(positions, cfg.head_dim_, cfg.rope_theta,
                               cfg.mrope_sections)
        q = apply_rope(q, cos, sin)
        k = apply_rope(k, cos, sin)
    return q, k, v


def out_project(p, cfg: ModelConfig, o: torch.Tensor,
                reduce=None) -> torch.Tensor:
    """einsum("bshk,hkd->bsd") as one matmul.  Under tensor parallelism
    ``o`` holds this rank's heads and ``reduce`` sums the partial products
    over the ranks, before the bias."""
    H, hd, d = p["wo"].shape
    y = o.reshape(*o.shape[:-2], H * hd) @ p["wo"].to(o.dtype).reshape(
        H * hd, d)
    if reduce is not None:
        y = reduce(y)
    if cfg.attn_out_bias:
        y = y + p["bo"].to(o.dtype)
    return y


# ---------------------------------------------------------------------------
# chunked attention (train / prefill)
# ---------------------------------------------------------------------------


def _mask_bias(q_pos, k_pos, causal: bool, window: int) -> torch.Tensor:
    """[..., Cq, Sk] additive f32 bias from causal/window constraints."""
    diff = q_pos[..., :, None] - k_pos[..., None, :]
    keep = torch.ones_like(diff, dtype=torch.bool)
    if causal:
        keep &= diff >= 0
    if window and window > 0:
        keep &= diff < window
    return torch.where(keep, 0.0, NEG_INF)


def chunked_attention(q, k, v, *, q_positions, k_positions, causal=True,
                      window: int = 0, chunk: int = 1024,
                      standard_layout: bool = True) -> torch.Tensor:
    """q [B,Sq,Hq,hd], k/v [B,Sk,Hkv,hd] -> [B,Sq,Hq,hd].

    A CUDA tensor in the standard layout goes to the flash-attention kernel
    (outside ``ops.reference()``); otherwise a loop over q chunks with
    per-chunk full-row scores and an f32 softmax (the reference's
    ``lax.scan`` over chunks).
    """
    if standard_layout and ops.takes_kernel(q):
        return ops.flash_attention(q, k, v, causal=causal, window=window)
    B, Sq, Hq, hd = q.shape
    Hkv = k.shape[2]
    G = Hq // Hkv
    scale = 1.0 / math.sqrt(hd)

    chunk = min(chunk, Sq)
    if Sq % chunk != 0:   # smoke-sized inputs: single chunk
        chunk = Sq
    outs = []
    for c0 in range(0, Sq, chunk):
        qc = q[:, c0:c0 + chunk].reshape(B, chunk, Hkv, G, hd)
        qp = q_positions[:, c0:c0 + chunk]
        s = torch.einsum("bckgd,bskd->bkgcs", qc, k).float() * scale
        s = s + _mask_bias(qp[:, None, None, :],
                           k_positions[:, None, None, :], causal, window)
        m = s.amax(dim=-1, keepdim=True).detach()   # stop_gradient, as there
        e = torch.exp(s - m)
        z = e.sum(dim=-1, keepdim=True)
        pattn = (e / z).to(v.dtype)
        o = torch.einsum("bkgcs,bskd->bckgd", pattn, v)
        outs.append(o.reshape(B, chunk, Hq, hd))
    return torch.cat(outs, dim=1)


# ---------------------------------------------------------------------------
# decode attention (single new token vs. KV cache)
# ---------------------------------------------------------------------------


def decode_attention_ref(q, k_cache, v_cache, *,
                         q_position: Union[torch.Tensor, int], k_positions,
                         window: int = 0,
                         standard_layout: bool = True) -> torch.Tensor:
    """q [B,1,Hq,hd]; caches [B,S,Hkv,hd]; attend to k_pos <= q_pos.

    ``q_position`` is an int tensor [B] or one Python int for every row.
    A CUDA tensor in the standard layout goes to the decode kernel with
    ``q[:, 0]`` and the scalar ``q_position[0]`` (outside
    ``ops.reference()``); reading that scalar from a tensor synchronises
    with the card, which a Python int avoids.  Otherwise the exact row
    softmax (ring-buffer slots with k_pos < 0 are masked there).
    """
    if standard_layout and ops.takes_kernel(q):
        pos = q_position if isinstance(q_position, int) \
            else int(q_position[0].item())
        o = ops.decode_attention(q[:, 0], k_cache, v_cache, pos,
                                 window=window)
        return o[:, None]
    B, _, Hq, hd = q.shape
    Hkv = k_cache.shape[2]
    G = Hq // Hkv
    scale = 1.0 / math.sqrt(hd)
    if isinstance(q_position, int):
        q_position = torch.full((B,), q_position, dtype=torch.int32,
                                device=q.device)
    qg = q.reshape(B, Hkv, G, hd)
    s = torch.einsum("bkgd,bskd->bkgs", qg, k_cache).float() * scale
    diff = q_position[:, None] - k_positions                 # [B,S]
    keep = (diff >= 0) & (k_positions >= 0)
    if window and window > 0:
        keep &= diff < window
    s = s + torch.where(keep, 0.0, NEG_INF)[:, None, None, :]
    p = torch.softmax(s, dim=-1).to(v_cache.dtype)
    o = torch.einsum("bkgs,bskd->bkgd", p, v_cache)
    return o.reshape(B, 1, Hq, hd)
