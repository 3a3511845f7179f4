"""The card's published peaks, the model FLOPs behind ``mfu.*`` and the
roofline bounds behind ``*_roofline.*``, from shapes alone.

Peaks: one NVIDIA H100 SXM (NVIDIA's data sheet, dense rates at the full
700 W): 989 TFLOP/s in bf16 on the tensor cores, 3.35 TB/s of HBM3.  The
bound of a kernel launch is the larger of its bytes over the bandwidth
and its operations over the bf16 rate, each input byte read once and each
output byte written once (the formulas of ``chip_smoke.py``'s
``flash_bound_ms`` and ``flash_bwd_bound_ms``, frozen here).

Model FLOPs count the multiply-adds the model needs (two FLOPs each): the
weight products of the layers run, the causal half of attention's two
products, the head; for an MoE layer the router and the top-k experts a
token is routed to (not the capacity slots the program fills).  Training
counts three forward passes (forward, and the two products of each
backward) with no recompute.
"""
from __future__ import annotations

from typing import Dict

HBM_BYTES_PER_S = 3.35e12
BF16_FLOPS_PER_S = 989e12


def roofline_s(nbytes: float, flops: float) -> float:
    return max(nbytes / HBM_BYTES_PER_S, flops / BF16_FLOPS_PER_S)


def _pairs(B: int, S: int, Hq: int, causal: bool) -> int:
    return B * Hq * (S * (S + 1) // 2 if causal else S * S)


def flash_fwd_bound_s(B, S, Hq, Hkv, hd, causal=True, elt=2) -> float:
    """q, k, v read and the output written once; 4·hd FLOPs a kept
    (query, key) pair."""
    nbytes = elt * (2 * B * S * Hq * hd + 2 * B * S * Hkv * hd)
    return roofline_s(nbytes, 4 * hd * _pairs(B, S, Hq, causal))


def flash_bwd_bound_s(B, S, Hq, Hkv, hd, causal=True, elt=2) -> float:
    """q, k, v, o and dO read once, dQ, dK and dV written once; five
    products of 2·hd FLOPs a kept pair (the scores, dP, dV, dQ, dK)."""
    nbytes = elt * (4 * B * S * Hq * hd + 4 * B * S * Hkv * hd)
    return roofline_s(nbytes, 10 * hd * _pairs(B, S, Hq, causal))


def layer_flops(model: Dict, B: int, S: int) -> float:
    """Forward FLOPs of one layer on a [B, S] batch."""
    d, hd = model["hidden_size"], model["head_dim"]
    Hq, Hkv = model["num_attention_heads"], model["num_key_value_heads"]
    T = B * S
    proj = 2 * T * d * hd * (2 * Hq + 2 * Hkv)          # q, k, v, o
    attn = 4 * hd * _pairs(B, S, Hq, True)              # QK^T and PV
    if model.get("num_local_experts"):
        E, k = model["num_local_experts"], model["num_experts_per_tok"]
        ff = model["intermediate_size"]
        ffn = 2 * T * d * E + 2 * T * k * 3 * d * ff     # router, experts
    else:
        ffn = 2 * T * 3 * d * model["intermediate_size"]
    return float(proj + attn + ffn)


def head_flops(model: Dict, B: int, S: int) -> float:
    return float(2 * B * S * model["hidden_size"] * model["vocab_size"])


def forward_flops(model: Dict, B: int, S: int, layers: int) -> float:
    """Forward FLOPs of ``layers`` layers and the head on [B, S]."""
    return layers * layer_flops(model, B, S) + head_flops(model, B, S)


def train_step_flops(model: Dict, B: int, S: int) -> float:
    return 3.0 * forward_flops(model, B, S, model["num_hidden_layers"])
