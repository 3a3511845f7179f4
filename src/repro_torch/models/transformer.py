"""Decoder-only transformer LM, dense family; port of
``repro/models/transformer.py``.

The parameters are an ``LM`` module: the embedding, an ``nn.ModuleList`` of
layers (each an ``nn.ModuleDict`` of ``ln1``, ``attn``, ``ln2``, ``mlp``
parameter dicts in the JAX layout) and the final norm.  A split-computing
stage is a slice of that list (``common.slice_layers``), where the JAX
package slices its stacked ``[L, ...]`` leaves.  A Python loop over the
layers replaces ``lax.scan``.  Remat, sharding hints and the ``mesh``
argument have no counterpart on one card and are dropped;
``cast_weights_bf16`` (the reference's pre-cast of large weights) is not
ported yet, so every weight is cast from its f32 master to the compute dtype
at each use, as the reference does with the lever off.

Decode writes the new token's k/v into the cache at ``pos`` in place (slice
assignment, where JAX returns a new array from ``dynamic_update_slice``), so
``decode_step`` returns the same cache tensors it was given, updated.
"""
from __future__ import annotations

from typing import Dict, List, Optional

import torch
from torch import nn

from repro_torch.configs import ModelConfig
from repro_torch.models import attention as attn
from repro_torch.models import mlp as mlp_mod
from repro_torch.models.common import (apply_norm, dt, embed_init,
                                       init_norm)


def _frozen(t: torch.Tensor) -> nn.Parameter:
    return nn.Parameter(t, requires_grad=False)


class LM(nn.Module):
    """Parameters of a decoder-only LM in the JAX package's layout:
    ``embed [V, d]``, ``layers[i]["attn"]["wq"] [d, Hq, hd]``, ...,
    ``final_norm``, and ``lm_head [d, V]`` unless embeddings are tied.  The
    ssm and hybrid families keep their layers in it too (``ssm_lm``,
    ``hybrid``)."""

    def __init__(self, cfg: ModelConfig, embed: torch.Tensor,
                 layers: List[nn.ModuleDict], final_norm: nn.ParameterDict,
                 lm_head: Optional[torch.Tensor] = None):
        super().__init__()
        self.cfg = cfg
        self.embed = _frozen(embed)
        self.layers = nn.ModuleList(layers)
        self.final_norm = final_norm
        self.lm_head = None if lm_head is None else _frozen(lm_head)


def _check_family(cfg: ModelConfig) -> None:
    if cfg.family != "dense":
        raise NotImplementedError(
            f"the {cfg.family!r} family is not ported yet (ROADMAP.md); the "
            f"port's transformer runs the dense family")
    if cfg.mrope_sections:
        raise NotImplementedError("M-RoPE comes with the vlm family")


# ---------------------------------------------------------------------------
# init
# ---------------------------------------------------------------------------


def init_layer(gen: torch.Generator, cfg: ModelConfig, dtype,
               device) -> nn.ModuleDict:
    return nn.ModuleDict({
        "ln1": init_norm(cfg.d_model, cfg.norm, dtype, device),
        "attn": attn.init_attention(gen, cfg, dtype, device),
        "ln2": init_norm(cfg.d_model, cfg.norm, dtype, device),
        "mlp": mlp_mod.init_mlp(gen, cfg, dtype, device)})


def init_lm(gen: torch.Generator, cfg: ModelConfig, device) -> LM:
    """Random parameters from ``gen`` (a generator on ``device``), with the
    reference's distributions; the draws themselves differ from
    ``jax.random``'s, so tests bridge the reference's init instead."""
    _check_family(cfg)
    dtype = dt(cfg.param_dtype)
    embed = embed_init(gen, (cfg.vocab_size, cfg.d_model), dtype, device)
    layers = [init_layer(gen, cfg, dtype, device)
              for _ in range(cfg.num_layers)]
    final_norm = init_norm(cfg.d_model, cfg.norm, dtype, device)
    lm_head = None if cfg.tie_embeddings else embed_init(
        gen, (cfg.d_model, cfg.vocab_size), dtype, device)
    return LM(cfg, embed, layers, final_norm, lm_head)


# ---------------------------------------------------------------------------
# forward
# ---------------------------------------------------------------------------


def embed_in(params: LM, cfg: ModelConfig, batch: Dict):
    """Token / precomputed-embedding input. Returns (h [B,S,d], positions
    [B,S] int32)."""
    cd = dt(cfg.compute_dtype)
    if "embeds" in batch:
        h = batch["embeds"].to(cd)
    else:
        h = params.embed[batch["tokens"]].to(cd)
    B, S = h.shape[:2]
    if "positions" in batch:
        positions = batch["positions"]
    else:
        positions = torch.arange(S, dtype=torch.int32,
                                 device=h.device)[None, :].expand(B, S)
    return h, positions


def head_out(params: LM, cfg: ModelConfig, h: torch.Tensor) -> torch.Tensor:
    h = apply_norm(params.final_norm, h, cfg.norm)
    if cfg.tie_embeddings:
        return h @ params.embed.to(h.dtype).T
    return h @ params.lm_head.to(h.dtype)


def _layer_apply(lp, cfg: ModelConfig, h, positions, *, mode,
                 cache_kv=None, pos_scalar: Optional[int] = None):
    """One transformer layer. mode: train|prefill|decode.

    Returns (h, new_cache_kv_or_None); in decode mode the cache tensors
    given are updated in place at ``pos_scalar`` and returned."""
    a_in = apply_norm(lp["ln1"], h, cfg.norm)
    q, k, v = attn.qkv_project(lp["attn"], cfg, a_in, positions)
    new_cache = None
    if mode == "decode":
        ck, cv = cache_kv                                  # [B,Skv,Hkv,hd]
        ck[:, pos_scalar] = k[:, 0].to(ck.dtype)
        cv[:, pos_scalar] = v[:, 0].to(cv.dtype)
        B, Skv = ck.shape[:2]
        k_positions = torch.arange(Skv, dtype=torch.int32,
                                   device=ck.device)[None, :].expand(B, Skv)
        o = attn.decode_attention_ref(q, ck, cv, q_position=pos_scalar,
                                      k_positions=k_positions)
        new_cache = (ck, cv)
    else:
        o = attn.chunked_attention(q, k, v, q_positions=positions,
                                   k_positions=positions, causal=True,
                                   chunk=cfg.attn_chunk)
        if mode == "prefill":
            new_cache = (k, v)
    h = h + attn.out_project(lp["attn"], cfg, o)
    m_in = apply_norm(lp["ln2"], h, cfg.norm)
    return h + mlp_mod.apply_mlp(lp["mlp"], cfg, m_in), new_cache


def run_layers(layers, cfg: ModelConfig, h, positions, *, mode="train",
               caches=None, pos_scalar: Optional[int] = None):
    """Loop over layers (any slice of ``LM.layers``).

    train:   returns (h, None, {})
    prefill: returns (h, {'k': [L,B,S,Hkv,hd], 'v': ...}, {})
    decode:  caches = {'k': [L,...], 'v': [L,...]}, updated in place at
             ``pos_scalar``; returns (h, caches, {})
    The third item is the reference's MoE aux dict, empty for dense.
    """
    if mode == "decode":
        for i, lp in enumerate(layers):
            h, _ = _layer_apply(lp, cfg, h, positions, mode=mode,
                                cache_kv=(caches["k"][i], caches["v"][i]),
                                pos_scalar=pos_scalar)
        return h, caches, {}
    ks, vs = [], []
    for lp in layers:
        h, kv = _layer_apply(lp, cfg, h, positions, mode=mode)
        if mode == "prefill":
            ks.append(kv[0])
            vs.append(kv[1])
    if mode == "prefill":
        return h, {"k": torch.stack(ks), "v": torch.stack(vs)}, {}
    return h, None, {}


# ---------------------------------------------------------------------------
# top-level model functions
# ---------------------------------------------------------------------------


def forward(params: LM, cfg: ModelConfig, batch: Dict, *, mode="train"):
    _check_family(cfg)
    if cfg.cast_weights_bf16:
        raise NotImplementedError("cast_weights_bf16 is not ported yet "
                                  "(ROADMAP.md)")
    h, positions = embed_in(params, cfg, batch)
    h, caches, aux = run_layers(params.layers, cfg, h, positions, mode=mode)
    return head_out(params, cfg, h), caches, aux


def prefill(params: LM, cfg: ModelConfig, batch: Dict):
    logits, caches, _ = forward(params, cfg, batch, mode="prefill")
    # only the last-position logits are needed to start decoding
    return logits[:, -1], caches


def decode_step(params: LM, cfg: ModelConfig, caches, batch: Dict):
    """batch: {'token': [B,1] int, 'pos': int}.  A 0-d tensor ``pos`` is
    read with ``.item()``, which synchronises with the card; pass a Python
    int to avoid that.  The caches are updated in place."""
    _check_family(cfg)
    pos = batch["pos"]
    pos = int(pos.item()) if torch.is_tensor(pos) else int(pos)
    cd = dt(cfg.compute_dtype)
    h = params.embed[batch["token"]].to(cd)
    B = h.shape[0]
    positions = torch.full((B, 1), pos, dtype=torch.int32, device=h.device)
    h, caches, _ = run_layers(params.layers, cfg, h, positions,
                              mode="decode", caches=caches, pos_scalar=pos)
    return head_out(params, cfg, h)[:, 0], caches


def init_cache(cfg: ModelConfig, batch: int, seq_len: int, device):
    shape = (cfg.num_layers, batch, seq_len, cfg.num_kv_heads,
             cfg.head_dim_)
    cd = dt(cfg.compute_dtype)
    return {"k": torch.zeros(shape, dtype=cd, device=device),
            "v": torch.zeros(shape, dtype=cd, device=device)}
