"""Decoder-only transformer LM, the dense, moe and vlm families; port of
``repro/models/transformer.py``.

The parameters are an ``LM`` module: the embedding, an ``nn.ModuleList`` of
layers (each an ``nn.ModuleDict`` of ``ln1``, ``attn``, ``ln2`` and ``mlp``,
or ``moe`` for the moe family, parameter dicts in the JAX layout) and the
final norm.  The vlm family takes precomputed ``embeds`` in place of
tokens (the stubbed vision frontend) and M-RoPE positions ``[R, B, S]``;
train and prefill return the moe family's aux loss and drop fraction,
each a mean over the layers run.  A split-computing
stage is a slice of that list (``common.slice_layers``), where the JAX
package slices its stacked ``[L, ...]`` leaves.  A Python loop over the
layers replaces ``lax.scan``.  Remat, sharding hints and the ``mesh``
argument have no counterpart on one card and are dropped.  Every weight is
cast to the compute dtype at its use (``.to(x.dtype)``, the reference's
``.astype(cd)``); with ``cfg.cast_weights_bf16`` set, ``cast_weights``
casts the large ones once beforehand, as the reference does, so those uses
find the compute dtype and cast nothing.

Decode writes the new token's k/v into the cache at ``pos`` in place (slice
assignment, where JAX returns a new array from ``dynamic_update_slice``), so
``decode_step`` returns the same cache tensors it was given, updated.
"""
from __future__ import annotations

from typing import Dict, List, Optional, Tuple

import torch
from torch import nn

from repro_torch.configs import ModelConfig
from repro_torch.models import attention as attn
from repro_torch.models import mlp as mlp_mod
from repro_torch.models import moe as moe_mod
from repro_torch.models.common import (apply_norm, dt, embed_init,
                                       init_norm)


def _frozen(t: torch.Tensor) -> nn.Parameter:
    if isinstance(t, nn.Parameter) and not t.requires_grad:
        return t                                   # shared, not rewrapped
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


DECODER_FAMILIES = ("dense", "moe", "vlm")


def _check_family(cfg: ModelConfig) -> None:
    if cfg.family not in DECODER_FAMILIES:
        raise NotImplementedError(
            f"the port's transformer runs the {DECODER_FAMILIES} families, "
            f"not {cfg.family!r}")


# ---------------------------------------------------------------------------
# init
# ---------------------------------------------------------------------------


def init_layer(gen: torch.Generator, cfg: ModelConfig, dtype,
               device) -> nn.ModuleDict:
    layer = {"ln1": init_norm(cfg.d_model, cfg.norm, dtype, device),
             "attn": attn.init_attention(gen, cfg, dtype, device),
             "ln2": init_norm(cfg.d_model, cfg.norm, dtype, device)}
    if cfg.family == "moe":
        layer["moe"] = moe_mod.init_moe(gen, cfg, dtype, device)
    else:
        layer["mlp"] = mlp_mod.init_mlp(gen, cfg, dtype, device)
    return nn.ModuleDict(layer)


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
# the cast_weights_bf16 lever
# ---------------------------------------------------------------------------

CAST_MIN_SIZE = 1_000_000


def _stack_depths(cfg: ModelConfig) -> List[int]:
    """For each of the L layers, the length of the reference's stacked
    leaf that holds it: L for the dense and ssm ``layers``; for the hybrid,
    ``n_super`` for a superblock sub-layer and the tail count for a tail
    layer (``hybrid._pattern``)."""
    L = cfg.num_layers
    if cfg.family != "hybrid":
        return [L] * L
    n_super, tail = divmod(L, len(cfg.hybrid.pattern))
    return [n_super] * (L - tail) + [tail] * tail


def _casts(x: torch.Tensor, depth: int = 0) -> bool:
    """Whether the reference's ``cast_weights`` casts the leaf that holds
    ``x``: a floating leaf of ndim >= 2 and >= 1M elements.  ``depth`` is
    the stack length of a layer leaf (0 for the embedding, head and final
    norm), whose reference leaf is ``[depth, *x.shape]``."""
    ndim = x.dim() + (1 if depth else 0)
    size = x.numel() * max(depth, 1)
    return x.is_floating_point() and ndim >= 2 and size >= CAST_MIN_SIZE


def _named_leaves(params: LM, cfg: ModelConfig
                  ) -> List[Tuple[str, torch.Tensor, int]]:
    """(name, leaf, stack depth) of every parameter of ``params``."""
    depths = _stack_depths(cfg)
    out = []
    for name, x in params.named_parameters():
        depth = depths[int(name.split(".")[1])] if name.startswith(
            "layers.") else 0
        out.append((name, x, depth))
    return out


def cast_weights(params: LM, cfg: ModelConfig) -> LM:
    """The reference's ``cast_weights``: with ``cfg.cast_weights_bf16``,
    every leaf that ``_casts`` cast to the compute dtype, the others shared
    with ``params``.  Returns ``params`` itself when the lever is off or
    every such leaf already has the compute dtype (so a second call costs
    no launch)."""
    if not cfg.cast_weights_bf16:
        return params
    cd = dt(cfg.compute_dtype)
    todo = {name for name, x, depth in _named_leaves(params, cfg)
            if _casts(x, depth) and x.dtype != cd}
    if not todo:
        return params

    def rebuild(mod: nn.Module, prefix: str) -> nn.Module:
        if isinstance(mod, nn.ParameterDict):
            return nn.ParameterDict({
                k: _frozen(v.to(cd)) if f"{prefix}{k}" in todo else v
                for k, v in mod.items()})
        return nn.ModuleDict({k: rebuild(v, f"{prefix}{k}.")
                              for k, v in mod.items()})

    def leaf(name: str, x):
        return None if x is None else (
            _frozen(x.to(cd)) if name in todo else x)

    layers = [rebuild(lp, f"layers.{i}.")
              for i, lp in enumerate(params.layers)]
    return LM(params.cfg, leaf("embed", params.embed), layers,
              rebuild(params.final_norm, "final_norm."),
              leaf("lm_head", params.lm_head))


# ---------------------------------------------------------------------------
# forward
# ---------------------------------------------------------------------------


def embed_in(params: LM, cfg: ModelConfig, batch: Dict):
    """Token / precomputed-embedding input. Returns (h [B,S,d], positions
    [B,S] int32, or [R,B,S] under M-RoPE)."""
    cd = dt(cfg.compute_dtype)
    if "embeds" in batch:                      # vlm stub frontend
        h = batch["embeds"].to(cd)
    else:
        h = params.embed[batch["tokens"]].to(cd)
    B, S = h.shape[:2]
    if "positions" in batch:
        positions = batch["positions"]
    else:
        positions = torch.arange(S, dtype=torch.int32,
                                 device=h.device)[None, :].expand(B, S)
        if cfg.mrope_sections:
            positions = positions[None].expand(len(cfg.mrope_sections), B,
                                               S)
    return h, positions


def head_out(params: LM, cfg: ModelConfig, h: torch.Tensor) -> torch.Tensor:
    h = apply_norm(params.final_norm, h, cfg.norm)
    if cfg.tie_embeddings:
        return h @ params.embed.to(h.dtype).T
    return h @ params.lm_head.to(h.dtype)


def _layer_apply(lp, cfg: ModelConfig, h, positions, *, mode,
                 cache_kv=None, pos_scalar: Optional[int] = None):
    """One transformer layer. mode: train|prefill|decode.

    Returns (h, new_cache_kv_or_None, aux); in decode mode the cache
    tensors given are updated in place at ``pos_scalar`` and returned.
    ``aux`` is the MoE block's dict, empty for the other families."""
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
        qpos = positions if positions.dim() == 2 else positions[0]
        o = attn.chunked_attention(q, k, v, q_positions=qpos,
                                   k_positions=qpos, causal=True,
                                   chunk=cfg.attn_chunk)
        if mode == "prefill":
            new_cache = (k, v)
    h = h + attn.out_project(lp["attn"], cfg, o)
    m_in = apply_norm(lp["ln2"], h, cfg.norm)
    if "moe" in lp:
        y, aux = moe_mod.apply_moe(lp["moe"], cfg, m_in)
        return h + y, new_cache, aux
    return h + mlp_mod.apply_mlp(lp["mlp"], cfg, m_in), new_cache, {}


def run_layers(layers, cfg: ModelConfig, h, positions, *, mode="train",
               caches=None, pos_scalar: Optional[int] = None):
    """Loop over layers (any slice of ``LM.layers``).

    train:   returns (h, None, aux)
    prefill: returns (h, {'k': [L,B,S,Hkv,hd], 'v': ...}, aux)
    decode:  caches = {'k': [L,...], 'v': [L,...]}, updated in place at
             ``pos_scalar``; returns (h, caches, {})
    ``aux`` is the reference's MoE dict, each entry the mean over the
    layers run (``{"moe_aux", "moe_dropped"}``); empty for the families
    without MoE layers.
    """
    if mode == "decode":
        for i, lp in enumerate(layers):
            h = _layer_apply(lp, cfg, h, positions, mode=mode,
                             cache_kv=(caches["k"][i], caches["v"][i]),
                             pos_scalar=pos_scalar)[0]
        return h, caches, {}
    ks, vs, auxes = [], [], []
    for lp in layers:
        h, kv, aux = _layer_apply(lp, cfg, h, positions, mode=mode)
        if aux:
            auxes.append(aux)
        if mode == "prefill":
            ks.append(kv[0])
            vs.append(kv[1])
    aux = {name: torch.stack([a[name] for a in auxes]).mean()
           for name in ("moe_aux", "moe_dropped")} if auxes else {}
    if mode == "prefill":
        return h, {"k": torch.stack(ks), "v": torch.stack(vs)}, aux
    return h, None, aux


# ---------------------------------------------------------------------------
# top-level model functions
# ---------------------------------------------------------------------------


def forward(params: LM, cfg: ModelConfig, batch: Dict, *, mode="train"):
    _check_family(cfg)
    params = cast_weights(params, cfg)
    h, positions = embed_in(params, cfg, batch)
    h, caches, aux = run_layers(params.layers, cfg, h, positions, mode=mode)
    return head_out(params, cfg, h), caches, aux


def prefill(params: LM, cfg: ModelConfig, batch: Dict):
    logits, caches, _ = forward(params, cfg, batch, mode="prefill")
    # only the last-position logits are needed to start decoding
    return logits[:, -1], caches


def decode_step(params: LM, cfg: ModelConfig, caches, batch: Dict):
    """batch: {'token': [B,1] int} or {'embeds': [B,1,d]}, and 'pos': int
    (under M-RoPE every section's position).  A 0-d tensor ``pos`` is
    read with ``.item()``, which synchronises with the card; pass a Python
    int to avoid that.  The caches are updated in place.  As in the
    reference, decode does not call ``cast_weights``: it reads the leaves
    it is given (cast once by the caller, ``Model.cast_weights``)."""
    _check_family(cfg)
    pos = batch["pos"]
    pos = int(pos.item()) if torch.is_tensor(pos) else int(pos)
    cd = dt(cfg.compute_dtype)
    if "embeds" in batch:
        h = batch["embeds"].to(cd)
    else:
        h = params.embed[batch["token"]].to(cd)
    B = h.shape[0]
    positions = torch.full((B, 1), pos, dtype=torch.int32, device=h.device)
    if cfg.mrope_sections:
        positions = positions[None].expand(len(cfg.mrope_sections), B, 1)
    h, caches, _ = run_layers(params.layers, cfg, h, positions,
                              mode="decode", caches=caches, pos_scalar=pos)
    return head_out(params, cfg, h)[:, 0], caches


def init_cache(cfg: ModelConfig, batch: int, seq_len: int, device):
    shape = (cfg.num_layers, batch, seq_len, cfg.num_kv_heads,
             cfg.head_dim_)
    cd = dt(cfg.compute_dtype)
    return {"k": torch.zeros(shape, dtype=cd, device=device),
            "v": torch.zeros(shape, dtype=cd, device=device)}
