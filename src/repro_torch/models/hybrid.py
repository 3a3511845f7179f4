"""RecurrentGemma-style hybrid LM: repeating (rec, rec, attn) superblocks;
port of ``repro/models/hybrid.py``.

Every residual layer is  ln1 → mixer → +res → ln2 → MLP → +res  where the
mixer alternates between an RG-LRU recurrent block and *local* (windowed)
attention per ``cfg.hybrid.pattern``.  The JAX package stacks the layers
per superblock (``super`` [n_super, ...]) plus a homogeneous tail (38 =
12×3 + 2 for the 9b config); the port keeps one flat ``nn.ModuleList`` of
the L sublayers, sublayer j of superblock i at 3i + j and tail layer t at
36 + t (``repro_torch.bridge`` maps the two), each an ``nn.ModuleDict`` of
``ln1``, ``mixer``, ``ln2`` and ``mlp``.

The decode cache is one pair per layer: ``(conv_state, h_state)`` for a
recurrent layer, ``(ck, cv)`` ring buffers of ``window`` slots for an
attention layer; ``decode_step`` updates them in place.  Prefill's local
attention goes through ``attention.chunked_attention`` (the flash kernel on
the card, with the window); decode attends over the ring buffer on the
plain path (``standard_layout=False``), as the reference does.
"""
from __future__ import annotations

from typing import Dict, List, Optional, Tuple

import torch
from torch import nn

from repro_torch.configs import ModelConfig
from repro_torch.launch.mesh import P
from repro_torch.models import attention as attn
from repro_torch.models import mlp as mlp_mod
from repro_torch.models import rglru
from repro_torch.models.common import (apply_norm, dt, embed_init,
                                       flat_specs, init_norm, remat,
                                       specs_norm)
from repro_torch.models.transformer import (LM, cast_weights, head_loss,
                                            head_out)

Caches = List[Tuple[torch.Tensor, torch.Tensor]]


def _pattern(cfg: ModelConfig):
    pat = cfg.hybrid.pattern
    L = cfg.num_layers
    n_super, tail = divmod(L, len(pat))
    tail_types = pat[:tail]
    if len(set(tail_types)) > 1:
        raise ValueError("tail layers must share a mixer type")
    return pat, n_super, tail, (tail_types[0] if tail else None)


def layer_kinds(cfg: ModelConfig) -> List[str]:
    """The mixer of each of the L layers, in order ("rec" or "attn")."""
    pat = cfg.hybrid.pattern
    return [pat[i % len(pat)] for i in range(cfg.num_layers)]


def _check(cfg: ModelConfig) -> None:
    if cfg.family != "hybrid":
        raise ValueError(f"hybrid runs the hybrid family, got "
                         f"{cfg.family!r}")
    _pattern(cfg)


# ---------------------------------------------------------------------------
# init
# ---------------------------------------------------------------------------


def _init_sublayer(gen: torch.Generator, cfg: ModelConfig, kind: str,
                   dtype, device) -> nn.ModuleDict:
    mixer = (rglru.init_rec_block(gen, cfg, dtype, device) if kind == "rec"
             else attn.init_attention(gen, cfg, dtype, device))
    return nn.ModuleDict({
        "ln1": init_norm(cfg.d_model, cfg.norm, dtype, device),
        "mixer": mixer,
        "ln2": init_norm(cfg.d_model, cfg.norm, dtype, device),
        "mlp": mlp_mod.init_mlp(gen, cfg, dtype, device)})


def init_hybrid(gen: torch.Generator, cfg: ModelConfig, device) -> LM:
    """Random parameters from ``gen`` (a generator on ``device``) with the
    reference's distributions; tests bridge the reference's init."""
    _check(cfg)
    dtype = dt(cfg.param_dtype)
    embed = embed_init(gen, (cfg.vocab_size, cfg.d_model), dtype, device)
    layers = [_init_sublayer(gen, cfg, kind, dtype, device)
              for kind in layer_kinds(cfg)]
    final_norm = init_norm(cfg.d_model, cfg.norm, dtype, device)
    lm_head = None if cfg.tie_embeddings else embed_init(
        gen, (cfg.d_model, cfg.vocab_size), dtype, device)
    return LM(cfg, embed, layers, final_norm, lm_head)


# ---------------------------------------------------------------------------
# forward
# ---------------------------------------------------------------------------


def _ring_fill(k: torch.Tensor, W: int) -> torch.Tensor:
    """The last min(W, S) rows of k [B,S,...] placed at their slots
    (position mod W) of a zeroed [B,W,...] ring buffer; the slots are
    distinct, so the scatter is deterministic."""
    B, S = k.shape[:2]
    Wc = min(W, S)
    slots = torch.remainder(torch.arange(S - Wc, S, device=k.device), W)
    ring = torch.zeros((B, W) + tuple(k.shape[2:]), dtype=k.dtype,
                       device=k.device)
    ring[:, slots] = k[:, -Wc:]
    return ring


def _apply_sublayer(lp, cfg: ModelConfig, kind: str, h: torch.Tensor,
                    positions: torch.Tensor, *, mode: str, cache=None,
                    pos_scalar: Optional[int] = None):
    """cache (decode): rec -> (conv_state, h_state); attn -> (ck, cv),
    updated in place.  Returns (h, new_cache)."""
    W = cfg.hybrid.window
    x = apply_norm(lp["ln1"], h, cfg.norm)
    new_cache = None
    if kind == "rec":
        if mode == "train":
            y = rglru.apply_rec_block(lp["mixer"], cfg, x)
        else:
            conv_s, h_s = cache if mode == "decode" else (None, None)
            y, conv_new, h_new = rglru.apply_rec_block(
                lp["mixer"], cfg, x, conv_state=conv_s, h_state=h_s,
                return_state=True)
            if mode == "decode":
                conv_s.copy_(conv_new)
                h_s.copy_(h_new)
                new_cache = cache
            else:
                new_cache = (conv_new, h_new)
    else:
        q, k, v = attn.qkv_project(lp["mixer"], cfg, x, positions)
        B = h.shape[0]
        if mode == "decode":
            ck, cv = cache                         # ring buffers [B,W,Hkv,hd]
            slot = pos_scalar % W
            ck[:, slot] = k[:, 0].to(ck.dtype)
            cv[:, slot] = v[:, 0].to(cv.dtype)
            sl = torch.arange(W, dtype=torch.int32, device=h.device)
            k_pos = pos_scalar - torch.remainder(pos_scalar - sl, W)
            o = attn.decode_attention_ref(
                q, ck, cv,
                q_position=torch.full((B,), pos_scalar, dtype=torch.int32,
                                      device=h.device),
                k_positions=k_pos[None, :].expand(B, W), window=W,
                standard_layout=False)
            new_cache = cache
        else:
            o = attn.chunked_attention(q, k, v, q_positions=positions,
                                       k_positions=positions, causal=True,
                                       window=W, chunk=cfg.attn_chunk)
            if mode == "prefill":
                new_cache = (_ring_fill(k, W), _ring_fill(v, W))
        y = attn.out_project(lp["mixer"], cfg, o)
    h = h + y
    m = apply_norm(lp["ln2"], h, cfg.norm)
    h = h + mlp_mod.apply_mlp(lp["mlp"], cfg, m)
    return h, new_cache


def run_layers(layers, cfg: ModelConfig, h: torch.Tensor,
               positions: torch.Tensor, *, mode: str,
               caches: Optional[Caches] = None,
               pos_scalar: Optional[int] = None, start: int = 0):
    """Loop over sublayers (the reference's superblock scan and its tail):
    ``layers`` are layers ``start ..`` of the model (all of them, or a
    stage), ``caches`` theirs.  train: (h, None); prefill: (h, caches);
    decode: ``caches`` updated in place, (h, caches)."""
    kinds = layer_kinds(cfg)[start:start + len(layers)]
    new: Caches = []
    sublayer = remat(_apply_sublayer, cfg.remat_policy) if mode == "train" \
        else _apply_sublayer
    for i, (lp, kind) in enumerate(zip(layers, kinds, strict=True)):
        h, c = sublayer(
            lp, cfg, kind, h, positions, mode=mode,
            cache=caches[i] if mode == "decode" else None,
            pos_scalar=pos_scalar)
        new.append(c)
    if mode == "decode":
        return h, caches
    return h, (new if mode == "prefill" else None)


def forward(params: LM, cfg: ModelConfig, batch: Dict, *, mode="train"):
    _check(cfg)
    params = cast_weights(params, cfg)
    h = params.embed[batch["tokens"]].to(dt(cfg.compute_dtype))
    B, S = h.shape[:2]
    positions = torch.arange(S, dtype=torch.int32,
                             device=h.device)[None, :].expand(B, S)
    h, caches = run_layers(params.layers, cfg, h, positions, mode=mode)
    return head_out(params, cfg, h), caches, {}


def loss_fn(params: LM, cfg: ModelConfig, batch: Dict):
    """(loss, {"loss"}) of a batch of ``tokens`` and ``labels``: the
    reference's ``loss_fn``.  On the card its backward runs the RG-LRU
    scan's and the flash-attention backward kernels."""
    _check(cfg)
    params = cast_weights(params, cfg)
    h = params.embed[batch["tokens"]].to(dt(cfg.compute_dtype))
    B, S = h.shape[:2]
    positions = torch.arange(S, dtype=torch.int32,
                             device=h.device)[None, :].expand(B, S)
    h, _ = run_layers(params.layers, cfg, h, positions, mode="train")
    loss = head_loss(params, cfg, h, batch["labels"])
    return loss, {"loss": loss}


def prefill(params: LM, cfg: ModelConfig, batch: Dict):
    logits, caches, _ = forward(params, cfg, batch, mode="prefill")
    return logits[:, -1], caches


def decode_step(params: LM, cfg: ModelConfig, caches: Caches, batch: Dict):
    """batch: {'token': [B,1] int, 'pos': int}.  A 0-d tensor ``pos`` is
    read with ``.item()``, which synchronises with the card.  The caches
    are updated in place.  As in the reference, decode does not call
    ``cast_weights``; it reads the leaves it is given."""
    _check(cfg)
    pos = batch["pos"]
    pos = int(pos.item()) if torch.is_tensor(pos) else int(pos)
    h = params.embed[batch["token"]].to(dt(cfg.compute_dtype))
    B = h.shape[0]
    positions = torch.full((B, 1), pos, dtype=torch.int32, device=h.device)
    h, caches = run_layers(params.layers, cfg, h, positions, mode="decode",
                           caches=caches, pos_scalar=pos)
    return head_out(params, cfg, h)[:, 0], caches


def _specs_sublayer(cfg: ModelConfig, kind: str):
    mixer = (rglru.specs_rec_block(cfg) if kind == "rec"
             else attn.specs_attention(cfg))
    return {"ln1": specs_norm(cfg.norm), "mixer": mixer,
            "ln2": specs_norm(cfg.norm), "mlp": mlp_mod.specs_mlp(cfg)}


def specs_hybrid(cfg: ModelConfig):
    """{parameter name: spec} (``common.specs_norm``'s doc)."""
    s = {"embed": P("model", "data")}
    for i, kind in enumerate(layer_kinds(cfg)):
        s.update(flat_specs(f"layers.{i}.", _specs_sublayer(cfg, kind)))
    s.update(flat_specs("final_norm.", specs_norm(cfg.norm)))
    if not cfg.tie_embeddings:
        s["lm_head"] = P("data", "model")
    return s


def cache_specs(cfg: ModelConfig):
    """One pair of specs a layer, as ``init_cache`` lays the caches out."""
    def one(kind):
        if kind == "rec":
            return (P("data", None, "model"), P("data", "model"))
        return (P("data", "model", None, None),
                P("data", "model", None, None))

    return [one(kind) for kind in layer_kinds(cfg)]


def init_cache(cfg: ModelConfig, batch: int, seq_len: int,
               device) -> Caches:
    """Decode caches; attention caches are ring buffers of ``window``
    slots, whatever ``seq_len`` is."""
    cd = dt(cfg.compute_dtype)
    w = cfg.hybrid.lru_width or cfg.d_model
    W, cw = cfg.hybrid.window, cfg.hybrid.conv_width

    def one(kind):
        if kind == "rec":
            return (torch.zeros((batch, cw - 1, w), dtype=cd, device=device),
                    torch.zeros((batch, w), dtype=torch.float32,
                                device=device))
        kv = (batch, W, cfg.num_kv_heads, cfg.head_dim_)
        return (torch.zeros(kv, dtype=cd, device=device),
                torch.zeros(kv, dtype=cd, device=device))

    return [one(kind) for kind in layer_kinds(cfg)]
