"""Falcon-Mamba LM: attention-free stack of Mamba-1 blocks; port of
``repro/models/ssm_lm.py``.

Layer = ln → mamba block → +res (mamba1 blocks embed their own expansion;
no separate MLP).  The parameters are a ``transformer.LM`` whose layers are
``nn.ModuleDict``s of ``ln`` and ``mamba`` (the JAX layout of one slice of
the stacked ``layers``).  The decode cache is one ``(conv_state [B,
d_conv-1, d_in], h_state [B, d_in, N] float32)`` pair per layer, where the
JAX package stacks them on a leading [L] axis; ``decode_step`` writes the
new states into those tensors in place and returns the same list.
``loss_fn`` is the reference's; on the card its backward runs the Mamba
scan's backward kernel (``ops.MambaScan``).  ``forward`` and ``loss_fn``
apply the ``cast_weights_bf16`` lever (``transformer.cast_weights``) as the
reference does.
"""
from __future__ import annotations

from typing import Dict, List, Optional, Tuple

import torch
from torch import nn

from repro_torch.configs import ModelConfig
from repro_torch.launch.mesh import P
from repro_torch.models import mamba as mamba_mod
from repro_torch.models.common import (apply_norm, dt, embed_init,
                                       flat_specs, init_norm, remat,
                                       specs_norm)
from repro_torch.models.transformer import (LM, cast_weights, head_loss,
                                            head_out)

Caches = List[Tuple[torch.Tensor, torch.Tensor]]


def _check(cfg: ModelConfig) -> None:
    if cfg.family != "ssm":
        raise ValueError(f"ssm_lm runs the ssm family, got {cfg.family!r}")


def init_ssm_lm(gen: torch.Generator, cfg: ModelConfig, device) -> LM:
    """Random parameters from ``gen`` (a generator on ``device``) with the
    reference's distributions; tests bridge the reference's init."""
    _check(cfg)
    dtype = dt(cfg.param_dtype)
    embed = embed_init(gen, (cfg.vocab_size, cfg.d_model), dtype, device)
    layers = [nn.ModuleDict({
        "ln": init_norm(cfg.d_model, cfg.norm, dtype, device),
        "mamba": mamba_mod.init_mamba_block(gen, cfg, dtype, device)})
        for _ in range(cfg.num_layers)]
    final_norm = init_norm(cfg.d_model, cfg.norm, dtype, device)
    lm_head = None if cfg.tie_embeddings else embed_init(
        gen, (cfg.d_model, cfg.vocab_size), dtype, device)
    return LM(cfg, embed, layers, final_norm, lm_head)


def _train_layer(lp, cfg: ModelConfig, h: torch.Tensor) -> torch.Tensor:
    x = apply_norm(lp["ln"], h, cfg.norm)
    return h + mamba_mod.apply_mamba_block(lp["mamba"], cfg, x)


def run_layers(layers, cfg: ModelConfig, h: torch.Tensor, *, mode: str,
               caches: Optional[Caches] = None):
    """Loop over layers.  train: (h, None); prefill: (h, caches); decode:
    ``caches`` updated in place, (h, caches)."""
    new: Caches = []
    if mode == "train":
        layer = remat(_train_layer, cfg.remat_policy)
        for lp in layers:
            h = layer(lp, cfg, h)
        return h, None
    for i, lp in enumerate(layers):
        x = apply_norm(lp["ln"], h, cfg.norm)
        conv_s, h_s = caches[i] if mode == "decode" else (None, None)
        y, conv_new, h_new = mamba_mod.apply_mamba_block(
            lp["mamba"], cfg, x, conv_state=conv_s, h_state=h_s,
            return_state=True)
        h = h + y
        if mode == "decode":
            conv_s.copy_(conv_new)
            h_s.copy_(h_new)
        else:
            new.append((conv_new, h_new))
    if mode == "decode":
        return h, caches
    return h, (new if mode == "prefill" else None)


def forward(params: LM, cfg: ModelConfig, batch: Dict, *, mode="train"):
    _check(cfg)
    params = cast_weights(params, cfg)
    h = params.embed[batch["tokens"]].to(dt(cfg.compute_dtype))
    h, caches = run_layers(params.layers, cfg, h, mode=mode)
    return head_out(params, cfg, h), caches, {}


def loss_fn(params: LM, cfg: ModelConfig, batch: Dict):
    """(loss, {"loss"}) of a batch of ``tokens`` and ``labels``: the
    reference's ``loss_fn``."""
    _check(cfg)
    params = cast_weights(params, cfg)
    h = params.embed[batch["tokens"]].to(dt(cfg.compute_dtype))
    h, _ = run_layers(params.layers, cfg, h, mode="train")
    loss = head_loss(params, cfg, h, batch["labels"])
    return loss, {"loss": loss}


def prefill(params: LM, cfg: ModelConfig, batch: Dict):
    logits, caches, _ = forward(params, cfg, batch, mode="prefill")
    return logits[:, -1], caches


def decode_step(params: LM, cfg: ModelConfig, caches: Caches, batch: Dict):
    """batch: {'token': [B,1] int, 'pos': ignored}.  The caches are updated
    in place.  Like the reference's, it does not call ``cast_weights``:
    falcon-mamba reads ``x_proj``, ``dt_proj`` and ``A_log`` in float32,
    so a cast leaf changes its numbers, and decode keeps those of the
    leaves it is given."""
    _check(cfg)
    h = params.embed[batch["token"]].to(dt(cfg.compute_dtype))
    h, caches = run_layers(params.layers, cfg, h, mode="decode",
                           caches=caches)
    return head_out(params, cfg, h)[:, 0], caches


def specs_ssm_lm(cfg: ModelConfig):
    """{parameter name: spec} (``common.specs_norm``'s doc)."""
    layer = {"ln": specs_norm(cfg.norm),
             "mamba": mamba_mod.specs_mamba_block(cfg)}
    s = {"embed": P("model", "data"),
         **{k: v for i in range(cfg.num_layers)
            for k, v in flat_specs(f"layers.{i}.", layer).items()},
         **flat_specs("final_norm.", specs_norm(cfg.norm))}
    if not cfg.tie_embeddings:
        s["lm_head"] = P("data", "model")
    return s


def cache_specs(cfg: ModelConfig):
    """One (conv state, h state) pair of specs a layer, as ``init_cache``
    lays the caches out."""
    return [(P("data", None, "model"), P("data", "model", None))
            for _ in range(cfg.num_layers)]


def init_cache(cfg: ModelConfig, batch: int, seq_len: int,
               device) -> Caches:
    """Zero states; their size does not depend on ``seq_len``."""
    s = cfg.ssm
    d_in = s.expand * cfg.d_model
    cd = dt(cfg.compute_dtype)
    return [(torch.zeros((batch, s.d_conv - 1, d_in), dtype=cd,
                         device=device),
             torch.zeros((batch, d_in, s.d_state), dtype=torch.float32,
                         device=device))
            for _ in range(cfg.num_layers)]
