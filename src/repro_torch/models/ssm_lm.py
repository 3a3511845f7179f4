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

On a mesh (``par``, a ``models.parallel.Sharding``) the functions take the
rank's shards and the rank's part of the batch: each layer's leaves are
gathered at their use, the Mamba block runs on the rank's channels
(``mamba.apply_mamba_block``), the vocabulary is split as the
transformer's, and the caches are the rank's channels of the states.
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


def _layer(lp, cfg: ModelConfig, h: torch.Tensor, *, par=None,
           index: int = 0, cast: bool = True, conv_state=None, h_state=None,
           return_state: bool = False):
    if par is not None:
        lp = par.layer(lp, index, serve=return_state, cast=cast)
    x = apply_norm(lp["ln"], h, cfg.norm)
    if par is not None:
        x = par.enter(x, par.tp["mamba"])
    out = mamba_mod.apply_mamba_block(
        lp["mamba"], cfg, x, conv_state=conv_state, h_state=h_state,
        return_state=return_state, par=par)
    if return_state:
        y, conv_new, h_new = out
        return h + y, conv_new, h_new
    return h + out


def run_layers(layers, cfg: ModelConfig, h: torch.Tensor, *, mode: str,
               caches: Optional[Caches] = None, par=None):
    """Loop over layers.  train: (h, None); prefill: (h, caches); decode:
    ``caches`` updated in place, (h, caches)."""
    new: Caches = []
    if mode == "train":
        layer = remat(_layer, cfg.remat_policy)
        for i, lp in enumerate(layers):
            h = layer(lp, cfg, h, par=par, index=i)
        return h, None
    for i, lp in enumerate(layers):
        conv_s, h_s = caches[i] if mode == "decode" else (None, None)
        h, conv_new, h_new = _layer(
            lp, cfg, h, par=par, index=i, cast=mode != "decode",
            conv_state=conv_s, h_state=h_s, return_state=True)
        if mode == "decode":
            conv_s.copy_(conv_new)
            h_s.copy_(h_new)
        else:
            new.append((conv_new, h_new))
    if mode == "decode":
        return h, caches
    return h, (new if mode == "prefill" else None)


def _embed(params: LM, cfg: ModelConfig, tokens, par):
    cd = dt(cfg.compute_dtype)
    if par is not None:
        return par.embed(params.embed, tokens, cd)
    return params.embed[tokens].to(cd)


def forward(params: LM, cfg: ModelConfig, batch: Dict, *, mode="train",
            par=None):
    _check(cfg)
    if par is None:
        params = cast_weights(params, cfg)
    h = _embed(params, cfg, batch["tokens"], par)
    h, caches = run_layers(params.layers, cfg, h, mode=mode, par=par)
    return head_out(params, cfg, h, par), caches, {}


def loss_fn(params: LM, cfg: ModelConfig, batch: Dict, par=None):
    """(loss, {"loss"}) of a batch of ``tokens`` and ``labels``: the
    reference's ``loss_fn``; on a mesh the rank's part of the global
    batch's mean, the metric the global loss."""
    _check(cfg)
    if par is None:
        params = cast_weights(params, cfg)
    h = _embed(params, cfg, batch["tokens"], par)
    h, _ = run_layers(params.layers, cfg, h, mode="train", par=par)
    loss = head_loss(params, cfg, h, batch["labels"], par)
    return loss, {"loss": loss if par is None else par.batch_sum(loss)}


def prefill(params: LM, cfg: ModelConfig, batch: Dict, par=None):
    logits, caches, _ = forward(params, cfg, batch, mode="prefill", par=par)
    return logits[:, -1], caches


def decode_step(params: LM, cfg: ModelConfig, caches: Caches, batch: Dict,
                par=None):
    """batch: {'token': [B,1] int, 'pos': ignored}.  The caches are updated
    in place.  Like the reference's, it does not call ``cast_weights``:
    falcon-mamba reads ``x_proj``, ``dt_proj`` and ``A_log`` in float32,
    so a cast leaf changes its numbers, and decode keeps those of the
    leaves it is given."""
    _check(cfg)
    h = _embed(params, cfg, batch["token"], par)
    h, caches = run_layers(params.layers, cfg, h, mode="decode",
                           caches=caches, par=par)
    return head_out(params, cfg, h, par)[:, 0], caches


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
               device, par=None) -> Caches:
    """Zero states; their size does not depend on ``seq_len``.  On a mesh
    (``par``) the rank's shard of ``cache_specs``."""
    s = cfg.ssm
    d_in = s.expand * cfg.d_model
    if par is not None:
        batch = par.local_batch(batch)
        if par.tp["mamba"]:
            d_in //= par.model_size
    cd = dt(cfg.compute_dtype)
    return [(torch.zeros((batch, s.d_conv - 1, d_in), dtype=cd,
                         device=device),
             torch.zeros((batch, d_in, s.d_state), dtype=torch.float32,
                         device=device))
            for _ in range(cfg.num_layers)]
