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
layers replaces ``lax.scan``; in training each layer is rematerialised
by ``common.remat`` (the reference's ``remat_wrap``).  Every weight is
cast to the compute dtype at its use (``.to(x.dtype)``,
the reference's ``.astype(cd)``); with ``cfg.cast_weights_bf16`` set,
``cast_weights`` casts the large ones once beforehand, as the reference
does, so those uses find the compute dtype and cast nothing.

Training: ``loss_fn`` is the reference's (the lever, the layers, then
``head_loss``: the final norm, the head and a float32 cross-entropy, in
sequence chunks of ``cfg.loss_chunk`` where that divides S, plus the moe
family's weighted aux loss).  Under autograd ``cast_weights`` returns a
``CastView``, whose cast leaves are differentiable ``.to`` copies, so the
gradient of every cast use reaches its float32 parameter.

On a mesh (``build_model(cfg, mesh)``) the layer, embedding and head
functions take a ``models.parallel.Sharding`` (``par``): the parameters
are the rank's shards, each gathered over the batch axes at its use inside
the rematerialised layer (ZeRO-3), the attention heads, the MLP columns,
the experts and the vocabulary split over ``"model"``, and the loss is
this rank's part of the global batch's mean.  Prefill and decode take the
rank's part of the batch and the serving layout (``sharding_for(...,
serve=True)``); the prefill keeps the rank's S slice of every kv head's
K/V, ``init_cache`` allocates the rank's shard of ``cache_specs``, and
decode attends through the distributed flash-decode
(``attention.decode_split``).  ``specs_layer`` and ``specs_lm`` are the
reference's partition-spec templates, keyed by ``named_parameters``
names; ``cache_specs`` those of the decode caches.

Decode writes the new token's k/v into the cache at ``pos`` in place (slice
assignment, where JAX returns a new array from ``dynamic_update_slice``), so
``decode_step`` returns the same cache tensors it was given, updated.
"""
from __future__ import annotations

from typing import Dict, List, Optional, Tuple

import torch
from torch import nn

from repro_torch.configs import ModelConfig
from repro_torch.launch.mesh import P
from repro_torch.models import attention as attn
from repro_torch.models import mlp as mlp_mod
from repro_torch.models import moe as moe_mod
from repro_torch.models.common import (apply_norm, dt, embed_init,
                                       flat_specs, init_norm, remat,
                                       specs_norm)
from repro_torch.obs import spans


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


def specs_layer(cfg: ModelConfig):
    """One layer's templates ``{sub: {leaf: spec}}`` (the reference's
    stacked ones without their leading ``None``)."""
    s = {"ln1": specs_norm(cfg.norm), "attn": attn.specs_attention(cfg),
         "ln2": specs_norm(cfg.norm)}
    if cfg.family == "moe":
        s["moe"] = moe_mod.specs_moe(cfg)
    else:
        s["mlp"] = mlp_mod.specs_mlp(cfg)
    return s


def specs_lm(cfg: ModelConfig):
    """{parameter name: spec} of an ``LM``."""
    s = {"embed": P("model", "data")}
    layer = specs_layer(cfg)
    for i in range(cfg.num_layers):
        s.update(flat_specs(f"layers.{i}.", layer))
    s.update(flat_specs("final_norm.", specs_norm(cfg.norm)))
    if not cfg.tie_embeddings:
        s["lm_head"] = P("data", "model")
    return s


def cache_specs(cfg: ModelConfig):
    # sequence dim sharded over 'model' => distributed flash-decode.
    sp = P(None, "data", "model", None, None)
    return {"k": sp, "v": sp}


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


class CastView:
    """An ``LM``'s leaves as plain tensors in the same places (``embed``,
    ``layers[i][sub][leaf]``, ``final_norm``, ``lm_head``), each cast leaf
    a differentiable copy in the compute dtype.  What ``cast_weights``
    returns under autograd: an ``nn.Parameter`` around a cast copy would be
    a new leaf, and the gradient would stop there."""

    def __init__(self, params: LM, cd: torch.dtype, todo):
        def leaf(name: str, x):
            return None if x is None else (x.to(cd) if name in todo else x)

        self.cfg = params.cfg
        self.embed = leaf("embed", params.embed)
        self.lm_head = leaf("lm_head", params.lm_head)
        self.final_norm = {k: leaf(f"final_norm.{k}", v)
                           for k, v in params.final_norm.items()}
        self.layers = [{sub: {k: leaf(f"layers.{i}.{sub}.{k}", v)
                              for k, v in pd.items()}
                        for sub, pd in lp.items()}
                       for i, lp in enumerate(params.layers)]


def cast_weights(params: LM, cfg: ModelConfig) -> LM:
    """The reference's ``cast_weights``: with ``cfg.cast_weights_bf16``,
    every leaf that ``_casts`` cast to the compute dtype, the others shared
    with ``params``.  Returns ``params`` itself when the lever is off or
    every such leaf already has the compute dtype (so a second call costs
    no launch).  Where autograd records (grad mode on and a cast leaf
    requires grad) it returns a ``CastView`` instead, whose casts carry the
    gradient back to the float32 leaves, as the reference's ``astype``
    inside ``loss_fn`` does."""
    if not cfg.cast_weights_bf16:
        return params
    cd = dt(cfg.compute_dtype)
    todo = {name: x for name, x, depth in _named_leaves(params, cfg)
            if _casts(x, depth) and x.dtype != cd}
    if not todo:
        return params
    if torch.is_grad_enabled() and any(x.requires_grad
                                       for x in todo.values()):
        return CastView(params, cd, todo)

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


def embed_in(params: LM, cfg: ModelConfig, batch: Dict, par=None):
    """Token / precomputed-embedding input. Returns (h [B,S,d], positions
    [B,S] int32, or [R,B,S] under M-RoPE)."""
    cd = dt(cfg.compute_dtype)
    if "embeds" in batch:                      # vlm stub frontend
        h = batch["embeds"].to(cd)
    elif par is not None:
        h = par.embed(params.embed, batch["tokens"], cd)
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


def head_out(params: LM, cfg: ModelConfig, h: torch.Tensor,
             par=None) -> torch.Tensor:
    if par is not None:
        return par.head(params, h)
    h = apply_norm(params.final_norm, h, cfg.norm)
    if cfg.tie_embeddings:
        return h @ params.embed.to(h.dtype).T
    return h @ params.lm_head.to(h.dtype)


def _layer_apply(lp, cfg: ModelConfig, h, positions, *, mode,
                 cache_kv=None, pos_scalar: Optional[int] = None, par=None,
                 index: int = 0):
    """One transformer layer. mode: train|prefill|decode.

    Returns (h, new_cache_kv_or_None, aux); in decode mode the cache
    tensors given are updated in place at ``pos_scalar`` and returned.
    ``aux`` is the MoE block's dict, empty for the other families.  With
    a ``Sharding`` the layer's shards (layer ``index``) are gathered first
    (inside the rematerialised function, so the backward pass gathers them
    again), and each tensor-parallel block is entered and left through its
    collectives; in prefill and decode every kv head is projected, the
    prefill's caches keep the rank's S slice, and decode goes through the
    distributed flash-decode where ``"model"`` splits the cache."""
    if par is not None:
        lp = par.layer(lp, index, serve=mode != "train",
                       cast=mode != "decode")
    a_in = apply_norm(lp["ln1"], h, cfg.norm)
    x = a_in if par is None else par.enter(a_in, par.attn_tp)
    q, k, v = attn.qkv_project(lp["attn"], cfg, x, positions)
    new_cache = None
    if mode == "decode":
        ck, cv = cache_kv                                  # [B,Skv,Hkv,hd]
        if par is not None and par.seq_split:
            o = attn.decode_split(q, k, v, ck, cv, pos=pos_scalar, par=par)
        else:
            ck[:, pos_scalar] = k[:, 0].to(ck.dtype)
            cv[:, pos_scalar] = v[:, 0].to(cv.dtype)
            B, Skv = ck.shape[:2]
            k_positions = torch.arange(Skv, dtype=torch.int32,
                                       device=ck.device)[None, :].expand(
                                           B, Skv)
            o = attn.decode_attention_ref(q, ck, cv, q_position=pos_scalar,
                                          k_positions=k_positions)
        new_cache = (ck, cv)
    else:
        qpos = positions if positions.dim() == 2 else positions[0]
        kk, vv = k, v
        if mode == "prefill" and par is not None and par.kv is not None:
            kk = k[:, :, par.kv].contiguous()
            vv = v[:, :, par.kv].contiguous()
        o = attn.chunked_attention(q, kk, vv, q_positions=qpos,
                                   k_positions=qpos, causal=True,
                                   chunk=cfg.attn_chunk)
        if mode == "prefill":
            new_cache = (k, v) if par is None else (
                par.seq_chunk(k, 1), par.seq_chunk(v, 1))
    h = h + attn.out_project(lp["attn"], cfg, o, reduce=(
        par.exit_if("attn") if par is not None else None))
    m_in = apply_norm(lp["ln2"], h, cfg.norm)
    if "moe" in lp:
        y, aux = moe_mod.apply_moe(lp["moe"], cfg, m_in, par=par)
        return h + y, new_cache, aux
    x = m_in if par is None else par.enter(m_in, par.mlp_tp)
    y = mlp_mod.apply_mlp(lp["mlp"], cfg, x, reduce=(
        par.exit_if("mlp") if par is not None else None))
    return h + y, new_cache, {}


def run_layers(layers, cfg: ModelConfig, h, positions, *, mode="train",
               caches=None, pos_scalar: Optional[int] = None, par=None):
    """Loop over layers (any slice of ``LM.layers``).

    train:   returns (h, None, aux)
    prefill: returns (h, {'k': [L,B,S,Hkv,hd], 'v': ...}, aux)
    decode:  caches = {'k': [L,...], 'v': [L,...]}, updated in place at
             ``pos_scalar``; returns (h, caches, {})
    ``aux`` is the reference's MoE dict, each entry the mean over the
    layers run (``{"moe_aux", "moe_dropped"}``); empty for the families
    without MoE layers.  ``par``: the mesh path, see ``_layer_apply``.
    """
    if mode == "decode":
        for i, lp in enumerate(layers):
            h = _layer_apply(lp, cfg, h, positions, mode=mode,
                             cache_kv=(caches["k"][i], caches["v"][i]),
                             pos_scalar=pos_scalar, par=par, index=i)[0]
        return h, caches, {}
    ks, vs, auxes = [], [], []
    layer = remat(_layer_apply, cfg.remat_policy) if mode == "train" \
        else _layer_apply
    for i, lp in enumerate(layers):
        h, kv, aux = layer(lp, cfg, h, positions, mode=mode, par=par,
                           index=i)
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


def forward(params: LM, cfg: ModelConfig, batch: Dict, *, mode="train",
            par=None):
    """On a mesh (``par``) the rank's shards cast at their uses, not
    here."""
    _check_family(cfg)
    if par is None:
        params = cast_weights(params, cfg)
    h, positions = embed_in(params, cfg, batch, par)
    h, caches, aux = run_layers(params.layers, cfg, h, positions, mode=mode,
                                par=par)
    return head_out(params, cfg, h, par), caches, aux


# ---------------------------------------------------------------------------
# training loss
# ---------------------------------------------------------------------------


def lm_loss(logits: torch.Tensor, labels: torch.Tensor, *, vocab: int,
            z_coef: float = 0.0, count=None) -> torch.Tensor:
    """Mean CE (f32) with optional z-loss; labels < 0 are masked.
    ``count`` maps the label count to the one the mean divides by (the
    mesh path's sum over the batch axes, so that each data rank returns
    its part of the global batch's mean)."""
    lf = logits.float()
    lse = torch.logsumexp(lf, dim=-1)
    gold = lf.gather(-1, labels.clamp(0, vocab - 1).long()[..., None])[..., 0]
    mask = (labels >= 0).float()
    total = mask.sum()
    denom = (total if count is None else count(total)).clamp(min=1.0)
    loss = ((lse - gold) * mask).sum() / denom
    if z_coef:
        loss = loss + z_coef * (lse.square() * mask).sum() / denom
    return loss


def head_loss(params, cfg: ModelConfig, h: torch.Tensor,
              labels: torch.Tensor, par=None) -> torch.Tensor:
    """Final norm + head + CE; in chunks of ``cfg.loss_chunk`` positions
    where that divides S (and S is longer), each chunk's CE and label count
    summed in chunk order, as the reference's scan does.  On a mesh the
    label count is the global batch's."""
    with spans.span("lm.head_loss", h):
        h = spans.grad_mark("lm.head_loss", h)
        loss = _head_loss(params, cfg, h, labels, par)
        return spans.grad_mark("lm.head_loss", loss, end=True)


def _head_loss(params, cfg: ModelConfig, h: torch.Tensor,
               labels: torch.Tensor, par) -> torch.Tensor:
    C = cfg.loss_chunk
    S = h.shape[1]
    count = None if par is None else par.batch_sum
    if not C or S % C != 0 or S <= C:
        return lm_loss(head_out(params, cfg, h, par), labels,
                       vocab=cfg.vocab_size, count=count)
    ce = torch.zeros((), dtype=torch.float32, device=h.device)
    cnt = torch.zeros((), dtype=torch.float32, device=h.device)
    for c0 in range(0, S, C):
        l_i = labels[:, c0:c0 + C]
        lf = head_out(params, cfg, h[:, c0:c0 + C], par).float()
        lse = torch.logsumexp(lf, dim=-1)
        gold = lf.gather(-1, l_i.clamp(0, cfg.vocab_size - 1).long()
                         [..., None])[..., 0]
        mask = (l_i >= 0).float()
        ce = ce + ((lse - gold) * mask).sum()
        cnt = cnt + mask.sum()
    if count is not None:
        cnt = count(cnt)
    return ce / cnt.clamp(min=1.0)


def loss_fn(params: LM, cfg: ModelConfig, batch: Dict, par=None):
    """(loss, metrics) of a batch with ``labels`` [B, S] (and ``tokens`` or
    ``embeds``): the reference's ``loss_fn``; metrics hold the loss and the
    moe means (zero for the families without MoE layers, as there).

    On a mesh (``par``, the rank's shards of ``params`` and of the batch)
    the loss returned is this rank's part: the sum over the data ranks of
    the parts is the global batch's mean CE, plus the aux loss's weight
    times the mean over the data ranks of each data shard's aux (the
    reference's ``shard_map`` computes the aux over a data shard's tokens,
    as capacity is per data shard).  The metrics are the global values,
    the same on every rank."""
    _check_family(cfg)
    if par is None:
        params = cast_weights(params, cfg)
    h, positions = embed_in(params, cfg, batch, par)
    h, _, aux = run_layers(params.layers, cfg, h, positions, mode="train",
                           par=par)
    loss = head_loss(params, cfg, h, batch["labels"], par)
    zero = torch.zeros((), dtype=torch.float32, device=loss.device)
    aux = {k: aux.get(k, zero) for k in ("moe_aux", "moe_dropped")}
    if par is not None:
        aux = {k: v / par.data_size for k, v in aux.items()}
    if cfg.family == "moe" and cfg.moe.router_aux_loss:
        loss = loss + cfg.moe.router_aux_loss * aux["moe_aux"]
    if par is None:
        return loss, {"loss": loss, **aux}
    return loss, {"loss": par.batch_sum(loss),
                  **{k: par.batch_sum(v) for k, v in aux.items()}}


def prefill(params: LM, cfg: ModelConfig, batch: Dict, par=None):
    logits, caches, _ = forward(params, cfg, batch, mode="prefill", par=par)
    # only the last-position logits are needed to start decoding
    return logits[:, -1], caches


def decode_step(params: LM, cfg: ModelConfig, caches, batch: Dict,
                par=None):
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
    elif par is not None:
        h = par.embed(params.embed, batch["token"], cd)
    else:
        h = params.embed[batch["token"]].to(cd)
    B = h.shape[0]
    positions = torch.full((B, 1), pos, dtype=torch.int32, device=h.device)
    if cfg.mrope_sections:
        positions = positions[None].expand(len(cfg.mrope_sections), B, 1)
    h, caches, _ = run_layers(params.layers, cfg, h, positions,
                              mode="decode", caches=caches, pos_scalar=pos,
                              par=par)
    return head_out(params, cfg, h, par)[:, 0], caches


def init_cache(cfg: ModelConfig, batch: int, seq_len: int, device,
               par=None):
    """Zero K/V caches [L, B, S, Hkv, hd]; on a mesh (``par``) the rank's
    shard of ``cache_specs`` (B over the batch axes where it divides, S over
    ``"model"``)."""
    if par is not None:
        batch, seq_len = par.local_batch(batch), par.local_len(seq_len)
    shape = (cfg.num_layers, batch, seq_len, cfg.num_kv_heads,
             cfg.head_dim_)
    cd = dt(cfg.compute_dtype)
    return {"k": torch.zeros(shape, dtype=cd, device=device),
            "v": torch.zeros(shape, dtype=cd, device=device)}
