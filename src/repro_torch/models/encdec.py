"""Whisper-style encoder-decoder (the encdec family; conv frontend stubbed);
port of ``repro/models/encdec.py``.

The encoder takes precomputed frame embeddings ``enc_embeds [B, F, d]``
(the conv1d + GELU frontend is a stub in the reference too), adds learned
positions and runs bidirectional self-attention layers.  A decoder layer
is causal self-attention (with a KV cache in decode), cross attention over
the encoder's output (its K/V computed once, at prefill), and a LayerNorm
+ GELU MLP; learned positions, no RoPE, q/k/v and output biases, and the
head tied to the embedding.

The parameters are an ``EncDec`` module in the JAX layout: ``embed``,
``enc_pos [F, d]``, ``dec_pos [max_target_positions, d]``, the
``nn.ModuleList``s ``enc_layers`` (``ln1``, ``attn``, ``ln2``, ``mlp``)
and ``dec_layers`` (``ln1``, ``self_attn``, ``ln_x``, ``cross_attn``,
``ln2``, ``mlp``), where the reference stacks each on a leading [L] axis,
and ``enc_norm``, ``dec_norm``.  A Python loop replaces ``lax.scan``; in
training each layer is rematerialised by ``common.remat``.

Attention: the encoder's and the cross attention go through
``chunked_attention(..., causal=False)`` and the decoder's self attention
with ``causal=True``, so on the card the flash kernel runs forward and
backward; decode's self and cross attention go through
``decode_attention_ref``, the cross one at the reference's query position
``F - 1 + 10**9`` (every source frame kept).  The cross attention's query
and its keys and values are projected each on its own (the reference
projects all three of each input and drops two; the kept ones are the same
products).

Caches are the reference's four-tuple ``(self K, self V, cross K, cross
V)``, each ``[L, B, S | F, Hkv, hd]`` in the compute dtype.  ``prefill``
returns the self K/V at the prompt's length; copying them into
``init_cache``'s buffers is the caller's step, as in the reference.
``decode_step`` writes the new token's K/V at ``pos`` in place and raises
at a ``pos`` past the cache (the reference's ``dynamic_update_slice``
would clamp it without a word).  As in the reference, nothing here calls
``cast_weights``: ``Model.cast_weights`` casts a server's weights once.
"""
from __future__ import annotations

from typing import Dict, List, Tuple

import torch
from torch import nn

from repro_torch.configs import ModelConfig
from repro_torch.launch.mesh import P
from repro_torch.models import attention as attn
from repro_torch.models import mlp as mlp_mod
from repro_torch.models.common import (apply_norm, dt, embed_init,
                                       flat_specs, init_norm, remat,
                                       rms_head_norm, specs_norm)
from repro_torch.models.transformer import _casts, _frozen, lm_loss

Caches = Tuple[torch.Tensor, torch.Tensor, torch.Tensor, torch.Tensor]
# the cross decode's query position: past every source frame
CROSS_Q_OFFSET = 10 ** 9


class EncDec(nn.Module):
    """Parameters of an encoder-decoder in the JAX package's layout (one
    ``nn.ModuleDict`` a layer where the reference stacks ``[L, ...]``)."""

    def __init__(self, cfg: ModelConfig, embed: torch.Tensor,
                 enc_pos: torch.Tensor, dec_pos: torch.Tensor,
                 enc_layers: List[nn.ModuleDict],
                 dec_layers: List[nn.ModuleDict],
                 enc_norm: nn.ParameterDict, dec_norm: nn.ParameterDict):
        super().__init__()
        self.cfg = cfg
        self.embed = _frozen(embed)
        self.enc_pos = _frozen(enc_pos)
        self.dec_pos = _frozen(dec_pos)
        self.enc_layers = nn.ModuleList(enc_layers)
        self.dec_layers = nn.ModuleList(dec_layers)
        self.enc_norm = enc_norm
        self.dec_norm = dec_norm


def _check(cfg: ModelConfig) -> None:
    if cfg.family != "encdec":
        raise ValueError(f"encdec runs the encdec family, got {cfg.family!r}")


# ---------------------------------------------------------------------------
# init
# ---------------------------------------------------------------------------


def _init_enc_layer(gen, cfg: ModelConfig, dtype, device) -> nn.ModuleDict:
    return nn.ModuleDict({
        "ln1": init_norm(cfg.d_model, cfg.norm, dtype, device),
        "attn": attn.init_attention(gen, cfg, dtype, device),
        "ln2": init_norm(cfg.d_model, cfg.norm, dtype, device),
        "mlp": mlp_mod.init_mlp(gen, cfg, dtype, device)})


def _init_dec_layer(gen, cfg: ModelConfig, dtype, device) -> nn.ModuleDict:
    return nn.ModuleDict({
        "ln1": init_norm(cfg.d_model, cfg.norm, dtype, device),
        "self_attn": attn.init_attention(gen, cfg, dtype, device),
        "ln_x": init_norm(cfg.d_model, cfg.norm, dtype, device),
        "cross_attn": attn.init_attention(gen, cfg, dtype, device),
        "ln2": init_norm(cfg.d_model, cfg.norm, dtype, device),
        "mlp": mlp_mod.init_mlp(gen, cfg, dtype, device)})


def init_encdec(gen: torch.Generator, cfg: ModelConfig, device) -> EncDec:
    """Random parameters from ``gen`` (a generator on ``device``) with the
    reference's distributions; tests bridge the reference's init."""
    _check(cfg)
    dtype = dt(cfg.param_dtype)
    e = cfg.encdec
    embed = embed_init(gen, (cfg.vocab_size, cfg.d_model), dtype, device)
    enc_pos = embed_init(gen, (e.source_positions, cfg.d_model), dtype,
                         device)
    dec_pos = embed_init(gen, (e.max_target_positions, cfg.d_model), dtype,
                         device)
    enc = [_init_enc_layer(gen, cfg, dtype, device)
           for _ in range(e.encoder_layers)]
    dec = [_init_dec_layer(gen, cfg, dtype, device)
           for _ in range(cfg.num_layers)]
    return EncDec(cfg, embed, enc_pos, dec_pos, enc, dec,
                  init_norm(cfg.d_model, cfg.norm, dtype, device),
                  init_norm(cfg.d_model, cfg.norm, dtype, device))


# ---------------------------------------------------------------------------
# the cast_weights_bf16 lever
# ---------------------------------------------------------------------------


def _depth(name: str, cfg: ModelConfig) -> int:
    """The stack length of the reference leaf that holds parameter
    ``name`` (0 for the unstacked ones)."""
    head = name.split(".")[0]
    return {"enc_layers": cfg.encdec.encoder_layers,
            "dec_layers": cfg.num_layers}.get(head, 0)


def cast_weights(params: EncDec, cfg: ModelConfig) -> EncDec:
    """The reference's rule (``transformer._casts``: a floating leaf of
    ndim >= 2 and >= 1M elements goes to the compute dtype) applied to its
    *stacked* leaves: a layer's tensor counts its stack depth
    (``encoder_layers`` or ``num_layers``) in both.  Returns ``params``
    when the lever is off or nothing is left to cast; otherwise a new
    ``EncDec`` whose cast leaves are frozen copies, the others shared."""
    if not cfg.cast_weights_bf16:
        return params
    cd = dt(cfg.compute_dtype)
    todo = {name for name, x in params.named_parameters()
            if _casts(x, _depth(name, cfg)) and x.dtype != cd}
    if not todo:
        return params

    def leaf(name: str, x: torch.Tensor) -> nn.Parameter:
        return _frozen(x.to(cd)) if name in todo else _frozen(x)

    def stack(mods: nn.ModuleList, prefix: str) -> List[nn.ModuleDict]:
        return [nn.ModuleDict({sub: nn.ParameterDict({
            k: leaf(f"{prefix}.{i}.{sub}.{k}", v) for k, v in pd.items()})
            for sub, pd in lp.items()}) for i, lp in enumerate(mods)]

    def norm(pd: nn.ParameterDict, prefix: str) -> nn.ParameterDict:
        return nn.ParameterDict({k: leaf(f"{prefix}.{k}", v)
                                 for k, v in pd.items()})

    return EncDec(params.cfg, leaf("embed", params.embed),
                  leaf("enc_pos", params.enc_pos),
                  leaf("dec_pos", params.dec_pos),
                  stack(params.enc_layers, "enc_layers"),
                  stack(params.dec_layers, "dec_layers"),
                  norm(params.enc_norm, "enc_norm"),
                  norm(params.dec_norm, "dec_norm"))


# ---------------------------------------------------------------------------
# projections
# ---------------------------------------------------------------------------


def _project_q(p, cfg: ModelConfig, x: torch.Tensor) -> torch.Tensor:
    """``qkv_project(p, cfg, x, rope=False)[0]`` alone."""
    q = attn._heads(x, p["wq"])
    if cfg.qkv_bias:
        q = q + p["bq"].to(x.dtype)
    if cfg.qk_norm:
        q = rms_head_norm(p["q_norm"], q)
    return q


def _project_kv(p, cfg: ModelConfig, x: torch.Tensor):
    """``qkv_project(p, cfg, x, rope=False)[1:]`` alone."""
    k, v = attn._heads(x, p["wk"]), attn._heads(x, p["wv"])
    if cfg.qkv_bias:
        k = k + p["bk"].to(x.dtype)
        v = v + p["bv"].to(x.dtype)
    if cfg.qk_norm:
        k = rms_head_norm(p["k_norm"], k)
    return k, v


def _arange(n: int, B: int, device) -> torch.Tensor:
    return torch.arange(n, dtype=torch.int32, device=device)[None].expand(
        B, n)


# ---------------------------------------------------------------------------
# encoder
# ---------------------------------------------------------------------------


def _enc_layer(lp, cfg: ModelConfig, h: torch.Tensor,
               pos: torch.Tensor) -> torch.Tensor:
    a = apply_norm(lp["ln1"], h, cfg.norm)
    q, k, v = attn.qkv_project(lp["attn"], cfg, a, pos, rope=False)
    o = attn.chunked_attention(q, k, v, q_positions=pos, k_positions=pos,
                               causal=False, chunk=cfg.attn_chunk)
    h = h + attn.out_project(lp["attn"], cfg, o)
    m = apply_norm(lp["ln2"], h, cfg.norm)
    return h + mlp_mod.apply_mlp(lp["mlp"], cfg, m)


def encode(params: EncDec, cfg: ModelConfig,
           enc_embeds: torch.Tensor) -> torch.Tensor:
    """enc_embeds [B, F, d] -> the encoder's output [B, F, d] in the
    compute dtype."""
    cd = dt(cfg.compute_dtype)
    B, F, _ = enc_embeds.shape
    h = enc_embeds.to(cd) + params.enc_pos[None, :F].to(cd)
    pos = _arange(F, B, h.device)
    layer = remat(_enc_layer, cfg.remat_policy)
    for lp in params.enc_layers:
        h = layer(lp, cfg, h, pos)
    return apply_norm(params.enc_norm, h, cfg.norm)


# ---------------------------------------------------------------------------
# decoder
# ---------------------------------------------------------------------------


def _dec_layer(lp, cfg: ModelConfig, h: torch.Tensor,
               positions: torch.Tensor, *, mode: str, memory=None,
               cache=None, pos_scalar: int = 0):
    """One decoder layer.  mode: train | prefill | decode.  ``cache``
    (decode) is one layer's (self K, self V, cross K, cross V), the self
    K/V written at ``pos_scalar`` in place.  Returns (h, the layer's cache
    in prefill and decode, else None)."""
    B = h.shape[0]
    a = apply_norm(lp["ln1"], h, cfg.norm)
    q, k, v = attn.qkv_project(lp["self_attn"], cfg, a, positions,
                               rope=False)
    new_cache = None
    if mode == "decode":
        ck, cv, xk, xv = cache
        ck[:, pos_scalar] = k[:, 0].to(ck.dtype)
        cv[:, pos_scalar] = v[:, 0].to(cv.dtype)
        o = attn.decode_attention_ref(
            q, ck, cv, q_position=pos_scalar,
            k_positions=_arange(ck.shape[1], B, h.device))
    else:
        o = attn.chunked_attention(q, k, v, q_positions=positions,
                                   k_positions=positions, causal=True,
                                   chunk=cfg.attn_chunk)
    h = h + attn.out_project(lp["self_attn"], cfg, o)

    x_in = apply_norm(lp["ln_x"], h, cfg.norm)
    qx = _project_q(lp["cross_attn"], cfg, x_in)
    if mode == "decode":
        kx, vx = xk, xv
        new_cache = cache
    else:
        kx, vx = _project_kv(lp["cross_attn"], cfg, memory)
        if mode == "prefill":
            new_cache = (k, v, kx, vx)
    F = kx.shape[1]
    fpos = _arange(F, B, h.device)
    if mode == "decode":
        ox = attn.decode_attention_ref(
            qx, kx, vx, q_position=F - 1 + CROSS_Q_OFFSET, k_positions=fpos)
    else:
        ox = attn.chunked_attention(qx, kx, vx, q_positions=positions,
                                    k_positions=fpos, causal=False,
                                    chunk=cfg.attn_chunk)
    h = h + attn.out_project(lp["cross_attn"], cfg, ox)

    m = apply_norm(lp["ln2"], h, cfg.norm)
    return h + mlp_mod.apply_mlp(lp["mlp"], cfg, m), new_cache


def _head(params: EncDec, cfg: ModelConfig, h: torch.Tensor) -> torch.Tensor:
    h = apply_norm(params.dec_norm, h, cfg.norm)
    return h @ params.embed.to(h.dtype).T          # tied: "bsd,vd->bsv"


def decode_tokens(params: EncDec, cfg: ModelConfig, tokens: torch.Tensor,
                  memory: torch.Tensor, *, mode: str = "train"):
    """tokens [B, S] over the encoder's output -> (logits [B, S, V], the
    prefill caches or None)."""
    cd = dt(cfg.compute_dtype)
    B, S = tokens.shape
    h = params.embed[tokens].to(cd) + params.dec_pos[None, :S].to(cd)
    positions = _arange(S, B, h.device)
    layer = remat(_dec_layer, cfg.remat_policy) if mode == "train" \
        else _dec_layer
    caches = []
    for lp in params.dec_layers:
        h, nc = layer(lp, cfg, h, positions, mode=mode, memory=memory)
        caches.append(nc)
    logits = _head(params, cfg, h)
    if mode != "prefill":
        return logits, None
    return logits, tuple(torch.stack([c[j] for c in caches])
                         for j in range(4))


# ---------------------------------------------------------------------------
# public API
# ---------------------------------------------------------------------------


def forward(params: EncDec, cfg: ModelConfig, batch: Dict, *,
            mode: str = "train"):
    """batch: ``enc_embeds [B, F, d]`` and ``tokens [B, S]`` -> (logits,
    caches in prefill, {})."""
    _check(cfg)
    memory = encode(params, cfg, batch["enc_embeds"])
    logits, caches = decode_tokens(params, cfg, batch["tokens"], memory,
                                   mode=mode)
    return logits, caches, {}


def loss_fn(params: EncDec, cfg: ModelConfig, batch: Dict):
    """(loss, {"loss"}) of a batch of ``enc_embeds``, ``tokens`` and
    ``labels``: the reference's mean float32 cross-entropy of the full
    logits."""
    logits, _, _ = forward(params, cfg, batch, mode="train")
    loss = lm_loss(logits, batch["labels"], vocab=cfg.vocab_size)
    return loss, {"loss": loss}


def prefill(params: EncDec, cfg: ModelConfig, batch: Dict):
    """(last logits [B, V], caches): the self K/V at the prompt's length,
    the cross K/V over every source frame."""
    logits, caches, _ = forward(params, cfg, batch, mode="prefill")
    return logits[:, -1], caches


def decode_step(params: EncDec, cfg: ModelConfig, caches: Caches,
                batch: Dict):
    """batch: {'token': [B, 1] int, 'pos': int}.  The self K/V caches are
    written at ``pos`` in place; a ``pos`` past the cache (or past the
    learned positions) raises.  A 0-d tensor ``pos`` is read with
    ``.item()``, which synchronises with the card."""
    _check(cfg)
    pos = batch["pos"]
    pos = int(pos.item()) if torch.is_tensor(pos) else int(pos)
    ck, cv, xk, xv = caches
    limit = min(ck.shape[2], params.dec_pos.shape[0])
    if not 0 <= pos < limit:
        raise IndexError(
            f"decode position {pos} outside the cache's {ck.shape[2]} "
            f"slots and {params.dec_pos.shape[0]} learned positions (the "
            f"reference would clamp it)")
    cd = dt(cfg.compute_dtype)
    tok = batch["token"]
    B = tok.shape[0]
    h = params.embed[tok].to(cd) + params.dec_pos[None, pos:pos + 1].to(cd)
    positions = torch.full((B, 1), pos, dtype=torch.int32, device=h.device)
    for i, lp in enumerate(params.dec_layers):
        h, _ = _dec_layer(lp, cfg, h, positions, mode="decode",
                          cache=(ck[i], cv[i], xk[i], xv[i]),
                          pos_scalar=pos)
    return _head(params, cfg, h)[:, 0], caches


def specs_encdec(cfg: ModelConfig):
    """{parameter name: spec} (``common.specs_norm``'s doc)."""
    enc_layer = {"ln1": specs_norm(cfg.norm),
                 "attn": attn.specs_attention(cfg),
                 "ln2": specs_norm(cfg.norm), "mlp": mlp_mod.specs_mlp(cfg)}
    dec_layer = {"ln1": specs_norm(cfg.norm),
                 "self_attn": attn.specs_attention(cfg),
                 "ln_x": specs_norm(cfg.norm),
                 "cross_attn": attn.specs_attention(cfg),
                 "ln2": specs_norm(cfg.norm), "mlp": mlp_mod.specs_mlp(cfg)}
    s = {"embed": P("model", "data"), "enc_pos": P(None, "data"),
         "dec_pos": P(None, "data")}
    for i in range(cfg.encdec.encoder_layers):
        s.update(flat_specs(f"enc_layers.{i}.", enc_layer))
    for i in range(cfg.num_layers):
        s.update(flat_specs(f"dec_layers.{i}.", dec_layer))
    s.update(flat_specs("enc_norm.", specs_norm(cfg.norm)))
    s.update(flat_specs("dec_norm.", specs_norm(cfg.norm)))
    return s


def cache_specs(cfg: ModelConfig):
    sp = P(None, "data", "model", None, None)
    xp = P(None, "data", None, "model", None)   # cross-KV: heads over model
    return (sp, sp, xp, xp)


def init_cache(cfg: ModelConfig, batch: int, seq_len: int,
               device) -> Caches:
    """Zero (self K, self V, cross K, cross V): [L, B, seq_len | F, Hkv,
    hd] in the compute dtype."""
    cd = dt(cfg.compute_dtype)
    L, Hkv, hd = cfg.num_layers, cfg.num_kv_heads, cfg.head_dim_
    F = cfg.encdec.source_positions
    kw = dict(dtype=cd, device=device)
    return (torch.zeros((L, batch, seq_len, Hkv, hd), **kw),
            torch.zeros((L, batch, seq_len, Hkv, hd), **kw),
            torch.zeros((L, batch, F, Hkv, hd), **kw),
            torch.zeros((L, batch, F, Hkv, hd), **kw))
