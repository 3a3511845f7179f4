"""``build_model(cfg, mesh=None)``: the uniform Model API of
``repro/models/registry.py`` for every family: dense, moe and vlm
(``transformer``), ssm (``ssm_lm``), hybrid (``hybrid``) and encdec
(``encdec``).  ``loss`` is each family's ``loss_fn``; on the card its
backward runs the hand-written backward kernels (flash attention, rmsnorm
and the two scans).  ``specs`` and ``cache_specs`` are the reference's
partition-spec templates (``{parameter name: P}``, and the caches' specs in
the port's cache layout); ``input_partition_specs`` those of a cell's
inputs, ``input_structs`` the inputs themselves on the meta device.

On a mesh (``launch.mesh.make_mesh``) every family runs through the mesh
path (``models.parallel.Sharding``): ``loss`` takes the rank's shards of
the parameters in the train layout (``Model.sharding``) and of the batch
(``launch.step`` splits both); ``forward``, ``prefill`` and
``decode_step`` take the rank's shards in the serving layout
(``Model.serve_sharding``: FSDP over the batch axes with
``cfg.serve_param_fsdp``, replicated over them without) and the rank's
part of the batch, ``init_cache`` allocates the rank's shard of
``cache_specs``, and ``fill_cache`` writes a prefill's caches into
``init_cache``'s (a K/V cache split along S is gathered over ``"model"``
first, since the prompt's slots and the cache's split differently).
Under ``cfg.pure_dp`` the batch spans ``("data", "model")`` and every leaf
is ZeRO-3 over both axes (``Sharding``'s ``pure_dp`` layout): nothing is
tensor-parallel, and a rank's caches hold its rows of the batch with every
slot and head.  ``input_partition_specs`` takes the batch axes as the
reference's does (``launch.mesh.batch_axes_of(None, cfg)`` gives a
configuration's).
"""
from __future__ import annotations

import dataclasses
from typing import Any, Callable, Dict, Optional

import torch

from repro_torch.configs import ModelConfig, ShapeConfig
from repro_torch.device import resolve_device
from repro_torch.launch.mesh import P, gather_list
from repro_torch.models import encdec as encdec_mod
from repro_torch.models import hybrid as hybrid_mod
from repro_torch.models import ssm_lm as ssm_mod
from repro_torch.models import transformer as tf_mod
from repro_torch.models.common import dt
from repro_torch.models.parallel import Sharding, sharding_for

# family -> (module with forward/prefill/decode_step/init_cache, its init,
# its parameter specs)
FAMILIES = {"dense": (tf_mod, tf_mod.init_lm, tf_mod.specs_lm),
            "moe": (tf_mod, tf_mod.init_lm, tf_mod.specs_lm),
            "vlm": (tf_mod, tf_mod.init_lm, tf_mod.specs_lm),
            "ssm": (ssm_mod, ssm_mod.init_ssm_lm, ssm_mod.specs_ssm_lm),
            "hybrid": (hybrid_mod, hybrid_mod.init_hybrid,
                       hybrid_mod.specs_hybrid),
            "encdec": (encdec_mod, encdec_mod.init_encdec,
                       encdec_mod.specs_encdec)}


@dataclasses.dataclass(frozen=True)
class Model:
    cfg: ModelConfig
    init: Callable            # (generator, device=None) -> params (a module)
    loss: Callable            # (params, batch) -> (loss, metrics)
    forward: Callable         # (params, batch, mode) -> (logits, caches, aux)
    prefill: Callable         # (params, batch) -> (last_logits, caches)
    decode_step: Callable     # (params, caches, batch) -> (logits, caches)
    init_cache: Callable      # (batch, seq_len, device=None) -> caches
    cast_weights: Callable    # (params) -> params, cast once (the lever)
    fill_cache: Callable = None   # (caches, prefill's caches) -> caches
    specs: Callable = None        # () -> {parameter name: P}
    cache_specs: Callable = None  # () -> the caches' specs
    mesh: Any = None
    sharding: Optional[Sharding] = None        # the train layout on a mesh
    serve_sharding: Optional[Sharding] = None  # the serving layout


def _fill_kv(dst: torch.Tensor, src: torch.Tensor, par) -> None:
    """A prefill's K/V [L, B, P, ...] into a cache's [L, B, S, ...] (the
    rank's slots of each where ``par`` splits them along S)."""
    if par is None or not par.seq_split:
        dst[:, :, :src.shape[2]] = src
        return
    whole = torch.cat(gather_list(src, ("model",), par.mesh), dim=2)
    n = dst.shape[2]
    off = par.model_index * n
    end = min(off + n, whole.shape[2])
    if end > off:
        dst[:, :, :end - off] = whole[:, :, off:end]


def fill_cache(cfg: ModelConfig, caches, prefilled, par=None):
    """Write ``prefilled`` (a prefill's caches) into ``caches``
    (``init_cache``'s) in place and return them: the self K/V at the
    prompt's slots; the recurrent states, ring buffers and cross K/V
    whole."""
    if cfg.family in ("dense", "moe", "vlm"):
        for name in ("k", "v"):
            _fill_kv(caches[name], prefilled[name], par)
    elif cfg.family == "encdec":
        for j in range(4):
            if j < 2:
                _fill_kv(caches[j], prefilled[j], par)
            else:
                caches[j].copy_(prefilled[j])
    else:
        for pair, new in zip(caches, prefilled, strict=True):
            for dst, src in zip(pair, new, strict=True):
                dst.copy_(src)
    return caches


def build_model(cfg: ModelConfig, mesh=None) -> Model:
    """``init`` and ``init_cache`` allocate on CUDA unless given a device,
    and raise where there is none; the generator must live on that
    device.  With ``cfg.cast_weights_bf16`` a serving caller applies
    ``cast_weights`` once after init or bridging and keeps only what it
    returns; ``forward`` then finds the cast leaves and casts nothing (one
    round-to-nearest cast gives the same bits whenever it happens).
    ``init`` gives whole parameters on a mesh too (``launch.step``'s
    ``shard_train_state`` and ``shard_params`` keep each rank's shards)."""
    if cfg.family not in FAMILIES:
        raise NotImplementedError(f"no model family {cfg.family!r}; the "
                                  f"families are {sorted(FAMILIES)}")
    mod, init, specs = FAMILIES[cfg.family]
    par = srv = None
    if mesh is not None:
        par, srv = sharding_for(cfg, mesh), sharding_for(cfg, mesh, True)
    return Model(
        cfg=cfg,
        init=lambda generator, device=None: init(
            generator, cfg, resolve_device(device)),
        loss=lambda params, batch: mod.loss_fn(params, cfg, batch, par),
        forward=lambda params, batch, mode="train": mod.forward(
            params, cfg, batch, mode=mode,
            par=par if mode == "train" else srv),
        prefill=lambda params, batch: mod.prefill(params, cfg, batch, srv),
        decode_step=lambda params, caches, batch: mod.decode_step(
            params, cfg, caches, batch, srv),
        init_cache=lambda batch, seq_len, device=None: mod.init_cache(
            cfg, batch, seq_len, resolve_device(device), srv),
        cast_weights=lambda params: mod.cast_weights(params, cfg)
        if mod is encdec_mod else tf_mod.cast_weights(params, cfg),
        fill_cache=lambda caches, prefilled: fill_cache(
            cfg, caches, prefilled, srv),
        specs=lambda: specs(cfg),
        cache_specs=lambda: mod.cache_specs(cfg),
        mesh=mesh, sharding=par, serve_sharding=srv)


# ---------------------------------------------------------------------------
# input specs
# ---------------------------------------------------------------------------


def input_partition_specs(cfg: ModelConfig, shape: ShapeConfig,
                          batch_axes=("data",)) -> Dict[str, P]:
    b = batch_axes
    if shape.kind == "decode":
        return {"token": P(b, None), "pos": P()}
    if cfg.family == "vlm":
        sp = {"embeds": P(b, None, None), "positions": P(None, b, None)}
    elif cfg.family == "encdec":
        sp = {"enc_embeds": P(b, None, None), "tokens": P(b, None)}
    else:
        sp = {"tokens": P(b, None)}
    if shape.kind == "train":
        sp["labels"] = P(b, None)
    return sp


def input_structs(cfg: ModelConfig, shape: ShapeConfig,
                  device="meta") -> Dict[str, Any]:
    """Every model input of this (arch, shape) cell at its global shape, on
    ``device`` (the meta device by default: shapes and dtypes only, as the
    reference's ``ShapeDtypeStruct``s).  ``pos`` is a Python int, the last
    slot (the kernels read it on the host)."""
    B, S = shape.global_batch, shape.seq_len
    i32 = dict(dtype=torch.int32, device=device)
    if shape.kind == "decode":
        return {"token": torch.zeros((B, 1), **i32), "pos": S - 1}
    cd = dict(dtype=dt(cfg.compute_dtype), device=device)
    if cfg.family == "vlm":
        batch = {"embeds": torch.zeros((B, S, cfg.d_model), **cd),
                 "positions": torch.zeros((len(cfg.mrope_sections), B, S),
                                          **i32)}
    elif cfg.family == "encdec":
        batch = {"enc_embeds": torch.zeros(
            (B, cfg.encdec.source_positions, cfg.d_model), **cd),
            "tokens": torch.zeros((B, S), **i32)}
    else:
        batch = {"tokens": torch.zeros((B, S), **i32)}
    if shape.kind == "train":
        batch["labels"] = torch.zeros((B, S), **i32)
    return batch
