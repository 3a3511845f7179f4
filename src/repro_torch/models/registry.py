"""``build_model(cfg, mesh=None)``: the uniform Model API of
``repro/models/registry.py`` for every family: dense, moe and vlm
(``transformer``), ssm (``ssm_lm``), hybrid (``hybrid``) and encdec
(``encdec``).  ``loss`` is each family's ``loss_fn``; on the card its
backward runs the hand-written backward kernels (flash attention, rmsnorm
and the two scans).  ``specs`` and ``cache_specs`` are the reference's
partition-spec templates (``{parameter name: P}``, and the caches' specs in
the port's cache layout); ``input_partition_specs`` those of a cell's
inputs.

On a mesh (``launch.mesh.make_mesh``) the dense, moe and vlm families
train through the mesh path (``models.parallel.Sharding``,
``Model.sharding``): ``loss`` takes the rank's shards of the parameters
and of the batch (``launch.step`` splits both).  Sharded prefill and
decode, and the ssm, hybrid and encdec families on a mesh of more than one
device, wait (ROADMAP queue 1) and raise ``NotImplementedError``; on a
mesh of one device those run as without one.
"""
from __future__ import annotations

import dataclasses
from typing import Any, Callable, Dict, Optional

from repro_torch.configs import ModelConfig, ShapeConfig
from repro_torch.device import resolve_device
from repro_torch.launch.mesh import P
from repro_torch.models import encdec as encdec_mod
from repro_torch.models import hybrid as hybrid_mod
from repro_torch.models import ssm_lm as ssm_mod
from repro_torch.models import transformer as tf_mod
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

MESH_WAITS = ("sharded prefill and decode, and the mesh path of the ssm, "
              "hybrid and encdec families, wait: ROADMAP.md queue 1, the "
              "mesh path's remaining items")


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
    specs: Callable = None        # () -> {parameter name: P}
    cache_specs: Callable = None  # () -> the caches' specs
    mesh: Any = None
    sharding: Optional[Sharding] = None   # the mesh path, where it runs


def _waits(*_args, **_kw):
    raise NotImplementedError(MESH_WAITS)


def build_model(cfg: ModelConfig, mesh=None) -> Model:
    """``init`` and ``init_cache`` allocate on CUDA unless given a device,
    and raise where there is none; the generator must live on that
    device.  With ``cfg.cast_weights_bf16`` a serving caller applies
    ``cast_weights`` once after init or bridging and keeps only what it
    returns; ``forward`` then finds the cast leaves and casts nothing (one
    round-to-nearest cast gives the same bits whenever it happens).
    ``init`` gives whole parameters on a mesh too (``launch.step``'s
    ``shard_train_state`` keeps each rank's shards)."""
    if cfg.family not in FAMILIES:
        raise NotImplementedError(f"no model family {cfg.family!r}; the "
                                  f"families are {sorted(FAMILIES)}")
    mod, init, specs = FAMILIES[cfg.family]
    par = None
    if mesh is not None:
        if mod is tf_mod:
            par = sharding_for(cfg, mesh)
        elif mesh.size > 1:
            raise NotImplementedError(
                f"{cfg.family!r} on a mesh of {mesh.size}: {MESH_WAITS}")
    model = Model(
        cfg=cfg,
        init=lambda generator, device=None: init(
            generator, cfg, resolve_device(device)),
        loss=lambda params, batch: mod.loss_fn(params, cfg, batch),
        forward=lambda params, batch, mode="train": mod.forward(
            params, cfg, batch, mode=mode),
        prefill=lambda params, batch: mod.prefill(params, cfg, batch),
        decode_step=lambda params, caches, batch: mod.decode_step(
            params, cfg, caches, batch),
        init_cache=lambda batch, seq_len, device=None: mod.init_cache(
            cfg, batch, seq_len, resolve_device(device)),
        cast_weights=lambda params: mod.cast_weights(params, cfg)
        if mod is encdec_mod else tf_mod.cast_weights(params, cfg),
        specs=lambda: specs(cfg),
        cache_specs=lambda: mod.cache_specs(cfg),
        mesh=mesh)
    if par is None:
        return model
    serve = {} if mesh.size == 1 else dict(
        forward=_waits, prefill=_waits, decode_step=_waits)
    return dataclasses.replace(
        model, sharding=par,
        loss=lambda params, batch: tf_mod.loss_fn(params, cfg, batch, par),
        **serve)


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
