"""``build_model(cfg)``: the uniform Model API of ``repro/models/registry.py``
for every family: dense, moe and vlm (``transformer``), ssm (``ssm_lm``),
hybrid (``hybrid``) and encdec (``encdec``).  ``loss`` is each family's
``loss_fn``; on the card its backward runs the hand-written backward
kernels (flash attention, rmsnorm and the two scans)."""
from __future__ import annotations

import dataclasses
from typing import Callable

from repro_torch.configs import ModelConfig
from repro_torch.device import resolve_device
from repro_torch.models import encdec as encdec_mod
from repro_torch.models import hybrid as hybrid_mod
from repro_torch.models import ssm_lm as ssm_mod
from repro_torch.models import transformer as tf_mod

# family -> (module with forward/prefill/decode_step/init_cache, its init)
FAMILIES = {"dense": (tf_mod, tf_mod.init_lm),
            "moe": (tf_mod, tf_mod.init_lm),
            "vlm": (tf_mod, tf_mod.init_lm),
            "ssm": (ssm_mod, ssm_mod.init_ssm_lm),
            "hybrid": (hybrid_mod, hybrid_mod.init_hybrid),
            "encdec": (encdec_mod, encdec_mod.init_encdec)}


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


def build_model(cfg: ModelConfig) -> Model:
    """``init`` and ``init_cache`` allocate on CUDA unless given a device,
    and raise where there is none; the generator must live on that
    device.  With ``cfg.cast_weights_bf16`` a serving caller applies
    ``cast_weights`` once after init or bridging and keeps only what it
    returns; ``forward`` then finds the cast leaves and casts nothing (one
    round-to-nearest cast gives the same bits whenever it happens)."""
    if cfg.family not in FAMILIES:
        raise NotImplementedError(f"no model family {cfg.family!r}; the "
                                  f"families are {sorted(FAMILIES)}")
    mod, init = FAMILIES[cfg.family]
    return Model(
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
    )
