"""``build_model(cfg)``: the uniform Model API of ``repro/models/registry.py``
for the families the port has (dense so far; the others raise)."""
from __future__ import annotations

import dataclasses
from typing import Callable

from repro_torch.configs import ModelConfig
from repro_torch.device import resolve_device
from repro_torch.models import transformer as tf_mod


@dataclasses.dataclass(frozen=True)
class Model:
    cfg: ModelConfig
    init: Callable            # (generator, device=None) -> params (an LM)
    forward: Callable         # (params, batch, mode) -> (logits, caches, aux)
    prefill: Callable         # (params, batch) -> (last_logits, caches)
    decode_step: Callable     # (params, caches, batch) -> (logits, caches)
    init_cache: Callable      # (batch, seq_len, device=None) -> caches


def build_model(cfg: ModelConfig) -> Model:
    """``init`` and ``init_cache`` allocate on CUDA unless given a device,
    and raise where there is none; the generator must live on that
    device."""
    if cfg.family != "dense":
        raise NotImplementedError(
            f"the {cfg.family!r} family is not ported yet (ROADMAP.md)")
    return Model(
        cfg=cfg,
        init=lambda generator, device=None: tf_mod.init_lm(
            generator, cfg, resolve_device(device)),
        forward=lambda params, batch, mode="train": tf_mod.forward(
            params, cfg, batch, mode=mode),
        prefill=lambda params, batch: tf_mod.prefill(params, cfg, batch),
        decode_step=lambda params, caches, batch: tf_mod.decode_step(
            params, cfg, caches, batch),
        init_cache=lambda batch, seq_len, device=None: tf_mod.init_cache(
            cfg, batch, seq_len, resolve_device(device)),
    )
