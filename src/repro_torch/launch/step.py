"""Train and serve step builders; port of ``repro/launch/step.py`` (the
JAX package's dry-run cell assembly, ``cell_structs``, is mesh and HLO
work that waits for the multi-card slice).

Training: ``TrainState`` holds the parameters (an ``LM`` with every leaf
requiring grad) and the optimizer state; ``make_train_step`` returns the
reference's step, ``loss`` and its gradients (``torch.autograd.grad`` of
``Model.loss``, a zero for a leaf the loss does not reach) and one AdamW
update, the parameters, m and v updated in place.
"""
from __future__ import annotations

from typing import Dict, NamedTuple, Tuple

import torch

from repro_torch.device import resolve_device
from repro_torch.models.registry import Model
from repro_torch.models.transformer import LM
from repro_torch.optim import OptConfig, OptState, apply_updates, init_opt


class TrainState(NamedTuple):
    params: LM
    opt: OptState


def make_train_step(model: Model, opt_cfg: OptConfig):
    def train_step(state: TrainState, batch) -> Tuple[TrainState, Dict]:
        names, leaves = zip(*state.params.named_parameters())
        with torch.enable_grad():
            loss, metrics = model.loss(state.params, batch)
            grads = torch.autograd.grad(loss, leaves, allow_unused=True)
        params, opt, om = apply_updates(state.params, dict(zip(names, grads)),
                                        state.opt, opt_cfg)
        metrics = {k: v.detach() for k, v in metrics.items()}
        return TrainState(params, opt), {**metrics, **om}

    return train_step


def trainable(params: LM) -> LM:
    """Every leaf of ``params`` requiring grad (the serving paths keep
    them frozen); returns ``params``."""
    return params.requires_grad_(True)


def init_train_state(model: Model, generator: torch.Generator,
                     device=None) -> TrainState:
    """Random parameters from ``generator`` (on the card unless ``device``
    says otherwise) and a zero optimizer state."""
    params = trainable(model.init(generator, device=resolve_device(device)))
    return TrainState(params, init_opt(params))


# ---------------------------------------------------------------------------
# serve steps
# ---------------------------------------------------------------------------


def make_prefill_step(model: Model):
    def prefill_step(params, batch):
        with torch.inference_mode():
            return model.prefill(params, batch)
    return prefill_step


def make_decode_step(model: Model):
    """The step writes the new token's k/v into ``caches`` in place."""
    def decode_step(params, caches, batch):
        with torch.inference_mode():
            return model.decode_step(params, caches, batch)
    return decode_step
