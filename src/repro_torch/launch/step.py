"""The serving steps ``make_prefill_step`` and ``make_decode_step``; port
of the serving half of ``repro/launch/step.py`` (training steps come with
the training slice)."""
from __future__ import annotations

import torch

from repro_torch.models.registry import Model


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
