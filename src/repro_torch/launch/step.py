"""Train and serve step builders; port of ``repro/launch/step.py``.  Its
dry-run cell assembly (``cell_structs``) waits for the port's dry-run
(ROADMAP queue 1).

Training: ``TrainState`` holds the parameters (an ``LM`` with every leaf
requiring grad) and the optimizer state; ``make_train_step`` returns the
reference's step, ``loss`` and its gradients (``torch.autograd.grad`` of
``Model.loss``, a zero for a leaf the loss does not reach) and one AdamW
update, the parameters, m and v updated in place.

On a mesh (``build_model(cfg, mesh)``) every rank holds its shards of the
state (``shard_train_state``: each parameter, m and v cut by the layout of
``models.parallel.Sharding``); the step takes the global batch, keeps the
rank's part along the batch axes (``shard_batch``, by
``input_partition_specs``), and its loss is the global batch's mean; the
clip's norm is ``optim.global_norm_sharded``.  ``gather_train_state``
gives the whole leaves back.  ``train_state_specs`` are the templates, as
the reference's; ``state_layout`` the specs the shards are cut by.
"""
from __future__ import annotations

from typing import Dict, NamedTuple, Optional, Tuple

import torch

from repro_torch.configs import ShapeConfig
from repro_torch.device import resolve_device
from repro_torch.launch.mesh import (P, batch_axes_of, local_slices,
                                     resolve_spec)
from repro_torch.models.parallel import sharding_for
from repro_torch.models.registry import Model, input_partition_specs
from repro_torch.models.transformer import LM
from repro_torch.optim import (OptConfig, OptState, apply_updates, init_opt,
                               opt_specs)


class TrainState(NamedTuple):
    params: LM
    opt: OptState


def shard_batch(batch: Dict[str, torch.Tensor], cfg, mesh
                ) -> Dict[str, torch.Tensor]:
    """This rank's part of a global train batch, split over the batch axes
    by ``input_partition_specs``; the batch must divide evenly."""
    B, S = batch["labels"].shape
    specs = input_partition_specs(cfg, ShapeConfig("batch", "train", S, B),
                                  batch_axes_of(mesh))
    return {k: x[local_slices(resolve_spec(specs[k], mesh), x.shape, mesh)]
            for k, x in batch.items()}


def make_train_step(model: Model, opt_cfg: OptConfig):
    par = model.sharding

    def train_step(state: TrainState, batch) -> Tuple[TrainState, Dict]:
        if par is not None:
            batch = shard_batch(batch, model.cfg, model.mesh)
        names, leaves = zip(*state.params.named_parameters())
        with torch.enable_grad():
            loss, metrics = model.loss(state.params, batch)
            grads = torch.autograd.grad(loss, leaves, allow_unused=True)
        params, opt, om = apply_updates(
            state.params, dict(zip(names, grads)), state.opt, opt_cfg,
            norm=None if par is None else par.grad_norm)
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
    says otherwise) and a zero optimizer state; on the model's mesh, the
    rank's shards of them."""
    params = trainable(model.init(generator, device=resolve_device(device)))
    state = TrainState(params, init_opt(params))
    if model.sharding is not None:
        state = shard_train_state(state, model.mesh)
    return state


# ---------------------------------------------------------------------------
# the train state on a mesh
# ---------------------------------------------------------------------------


def train_state_specs(model: Model) -> TrainState:
    """The templates of a train state (the reference's)."""
    ps = model.specs()
    return TrainState(ps, opt_specs(ps))


def state_layout(cfg, mesh) -> Dict[str, P]:
    """The specs the shards of a train state are cut by on ``mesh``, by
    ``checkpoint.flatten``'s names."""
    specs = sharding_for(cfg, mesh).specs
    out = dict(specs)
    out["opt/step"] = P()
    for kind in ("m", "v"):
        out.update({f"opt/{kind}/{n}": s for n, s in specs.items()})
    return out


def shard_train_state(state: TrainState, mesh) -> TrainState:
    """Keep this rank's shards of a whole train state: the parameters in
    place (their ``.data``), m and v in a new ``OptState``.  A leaf the
    layout does not split stays the same tensor."""
    par = sharding_for(state.params.cfg, mesh)
    with torch.no_grad():
        for n, p in state.params.named_parameters():
            p.data = par.shard(n, p.data)
        m = {n: par.shard(n, t) for n, t in state.opt.m.items()}
        v = {n: par.shard(n, t) for n, t in state.opt.v.items()}
    return TrainState(state.params, OptState(state.opt.step, m, v))


def gather_train_state(state: TrainState, mesh, dst: Optional[int] = None
                       ) -> Optional[TrainState]:
    """The whole leaves of a sharded train state: a ``TrainState`` whose
    ``params`` is ``{name: tensor}``, on every rank (``dst=None``) or on
    rank ``dst`` alone (``None`` elsewhere)."""
    par = sharding_for(state.params.cfg, mesh)
    with torch.no_grad():
        params = {n: par.unshard(n, p.detach())
                  for n, p in state.params.named_parameters()}
        m = {n: par.unshard(n, t) for n, t in state.opt.m.items()}
        v = {n: par.unshard(n, t) for n, t in state.opt.v.items()}
    if dst is not None and mesh.index(mesh.axis_names) != dst:
        return None
    return TrainState(params, OptState(state.opt.step, m, v))


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
