"""Train and serve step builders and the dry-run's cell assembly
(``cell_structs``); port of ``repro/launch/step.py``.

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

Serving on a mesh: ``shard_params`` keeps the rank's shards of whole
parameters in the serving layout (``Model.serve_sharding``), and
``shard_batch`` the rank's part of a prefill or decode batch; the prefill
and decode steps take those.

``cell_structs(cfg, shape, mesh)`` builds a cell's step and the rank's
inputs on the meta device (shapes and dtypes, no storage), each leaf cut
by its resolved and sanitized spec: the train state by ``state_layout``,
the parameters of a serving cell by the serving layout, the caches by
``cache_specs`` (``init_cache`` on the mesh), the batch by
``input_partition_specs``.  What the reference reads as values is
shape-only here: ``pos`` is a Python int (the last slot), the kernels are
never reached (meta tensors take the plain path), and the MoE dispatch's
shapes depend on the capacity alone (its counts are a scatter-add), so a
meta run needs no ``FakeTensorMode``.
"""
from __future__ import annotations

from typing import Callable, Dict, NamedTuple, Optional, Tuple

import torch

from repro_torch.configs import ModelConfig, ShapeConfig
from repro_torch.device import resolve_device
from repro_torch.launch.mesh import P, local_slices, sanitize_spec
from repro_torch.models.parallel import sharding_for
from repro_torch.models.registry import (Model, build_model,
                                         input_partition_specs,
                                         input_structs)
from repro_torch.models.transformer import LM
from repro_torch.optim import (OptConfig, OptState, apply_updates, init_opt,
                               opt_specs)


class TrainState(NamedTuple):
    params: LM
    opt: OptState


def _kind(batch) -> ShapeConfig:
    """The cell kind and sizes of a global batch."""
    if "token" in batch:
        return ShapeConfig("batch", "decode", 1, batch["token"].shape[0])
    x = batch.get("tokens", batch.get("embeds"))
    kind = "train" if "labels" in batch else "prefill"
    return ShapeConfig("batch", kind, x.shape[1], x.shape[0])


def shard_batch(batch: Dict[str, torch.Tensor], cfg, mesh
                ) -> Dict[str, torch.Tensor]:
    """This rank's part of a global train, prefill or decode batch, split
    over the batch axes by ``input_partition_specs`` (a batch that does
    not divide is kept whole, as the specs' sanitizing replicates it);
    ``pos`` passes through."""
    # the templates' "data", which the sanitizing resolves to the mesh's
    # batch axes
    specs = input_partition_specs(cfg, _kind(batch))
    return {k: x if not torch.is_tensor(x) else x[local_slices(
        sanitize_spec(specs[k], tuple(x.shape), mesh), x.shape, mesh)]
        for k, x in batch.items()}


def _step(model: Model, opt_cfg: OptConfig):
    """The train step on the rank's part of the batch."""
    par = model.sharding

    def step(state: TrainState, batch) -> Tuple[TrainState, Dict]:
        names, leaves = zip(*state.params.named_parameters())
        with torch.enable_grad():
            loss, metrics = model.loss(state.params, batch)
            grads = torch.autograd.grad(loss, leaves, allow_unused=True)
        params, opt, om = apply_updates(
            state.params, dict(zip(names, grads)), state.opt, opt_cfg,
            norm=None if par is None else par.grad_norm)
        metrics = {k: v.detach() for k, v in metrics.items()}
        return TrainState(params, opt), {**metrics, **om}

    return step


def make_train_step(model: Model, opt_cfg: OptConfig):
    """The step on the global batch (each rank keeps its part on a
    mesh)."""
    step = _step(model, opt_cfg)

    def train_step(state: TrainState, batch) -> Tuple[TrainState, Dict]:
        if model.sharding is not None:
            batch = shard_batch(batch, model.cfg, model.mesh)
        return step(state, batch)

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


def shard_params(params, mesh, serve: bool = True):
    """Keep this rank's shards of whole parameters in place (their
    ``.data``), in the serving layout (``serve``) or the train one; a leaf
    the layout does not split stays the same tensor.  Returns
    ``params``."""
    par = sharding_for(params.cfg, mesh, serve)
    with torch.no_grad():
        for n, p in params.named_parameters():
            p.data = par.shard(n, p.data)
    return params


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


# ---------------------------------------------------------------------------
# dry-run cell assembly (meta tensors, no storage)
# ---------------------------------------------------------------------------


def _meta_params(model: Model, serve: bool):
    """The rank's shards of the parameters on the meta device."""
    params = model.init(torch.Generator(), device="meta")
    if model.mesh is not None:
        shard_params(params, model.mesh, serve)
    return params


def cell_structs(cfg: ModelConfig, shape: ShapeConfig, mesh
                 ) -> Tuple[Callable, tuple, Model]:
    """(step, the rank's inputs, model) of one cell on ``mesh`` (or
    ``None``: one process), every tensor on the meta device:

    train  : ``step(state, batch)``, the state's parameters, m and v cut
             by ``state_layout``;
    prefill: ``step(params, batch)``, the parameters in the serving
             layout;
    decode : ``step(params, caches, batch)``, the caches
             ``init_cache(global_batch, seq_len)`` on the mesh (the
             rank's shard of ``cache_specs``), ``pos`` the last slot.

    The batch is the rank's part of ``input_structs``.  A step that runs on
    these counts FLOPs and collectives without touching storage."""
    model = build_model(cfg, mesh)
    batch = input_structs(cfg, shape)
    if mesh is not None:
        batch = shard_batch(batch, cfg, mesh)
    if shape.kind == "train":
        params = trainable(_meta_params(model, serve=False))
        state = TrainState(params, init_opt(params))
        return _step(model, OptConfig()), (state, batch), model
    params = _meta_params(model, serve=True)
    if shape.kind == "prefill":
        return make_prefill_step(model), (params, batch), model
    caches = model.init_cache(shape.global_batch, shape.seq_len,
                              device="meta")
    return make_decode_step(model), (params, caches, batch), model
