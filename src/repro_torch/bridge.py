"""State and weights carried between the JAX reference and the port,
through numpy.

``state_from_numpy`` takes the reference's ``init_state`` pytree (or a
state after some epochs) as numpy arrays and returns the port's state: the
same keys, dtypes kept (bool, int32, float32), a leading run axis added
where the reference state has none.  ``state_to_numpy`` goes the other
way.  A test can so take the reference's state after e epochs, step one
epoch in both packages with the same key, and compare: that is how a
divergence is located.

``params_from_numpy`` takes the reference's ``init_lm`` pytree as numpy and
returns the port's ``LM`` module on those weights; ``params_to_numpy``
goes back.  Every leaf keeps its JAX layout (``wq [d,Hq,hd]``, ``wo
[Hq,hd,d]``, ``w_gate [d,ff]``, ...); the only change is that the stacked
``[L, ...]`` leaves of ``layers`` are split into one dict per layer.  Both
are exact copies.
"""
from __future__ import annotations

from typing import Dict

import numpy as np
import torch
from torch import nn

from repro_torch.models.common import param_dict
from repro_torch.models.transformer import LM

_DTYPES = {np.dtype(np.bool_): torch.bool, np.dtype(np.int32): torch.int32,
           np.dtype(np.float32): torch.float32,
           np.dtype(np.uint32): torch.uint32}


def _to_torch(a, device, batched: bool) -> torch.Tensor:
    a = np.asarray(a)
    if a.dtype not in _DTYPES:
        raise TypeError(f"unsupported dtype {a.dtype} in a swarm state")
    if not batched:
        a = a[None]
    return torch.from_numpy(np.ascontiguousarray(a)).to(device)


def state_from_numpy(state: Dict, device="cpu") -> Dict:
    """numpy state dict (nested dicts allowed) -> torch state with a run
    axis.  A state whose ``q_active`` is [N, Q] has no run axis; one whose
    ``q_active`` is [R, N, Q] has."""
    batched = np.ndim(state["q_active"]) == 3

    def conv(v):
        if isinstance(v, dict):
            return {k: conv(x) for k, x in v.items()}
        return _to_torch(v, device, batched)

    return {k: conv(v) for k, v in state.items()}


def state_to_numpy(state: Dict) -> Dict:
    """torch state -> nested dict of numpy arrays (run axis kept)."""
    return {k: state_to_numpy(v) if isinstance(v, dict)
            else v.detach().cpu().numpy() for k, v in state.items()}


def key_from_numpy(key) -> torch.Tensor:
    """A raw jax key (uint32 [..., 2], as numpy) -> the port's key."""
    return torch.from_numpy(np.array(key, dtype=np.uint32))


def _leaf(a, device) -> torch.Tensor:
    a = np.asarray(a)
    if a.dtype != np.float32:
        raise TypeError(f"unsupported dtype {a.dtype} in LM parameters")
    return torch.from_numpy(np.array(a)).to(device)


def _leaves(tree: Dict, device) -> Dict:
    return {k: _leaves(v, device) if isinstance(v, dict) else _leaf(v, device)
            for k, v in tree.items()}


def params_from_numpy(tree: Dict, cfg, device="cpu"):
    """The reference's LM parameter pytree (numpy float32 leaves) -> the
    port's ``LM`` module, weights copied exactly."""
    t = _leaves(tree, device)
    layers = [nn.ModuleDict({
        name: param_dict(**{k: v[i] for k, v in sub.items()})
        for name, sub in t["layers"].items()})
        for i in range(cfg.num_layers)]
    return LM(cfg, t["embed"], layers, param_dict(**t["final_norm"]),
              t.get("lm_head"))


def params_to_numpy(lm) -> Dict:
    """The port's ``LM`` module -> the reference's pytree layout, numpy,
    with each layer's leaves stacked on a leading [L] axis."""
    def np_(x):
        return x.detach().cpu().numpy()

    names = lm.layers[0].keys()
    tree = {"embed": np_(lm.embed),
            "layers": {name: {k: np.stack([np_(layer[name][k])
                                           for layer in lm.layers])
                              for k in lm.layers[0][name].keys()}
                       for name in names},
            "final_norm": {k: np_(v) for k, v in lm.final_norm.items()}}
    if lm.lm_head is not None:
        tree["lm_head"] = np_(lm.lm_head)
    return tree
