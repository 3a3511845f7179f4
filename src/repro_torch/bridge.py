"""State carried between the JAX reference and the port, through numpy.

``state_from_numpy`` takes the reference's ``init_state`` pytree (or a
state after some epochs) as numpy arrays and returns the port's state: the
same keys, dtypes kept (bool, int32, float32), a leading run axis added
where the reference state has none.  ``state_to_numpy`` goes the other
way.  A test can so take the reference's state after e epochs, step one
epoch in both packages with the same key, and compare: that is how a
divergence is located.
"""
from __future__ import annotations

from typing import Dict

import numpy as np
import torch

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
