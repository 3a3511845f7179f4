"""Atomic step checkpoints of a dict of numpy arrays: the part of
``repro/checkpoint/ckpt.py`` that ``fleet/store.py`` needs (the chunk
checkpoints of a streaming sweep point), a copy, since that module imports
jax.

Layout:  <dir>/step_<k>/
            manifest.json       — step, leaf names, per-leaf dtype/shape,
                                  the caller's ``extra``
            arrays.npz          — the leaves

  * atomic publish: write to ``step_<k>.tmp`` then rename — a crashed writer
    never corrupts the latest checkpoint;
  * retention: keep the newest ``keep`` checkpoints.

Torch tensors are copied to the host on save; restore returns numpy.  The
reference's pytrees and its mesh re-sharding on restore come with the
training slice.
"""
from __future__ import annotations

import json
import os
import shutil
import time
from typing import Dict, List, Optional, Tuple

import numpy as np


def _host(x) -> np.ndarray:
    if hasattr(x, "detach"):                 # a torch tensor
        x = x.detach().cpu().numpy()
    return np.asarray(x)


def save(ckpt_dir: str, step: int, tree: Dict, *, keep: int = 3,
         extra: Optional[Dict] = None) -> str:
    """Atomically persist ``tree`` (a dict of arrays or tensors)."""
    os.makedirs(ckpt_dir, exist_ok=True)
    final = os.path.join(ckpt_dir, f"step_{step:08d}")
    tmp = final + ".tmp"
    if os.path.exists(tmp):
        shutil.rmtree(tmp)
    os.makedirs(tmp)

    paths = sorted(tree)
    host = [_host(tree[k]) for k in paths]
    np.savez(os.path.join(tmp, "arrays.npz"),
             **{f"a{i}": v for i, v in enumerate(host)})
    manifest = {
        "step": step,
        "time": time.time(),
        "paths": paths,
        "shapes": [list(v.shape) for v in host],
        "dtypes": [str(v.dtype) for v in host],
        "extra": extra or {},
    }
    with open(os.path.join(tmp, "manifest.json"), "w") as f:
        json.dump(manifest, f)
    os.rename(tmp, final)

    # retention
    for s in all_steps(ckpt_dir)[:-keep]:
        shutil.rmtree(os.path.join(ckpt_dir, f"step_{s:08d}"),
                      ignore_errors=True)
    return final


def all_steps(ckpt_dir: str) -> List[int]:
    if not os.path.isdir(ckpt_dir):
        return []
    return sorted(int(d.split("_")[1]) for d in os.listdir(ckpt_dir)
                  if d.startswith("step_") and not d.endswith(".tmp"))


def latest_step(ckpt_dir: str) -> Optional[int]:
    steps = all_steps(ckpt_dir)
    return steps[-1] if steps else None


def restore(ckpt_dir: str, like: Dict, *, step: Optional[int] = None
            ) -> Tuple[Dict, Dict]:
    """Restore the arrays named by ``like``'s keys (its values are
    ignored); returns (dict of numpy arrays, manifest)."""
    step = latest_step(ckpt_dir) if step is None else step
    if step is None:
        raise FileNotFoundError(f"no checkpoints under {ckpt_dir}")
    d = os.path.join(ckpt_dir, f"step_{step:08d}")
    with open(os.path.join(d, "manifest.json")) as f:
        manifest = json.load(f)
    like_paths = sorted(like)
    if like_paths != manifest["paths"]:
        differing = set(manifest["paths"]) ^ set(like_paths)
        raise ValueError(f"checkpoint tree mismatch; differing: {differing}")
    with np.load(os.path.join(d, "arrays.npz")) as data:
        out = {k: data[f"a{i}"] for i, k in enumerate(manifest["paths"])}
    return out, manifest
