"""Process groups of the mesh path: start, query and end the default
``torch.distributed`` group.

It has no counterpart in the JAX package: there one process drives every
device and XLA's SPMD partitioner inserts the collectives, where the port
runs one process a device and calls them itself (``launch.mesh``).  Three
ways in:

* ``torchrun`` (``init()`` with no arguments reads ``RANK``,
  ``WORLD_SIZE``, ``MASTER_ADDR`` and ``MASTER_PORT`` through ``env://``);
* a ``file://`` store, as the CPU tests spawn their ranks
  (``init("gloo", init_method="file://...", rank=r, world_size=n)``);
* a store object, as ``chip_smoke.py`` starts a world of one
  (``init("nccl", store=HashStore(), rank=0, world_size=1)``).

The backend defaults to NCCL where CUDA is available, else gloo.
"""
from __future__ import annotations

import os
from typing import Optional

import torch
import torch.distributed as dist


def init(backend: Optional[str] = None, *, init_method: Optional[str] = None,
         store=None, rank: Optional[int] = None,
         world_size: Optional[int] = None) -> None:
    """Start the default process group; with neither ``init_method`` nor
    ``store``, from torchrun's environment."""
    if backend is None:
        backend = "nccl" if torch.cuda.is_available() else "gloo"
    kw = {}
    if store is not None:
        kw["store"] = store
    else:
        kw["init_method"] = init_method or "env://"
    if rank is not None:
        kw["rank"] = rank
    if world_size is not None:
        kw["world_size"] = world_size
    dist.init_process_group(backend, **kw)


def destroy() -> None:
    """End the default process group (and every group made from it)."""
    if dist.is_initialized():
        dist.destroy_process_group()


def rank() -> int:
    return dist.get_rank() if dist.is_initialized() else 0


def world_size() -> int:
    return dist.get_world_size() if dist.is_initialized() else 1


def local_device(device_type: str) -> torch.device:
    """This process's device: ``cuda:LOCAL_RANK`` (torchrun's variable, 0
    without it), made the current CUDA device, or the CPU."""
    if device_type == "cpu":
        return torch.device("cpu")
    index = int(os.environ.get("LOCAL_RANK", "0"))
    torch.cuda.set_device(index)
    return torch.device("cuda", index)
