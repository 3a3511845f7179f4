"""Dispatch between the hand-written CUDA kernels and their plain versions.

The device decides: a CPU tensor goes to ``ref.py``, a CUDA tensor to the
kernel, which launches or raises.  There is no environment switch and no
fallback from a failed kernel to the plain version.  ``reference()`` is a
scoped exception for holding the whole simulator kernel-against-plain on
the card (``chip_smoke.py`` and the tests): inside it, CUDA tensors take the
plain version too.
"""
from __future__ import annotations

import contextlib
import contextvars

import torch

from repro_torch.kernels import diffusive_phi as _cuda
from repro_torch.kernels import ref

_FORCE_REFERENCE = contextvars.ContextVar("force_reference", default=False)


@contextlib.contextmanager
def reference():
    """Route CUDA tensors to the plain PyTorch versions inside the block."""
    token = _FORCE_REFERENCE.set(True)
    try:
        yield
    finally:
        _FORCE_REFERENCE.reset(token)


def _plain(t: torch.Tensor) -> bool:
    return t.device.type == "cpu" or _FORCE_REFERENCE.get()


def diffusive_phi(inv_phi, F, d_tx_masked):
    if _plain(inv_phi):
        return ref.diffusive_phi(inv_phi, F, d_tx_masked)
    return _cuda.diffusive_phi(inv_phi, F, d_tx_masked)


def diffusive_phi_sparse(inv_phi, F, d_tx_masked, nbr):
    if _plain(inv_phi):
        return ref.diffusive_phi_sparse(inv_phi, F, d_tx_masked, nbr)
    return _cuda.diffusive_phi_sparse(inv_phi, F, d_tx_masked, nbr)
