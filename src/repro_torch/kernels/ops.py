"""Dispatch between the hand-written CUDA kernels and their plain versions.

The device decides: a CPU tensor goes to ``ref.py``, a CUDA tensor to the
kernel, which launches or raises.  There is no environment switch and no
fallback from a failed kernel to the plain version.  ``reference()`` is a
scoped exception for holding a whole path kernel-against-plain on the card
(``chip_smoke.py`` and the tests): inside it, CUDA tensors take the plain
version too.
"""
from __future__ import annotations

import contextlib
import contextvars

import torch

from repro_torch.kernels import decode_attention as _decode
from repro_torch.kernels import diffusive_phi as _phi
from repro_torch.kernels import flash_attention as _flash
from repro_torch.kernels import mamba_scan as _mamba
from repro_torch.kernels import ref
from repro_torch.kernels import rglru_scan as _rglru
from repro_torch.kernels import rmsnorm as _rmsnorm

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


def takes_kernel(t: torch.Tensor) -> bool:
    """Whether an op on ``t`` launches a CUDA kernel here (a caller whose
    own plain path differs from ``ref.py``'s asks this first)."""
    return not _plain(t)


def diffusive_phi(inv_phi, F, d_tx_masked):
    if _plain(inv_phi):
        return ref.diffusive_phi(inv_phi, F, d_tx_masked)
    return _phi.diffusive_phi(inv_phi, F, d_tx_masked)


def phi_update(phi, F, adj, d_tx):
    if _plain(phi):
        return ref.phi_update(phi, F, adj, d_tx)
    return _phi.phi_update(phi, F, adj, d_tx)


def phi_update_sparse(phi, F, adj_e, nbr, d_tx_e):
    if _plain(phi):
        return ref.phi_update_sparse(phi, F, adj_e, nbr, d_tx_e)
    return _phi.phi_update_sparse(phi, F, adj_e, nbr, d_tx_e)


def diffusive_phi_sparse(inv_phi, F, d_tx_masked, nbr):
    if _plain(inv_phi):
        return ref.diffusive_phi_sparse(inv_phi, F, d_tx_masked, nbr)
    return _phi.diffusive_phi_sparse(inv_phi, F, d_tx_masked, nbr)


def flash_attention(q, k, v, *, causal=True, window=0):
    if _plain(q):
        return ref.flash_attention(q, k, v, causal=causal, window=window)
    return _flash.flash_attention(q, k, v, causal=causal, window=window)


def decode_attention(q, k, v, pos, *, window=0):
    if _plain(q):
        return ref.decode_attention(q, k, v, pos, window=window)
    return _decode.decode_attention(q, k, v, pos, window=window)


def rmsnorm(x, scale, eps=1e-6):
    if _plain(x):
        return ref.rmsnorm(x, scale, eps)
    return _rmsnorm.rmsnorm(x, scale.float(), eps)


def rglru_scan(a, b):
    if _plain(a):
        return ref.rglru_scan(a, b)
    return _rglru.rglru_scan(a, b)


def mamba_scan(a, b, C):
    """y only, as the Pallas kernel returns it."""
    return mamba_scan_with_state(a, b, C)[0]


def mamba_scan_with_state(a, b, C):
    """(y, h_last): the scan of ``mamba_scan`` and its last state."""
    if _plain(a):
        return ref.mamba_scan_with_state(a, b, C)
    return _mamba.mamba_scan_with_state(a, b, C)
