"""Dispatch between the hand-written CUDA kernels and their plain versions.

The device decides: a CPU tensor goes to ``ref.py``, a CUDA tensor to the
kernel, which launches or raises.  There is no environment switch and no
fallback from a failed kernel to the plain version.  ``reference()`` is a
scoped exception for holding a whole path kernel-against-plain on the card
(``chip_smoke.py`` and the tests): inside it, CUDA tensors take the plain
version too.

Gradients.  On the plain path autograd differentiates the plain versions.
On the card ``flash_attention``, ``rmsnorm``, ``rglru_scan`` and
``mamba_scan_with_state`` are ``torch.autograd.Function``s
(``FlashAttention``, ``RMSNorm``, ``RGLRUScan``, ``MambaScan``) whose
forward is the forward kernel and whose backward is the hand-written
backward kernel (``flash_attention_bwd``, ``rmsnorm_bwd``,
``rglru_scan_bwd``, ``mamba_scan_bwd``); each takes its forward and
backward as arguments, so the tests can run the same wiring on the CPU
with the plain versions.  Under autograd the Mamba forward is the kernel's
checkpointing entry point, whose state checkpoints the backward kernel
starts its chunks from; without it (serving), the Pallas-contract entry
point.  The φ kernels and decode attention (both entry points) have no
backward kernel: on a CUDA input they raise where grad mode is on and an
input requires grad, rather than hand autograd an output with no history
and let a gradient be lost without a word.
"""
from __future__ import annotations

import contextlib
import contextvars

import torch

from repro_torch.kernels import decode_attention as _decode
from repro_torch.kernels import diffusive_phi as _phi
from repro_torch.kernels import flash_attention as _flash
from repro_torch.kernels import flash_attention_bwd as _flash_bwd
from repro_torch.kernels import mamba_scan as _mamba
from repro_torch.kernels import mamba_scan_bwd as _mamba_bwd
from repro_torch.kernels import ref
from repro_torch.kernels import rglru_scan as _rglru
from repro_torch.kernels import rglru_scan_bwd as _rglru_bwd
from repro_torch.kernels import rmsnorm as _rmsnorm
from repro_torch.kernels import rmsnorm_bwd as _rmsnorm_bwd

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
    """The CPU, the meta device (the dry-run's shapes) or ``reference()``
    take the plain versions."""
    return t.device.type in ("cpu", "meta") or _FORCE_REFERENCE.get()


def takes_kernel(t: torch.Tensor) -> bool:
    """Whether an op on ``t`` launches a CUDA kernel here (a caller whose
    own plain path differs from ``ref.py``'s asks this first)."""
    return not _plain(t)


def no_backward(name: str, *inputs: torch.Tensor) -> None:
    """Raise where autograd would record ``name``'s kernel: its output
    would carry no history back to these inputs."""
    if torch.is_grad_enabled() and any(t.requires_grad for t in inputs):
        raise NotImplementedError(
            f"{name} has no backward kernel on the card; run it without "
            f"gradients, or on the CPU")


class FlashAttention(torch.autograd.Function):
    """o = fwd(q, k, v); (dq, dk, dv) = bwd(q, k, v, o, do).  Saves q, k, v
    and o; the backward recomputes the rows' statistics itself."""

    @staticmethod
    def forward(ctx, q, k, v, causal, window, fwd, bwd):
        o = fwd(q, k, v, causal=causal, window=window)
        ctx.save_for_backward(q, k, v, o)
        ctx.causal, ctx.window, ctx.bwd = causal, window, bwd
        return o

    @staticmethod
    def backward(ctx, do):
        q, k, v, o = ctx.saved_tensors
        dq, dk, dv = ctx.bwd(q, k, v, o, do.contiguous(), causal=ctx.causal,
                             window=ctx.window)
        return dq, dk, dv, None, None, None, None


class RMSNorm(torch.autograd.Function):
    """y = fwd(x, scale, eps); (dx, dscale) = bwd(x, scale, dy, eps), scale
    float32 for both and dscale cast back to the leaf's dtype."""

    @staticmethod
    def forward(ctx, x, scale, eps, fwd, bwd):
        ctx.save_for_backward(x, scale)
        ctx.eps, ctx.bwd = eps, bwd
        return fwd(x, scale.float(), eps)

    @staticmethod
    def backward(ctx, dy):
        x, scale = ctx.saved_tensors
        dx, dscale = ctx.bwd(x, scale.float(), dy.contiguous(), ctx.eps)
        return dx, dscale.to(scale.dtype), None, None, None


class RGLRUScan(torch.autograd.Function):
    """h = fwd(a, b); (da, db) = bwd(a, h, dh).  Saves a and h."""

    @staticmethod
    def forward(ctx, a, b, fwd, bwd):
        h = fwd(a, b)
        ctx.save_for_backward(a, h)
        ctx.bwd = bwd
        return h

    @staticmethod
    def backward(ctx, dh):
        a, h = ctx.saved_tensors
        da, db = ctx.bwd(a, h, dh.contiguous())
        return da, db, None, None


class MambaScan(torch.autograd.Function):
    """(y, h_last, h_chk) = fwd(a, b, C); (da, db, dC) = bwd(a, b, C, dy,
    dh_last, h_chk), which recomputes h chunk by chunk from the forward's
    state checkpoints h_chk.  Saves a, b, C and h_chk.  A cotangent that no
    loss reaches comes as ``None`` (``h_last`` in training): no zeros are
    made for it."""

    @staticmethod
    def forward(ctx, a, b, C, fwd, bwd):
        ctx.set_materialize_grads(False)
        y, h_last, h_chk = fwd(a, b, C)
        ctx.save_for_backward(a, b, C, h_chk)
        ctx.bwd = bwd
        return y, h_last

    @staticmethod
    def backward(ctx, dy, dh_last):
        a, b, C, h_chk = ctx.saved_tensors
        if dy is None:
            dy = a.new_zeros(a.shape[:3])
        da, db, dC = ctx.bwd(a, b, C, dy.contiguous(),
                             None if dh_last is None
                             else dh_last.contiguous(), h_chk)
        return da, db, dC, None, None


def diffusive_phi(inv_phi, F, d_tx_masked):
    if _plain(inv_phi):
        return ref.diffusive_phi(inv_phi, F, d_tx_masked)
    no_backward("diffusive_phi", inv_phi, F, d_tx_masked)
    return _phi.diffusive_phi(inv_phi, F, d_tx_masked)


def phi_update(phi, F, adj, d_tx):
    if _plain(phi):
        return ref.phi_update(phi, F, adj, d_tx)
    no_backward("phi_update", phi, F, d_tx)
    return _phi.phi_update(phi, F, adj, d_tx)


def phi_update_sparse(phi, F, adj_e, nbr, d_tx_e):
    if _plain(phi):
        return ref.phi_update_sparse(phi, F, adj_e, nbr, d_tx_e)
    no_backward("phi_update_sparse", phi, F, d_tx_e)
    return _phi.phi_update_sparse(phi, F, adj_e, nbr, d_tx_e)


def diffusive_phi_sparse(inv_phi, F, d_tx_masked, nbr):
    if _plain(inv_phi):
        return ref.diffusive_phi_sparse(inv_phi, F, d_tx_masked, nbr)
    no_backward("diffusive_phi_sparse", inv_phi, F, d_tx_masked)
    return _phi.diffusive_phi_sparse(inv_phi, F, d_tx_masked, nbr)


def flash_attention(q, k, v, *, causal=True, window=0):
    if _plain(q):
        return ref.flash_attention(q, k, v, causal=causal, window=window)
    return FlashAttention.apply(q, k, v, causal, window,
                                _flash.flash_attention,
                                _flash_bwd.flash_attention_bwd)


def decode_attention(q, k, v, pos, *, window=0):
    if _plain(q):
        return ref.decode_attention(q, k, v, pos, window=window)
    no_backward("decode_attention", q, k, v)
    return _decode.decode_attention(q, k, v, pos, window=window)


def decode_attention_partial(q, k, v, lo, hi):
    if _plain(q):
        return ref.decode_attention_partial(q, k, v, lo, hi)
    no_backward("decode_attention_partial", q, k, v)
    return _decode.decode_attention_partial(q, k, v, lo, hi)


def rmsnorm(x, scale, eps=1e-6):
    if _plain(x):
        return ref.rmsnorm(x, scale, eps)
    return RMSNorm.apply(x, scale, eps, _rmsnorm.rmsnorm,
                         _rmsnorm_bwd.rmsnorm_bwd)


def rglru_scan(a, b):
    if _plain(a):
        return ref.rglru_scan(a, b)
    return RGLRUScan.apply(a, b, _rglru.rglru_scan, _rglru_bwd.rglru_scan_bwd)


def mamba_scan(a, b, C):
    """y only, as the Pallas kernel returns it."""
    return mamba_scan_with_state(a, b, C)[0]


def mamba_scan_with_state(a, b, C):
    """(y, h_last): the scan of ``mamba_scan`` and its last state.  Where
    autograd records it, the forward kernel also keeps the state
    checkpoints that its backward kernel starts from."""
    if _plain(a):
        return ref.mamba_scan_with_state(a, b, C)
    if not (torch.is_grad_enabled()
            and any(t.requires_grad for t in (a, b, C))):
        return _mamba.mamba_scan_with_state(a, b, C)
    return MambaScan.apply(a, b, C, _mamba.mamba_scan_with_checkpoints,
                           _mamba_bwd.mamba_scan_bwd)
