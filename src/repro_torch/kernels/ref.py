"""Plain PyTorch versions of the port's kernels: the oracles the CUDA
kernels are held against, and the CPU path.  Arithmetic is op for op that of
``repro/kernels/ref.py``.

* The diffusive φ update: the candidate ``d_tx + 1/φ_k``, a max over the
  row, the degree counted as an f32 sum of ``d_tx > NEG/2``, then
  ``(1/F + max) / (deg + 1)``, or ``1/F`` where the degree is 0.  A max, an
  exact count and one IEEE division leave no room for rounding differences,
  so the kernels must equal these bit for bit.
* Attention (flash and decode): the score product in the input dtype, cast
  to f32 and divided by √hd, masked with NEG = -1e30, an f32 softmax, and
  ``p`` cast to v's dtype for the second product.  The kernels keep scores
  and ``p`` in f32 throughout (as the Pallas kernels do), so they agree
  with these to the reference's tolerances: 3e-5 in f32, 2e-2 in bf16.
"""
from __future__ import annotations

import math

import torch

NEG = -1e30


def _combine(inv_phi: torch.Tensor, F: torch.Tensor, cand: torch.Tensor,
             d_tx_masked: torch.Tensor) -> torch.Tensor:
    worst = cand.amax(dim=-1)
    deg = (d_tx_masked > NEG / 2).to(inv_phi.dtype).sum(dim=-1)
    inv_new = (1.0 / F + worst) / (deg + 1.0)
    return torch.where(deg > 0, inv_new, 1.0 / F)


def diffusive_phi(inv_phi: torch.Tensor, F: torch.Tensor,
                  d_tx_masked: torch.Tensor) -> torch.Tensor:
    """Eq. 10, dense.  inv_phi [.., N] (s/GFLOP), F [.., N], d_tx_masked
    [.., N, N] with NEG off-link.  Returns inv_phi' [.., N]."""
    cand = d_tx_masked + inv_phi[..., None, :]
    return _combine(inv_phi, F, cand, d_tx_masked)


def diffusive_phi_sparse(inv_phi: torch.Tensor, F: torch.Tensor,
                         d_tx_masked: torch.Tensor,
                         nbr: torch.Tensor) -> torch.Tensor:
    """Eq. 10 over neighbour lists.  inv_phi [R, N], F [R, N], d_tx_masked
    [R, N, K] (NEG on invalid/off-link slots), nbr [R, N, K] int32 (0 on
    invalid slots).  Returns inv_phi' [R, N]."""
    R, N, K = d_tx_masked.shape
    p = torch.gather(inv_phi, 1, nbr.reshape(R, N * K).long()).view(R, N, K)
    return _combine(inv_phi, F, d_tx_masked + p, d_tx_masked)


def flash_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, *,
                    causal: bool = True, window: int = 0) -> torch.Tensor:
    """q [B,Sq,Hq,hd], k/v [B,Sk,Hkv,hd] -> [B,Sq,Hq,hd] (f32 softmax).
    Query head h reads kv head h // (Hq/Hkv); positions count from 0."""
    B, Sq, Hq, hd = q.shape
    Sk, Hkv = k.shape[1], k.shape[2]
    G = Hq // Hkv
    qg = q.reshape(B, Sq, Hkv, G, hd)
    s = torch.einsum("bqkgd,bskd->bkgqs", qg, k).float() / math.sqrt(hd)
    qpos = torch.arange(Sq, device=q.device)[:, None]
    kpos = torch.arange(Sk, device=q.device)[None, :]
    keep = torch.ones((Sq, Sk), dtype=torch.bool, device=q.device)
    if causal:
        keep &= qpos >= kpos
    if window and window > 0:
        keep &= (qpos - kpos) < window
    s = torch.where(keep, s, NEG)
    p = torch.softmax(s, dim=-1).to(v.dtype)
    o = torch.einsum("bkgqs,bskd->bqkgd", p, v)
    return o.reshape(B, Sq, Hq, hd)


def decode_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                     pos: int, *, window: int = 0) -> torch.Tensor:
    """q [B,Hq,hd]; k/v [B,S,Hkv,hd]; attend to slots k_idx <= pos (and
    pos - k_idx < window where a window is set) -> [B,Hq,hd]."""
    B, Hq, hd = q.shape
    S, Hkv = k.shape[1], k.shape[2]
    G = Hq // Hkv
    qg = q.reshape(B, Hkv, G, hd)
    s = torch.einsum("bkgd,bskd->bkgs", qg, k).float() / math.sqrt(hd)
    kpos = torch.arange(S, device=q.device)
    keep = kpos <= pos
    if window and window > 0:
        keep &= (pos - kpos) < window
    s = torch.where(keep, s, NEG)
    p = torch.softmax(s, dim=-1).to(v.dtype)
    o = torch.einsum("bkgs,bskd->bkgd", p, v)
    return o.reshape(B, Hq, hd)
