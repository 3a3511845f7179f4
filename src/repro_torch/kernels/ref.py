"""Plain PyTorch versions of the port's kernels: the oracles the CUDA
kernels are held against, and the CPU path.  Arithmetic is op for op that of
``repro/kernels/ref.py``.

* The diffusive φ update: the candidate ``d_tx + 1/φ_k``, a max over the
  row, the degree counted as an f32 sum of ``d_tx > NEG/2``, then
  ``(1/F + max) / (deg + 1)``, or ``1/F`` where the degree is 0.  A max, an
  exact count and one IEEE division leave no room for rounding differences,
  so the kernels must equal these bit for bit, NaN for NaN (``amax``
  propagates NaN, and so do the kernels).  ``phi_update`` and
  ``phi_update_sparse`` are the whole dense and neighbour-list updates
  from φ, adjacency and delays (``core.diffusive`` takes these functions),
  the twins of the fused kernels, equally bit for bit.
* Attention (flash and decode): the score product in the input dtype, cast
  to f32 and divided by √hd, masked with NEG = -1e30, an f32 softmax, and
  ``p`` cast to v's dtype for the second product.  The kernels keep scores
  in f32 (as the Pallas kernels do); decode keeps ``p`` in f32 too, and
  bf16 flash rounds the unnormalised ``p`` to bf16 for its tensor-core
  product, as this version rounds the normalised one.  They agree with
  these to the reference's tolerances: 3e-5 in f32, 2e-2 in bf16.
* The scans (RG-LRU and Mamba): a sequential loop over S, each step a
  multiply then an add (two roundings, no FMA), and for Mamba the readout
  ``Σ_n h·C`` as one product.  The kernels repeat the state update rounding
  for rounding, so ``h`` agrees exactly; the readout sums in a fixed order
  of its own (rtol 2e-4, atol 3e-5, as test_kernels.py holds the Pallas
  kernel).
* Decode's partial (``decode_attention_partial``, the distributed
  flash-decode's): the scores as above, then exp(s - m) in f32 and the
  product with v in f32, normalised by the slice's own l; the kernel keeps
  p in f32 too and sums in other orders (3e-5 in f32, 2e-2 in bf16).
* RMSNorm: ``x · rsqrt(mean(x²) + eps) · scale`` in f32, returned in x's
  dtype; the kernel sums the squares in another order (3e-5 in f32, 2e-2
  in bf16).
* The two backward passes (``flash_attention_bwd``, ``rmsnorm_bwd``),
  which the JAX package has no kernel for (it differentiates its plain
  path): the gradients written out as explicit f32 math, returned in the
  input's dtype (dscale in f32).  Attention recomputes P from the scores
  and takes D = rowsum(dO∘O) from the forward's output, as the kernel
  does; the kernel sums in other orders (3e-5 in f32, 2e-2 in bf16).
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


def phi_update(phi: torch.Tensor, F: torch.Tensor, adj: torch.Tensor,
               d_tx: torch.Tensor) -> torch.Tensor:
    """One synchronous iteration of Eq. 10 (plain tensor algebra).

    phi [.., N], F [.., N], adj [.., N, N] bool, d_tx [.., N, N] s/GFLOP.
    Isolated nodes (no neighbour) keep φ = F.
    """
    inv_phi = 1.0 / phi
    cand = torch.where(adj, d_tx + inv_phi[..., None, :], NEG)
    worst = cand.amax(dim=-1)
    deg = adj.sum(dim=-1)
    inv_new = (1.0 / F + worst) / (deg.to(F.dtype) + 1.0)
    return torch.where(deg > 0, 1.0 / inv_new, F)


def diffusive_phi_sparse(inv_phi: torch.Tensor, F: torch.Tensor,
                         d_tx_masked: torch.Tensor,
                         nbr: torch.Tensor) -> torch.Tensor:
    """Eq. 10 over neighbour lists.  inv_phi [R, N], F [R, N], d_tx_masked
    [R, N, K] (NEG on invalid/off-link slots), nbr [R, N, K] int32 (0 on
    invalid slots).  Returns inv_phi' [R, N]."""
    R, N, K = d_tx_masked.shape
    p = torch.gather(inv_phi, 1, nbr.reshape(R, N * K).long()).view(R, N, K)
    return _combine(inv_phi, F, d_tx_masked + p, d_tx_masked)


def phi_update_sparse(phi: torch.Tensor, F: torch.Tensor,
                      adj_e: torch.Tensor, nbr: torch.Tensor,
                      d_tx_e: torch.Tensor) -> torch.Tensor:
    """Eq. 10 over fixed-width neighbour lists: phi, F [.., N]; adj_e, nbr,
    d_tx_e [.., N, K].  Bit-identical to ``phi_update`` whenever the lists
    cover every dense neighbour (same candidates and arithmetic; max is
    order-free)."""
    inv_phi = 1.0 / phi
    flat = nbr.reshape(*nbr.shape[:-2], -1).long()
    # oob: invalid slots of nbr carry node 0, a real node; adj_e masks
    # them to NEG below (J003)
    gathered = torch.gather(inv_phi, -1, flat).view(nbr.shape)
    cand = torch.where(adj_e, d_tx_e + gathered, NEG)
    worst = cand.amax(dim=-1)
    deg = adj_e.sum(dim=-1)
    inv_new = (1.0 / F + worst) / (deg.to(F.dtype) + 1.0)
    return torch.where(deg > 0, 1.0 / inv_new, F)


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


def flash_attention_bwd(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                        o: torch.Tensor, do: torch.Tensor, *,
                        causal: bool = True, window: int = 0):
    """The gradient of ``flash_attention``: (dQ, dK, dV) in the inputs'
    dtype, from the forward's output ``o`` and its cotangent ``do``.

    P = softmax(q·kᵀ/√hd) under the forward's mask, D = rowsum(dO∘O), dV =
    Pᵀ·dO, dS = P∘(dO·Vᵀ − D), dQ = dS·K/√hd, dK = dSᵀ·Q/√hd, each summed
    over the G query heads of a kv head; all in f32."""
    B, Sq, Hq, hd = q.shape
    Sk, Hkv = k.shape[1], k.shape[2]
    G = Hq // Hkv
    scale = 1.0 / math.sqrt(hd)
    qf = q.float().reshape(B, Sq, Hkv, G, hd)
    dof = do.float().reshape(B, Sq, Hkv, G, hd)
    kf, vf = k.float(), v.float()
    s = torch.einsum("bqkgd,bskd->bkgqs", qf, kf) * scale
    qpos = torch.arange(Sq, device=q.device)[:, None]
    kpos = torch.arange(Sk, device=q.device)[None, :]
    keep = torch.ones((Sq, Sk), dtype=torch.bool, device=q.device)
    if causal:
        keep &= qpos >= kpos
    if window and window > 0:
        keep &= (qpos - kpos) < window
    p = torch.softmax(torch.where(keep, s, -math.inf), dim=-1)
    D = (do.float() * o.float()).sum(-1).reshape(B, Sq, Hkv, G)
    dv = torch.einsum("bkgqs,bqkgd->bskd", p, dof)
    dp = torch.einsum("bqkgd,bskd->bkgqs", dof, vf)
    ds = p * (dp - D.permute(0, 2, 3, 1)[..., None])
    dq = torch.einsum("bkgqs,bskd->bqkgd", ds, kf) * scale
    dk = torch.einsum("bkgqs,bqkgd->bskd", ds, qf) * scale
    return (dq.reshape(B, Sq, Hq, hd).to(q.dtype), dk.to(k.dtype),
            dv.to(v.dtype))


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


def decode_partial_masked(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                          keep: torch.Tensor) -> torch.Tensor:
    """The partial of a slice of the cache: q [B,Hq,hd]; k/v [B,S,Hkv,hd];
    ``keep`` [B,S] or [S] bool, the slots kept -> f32 [B,Hq,hd + 2]: o =
    Σ p·v / l with p = exp(s - m) over the kept slots (0 where none is
    kept), then m (-inf where none is kept) and l = Σ p."""
    B, Hq, hd = q.shape
    S, Hkv = k.shape[1], k.shape[2]
    G = Hq // Hkv
    qg = q.reshape(B, Hkv, G, hd)
    s = torch.einsum("bkgd,bskd->bkgs", qg, k).float() / math.sqrt(hd)
    keep = keep.expand(B, S)[:, None, None, :]
    s = torch.where(keep, s, -math.inf)
    m = s.amax(dim=-1)                                    # [B,Hkv,G]
    p = torch.where(keep, torch.exp(s - torch.where(
        m == -math.inf, torch.zeros_like(m), m)[..., None]),
        torch.zeros_like(s))
    l = p.sum(dim=-1)
    o = torch.einsum("bkgs,bskd->bkgd", p, v.float())
    o = o / torch.where(l == 0, torch.ones_like(l), l)[..., None]
    return torch.cat([o, m[..., None], l[..., None]],
                     dim=-1).reshape(B, Hq, hd + 2)


def decode_attention_partial(q: torch.Tensor, k: torch.Tensor,
                             v: torch.Tensor, lo: int, hi: int
                             ) -> torch.Tensor:
    """The twin of the decode kernel's partial entry point: slots lo..hi
    of the slice k/v kept (``hi < lo`` keeps none) -> f32 [B,Hq,hd + 2]
    (``decode_partial_masked``)."""
    idx = torch.arange(k.shape[1], device=q.device)
    return decode_partial_masked(q, k, v, (idx >= lo) & (idx <= hi))


def rglru_scan(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """h_t = a_t·h_{t-1} + b_t from a zero state.  a, b [B,S,W] -> h
    [B,S,W] in a's dtype."""
    h = torch.zeros_like(a[:, 0])
    out = torch.empty_like(a)
    for t in range(a.shape[1]):
        h = a[:, t] * h + b[:, t]
        out[:, t] = h
    return out


def mamba_scan_with_state(a: torch.Tensor, b: torch.Tensor,
                          C: torch.Tensor):
    """h_t = a_t ⊙ h_{t-1} + b_t over a [D, N] state from zero, y_t[d] =
    Σ_n h_t[d, n]·C_t[n].  a, b [B,S,D,N]; C [B,S,N] -> (y [B,S,D],
    h_last [B,D,N])."""
    B, S, D, N = a.shape
    h = torch.zeros((B, D, N), dtype=a.dtype, device=a.device)
    y = torch.empty((B, S, D), dtype=a.dtype, device=a.device)
    for t in range(S):
        h = a[:, t] * h + b[:, t]
        y[:, t] = torch.einsum("bdn,bn->bd", h, C[:, t])
    return y, h


CHECKPOINT_EVERY = 32   # steps between the training forward's states


def mamba_scan_checkpoints(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """h_chk [B, ⌈S/T⌉ - 1, D, N] with h_chk[:, c-1] = h_{cT-1} for c = 1 ..
    ⌈S/T⌉ - 1, T = ``CHECKPOINT_EVERY``: the scan's state at the end of
    every full chunk of T steps but the last."""
    B, S, D, N = a.shape
    T = CHECKPOINT_EVERY
    h = torch.zeros((B, D, N), dtype=a.dtype, device=a.device)
    h_chk = torch.empty((B, max(S - 1, 0) // T, D, N), dtype=a.dtype,
                        device=a.device)
    for t in range(h_chk.shape[1] * T):
        h = a[:, t] * h + b[:, t]
        if t % T == T - 1:
            h_chk[:, t // T] = h
    return h_chk


def mamba_scan_with_checkpoints(a: torch.Tensor, b: torch.Tensor,
                                C: torch.Tensor):
    """``mamba_scan_with_state`` and the states the training forward keeps
    for the backward: (y, h_last, ``mamba_scan_checkpoints(a, b)``)."""
    return (*mamba_scan_with_state(a, b, C), mamba_scan_checkpoints(a, b))


def mamba_scan(a: torch.Tensor, b: torch.Tensor,
               C: torch.Tensor) -> torch.Tensor:
    """``mamba_scan_with_state`` without the last state: y [B,S,D], as the
    Pallas kernel returns it."""
    return mamba_scan_with_state(a, b, C)[0]


def rglru_scan_bwd(a: torch.Tensor, h: torch.Tensor, dy: torch.Tensor):
    """The gradient of ``rglru_scan`` from its output ``h`` and the
    cotangent ``dy`` of h (all [B, S, W]): (da, db), an explicit reverse
    loop.  g_t = dy_t + a_{t+1}·g_{t+1} (nothing past S), db_t = g_t, da_t
    = g_t·h_{t-1} with h_{-1} = 0; each product and sum rounded on its
    own, as the kernel does."""
    da, db = torch.empty_like(a), torch.empty_like(a)
    zero = torch.zeros_like(a[:, 0])
    carry = zero
    for t in range(a.shape[1] - 1, -1, -1):
        g = dy[:, t] + carry
        db[:, t] = g
        da[:, t] = g * (h[:, t - 1] if t > 0 else zero)
        carry = a[:, t] * g
    return da, db


DC_GROUP = 32   # channels summed together in dC's first level: a block's


def mamba_scan_bwd(a: torch.Tensor, b: torch.Tensor, C: torch.Tensor,
                   dy: torch.Tensor, dh_last: torch.Tensor = None,
                   h_chk: torch.Tensor = None):
    """The gradient of ``mamba_scan_with_state`` (a, b [B,S,D,N], C [B,S,N])
    from the cotangents dy of y [B,S,D] and, if given, dh_last of h_last
    [B,D,N]: (da, db, dC), explicit loops.

    h is recomputed with the forward's arithmetic, each chunk of
    ``CHECKPOINT_EVERY`` steps from its state in ``h_chk`` where the
    forward's checkpoints are given (``mamba_scan_with_checkpoints``: the
    same states, so the same bits).  Then, t from S-1 down:
    G_t = dy_t ⊗ C_t + a_{t+1}⊙G_{t+1} (dh_last, or 0, in place of the
    carry at S-1), db_t = G_t, da_t = G_t⊙h_{t-1} (h_{-1} = 0).  dC_t[n] =
    Σ_d dy_t[d]·h_t[d, n] is summed in the kernel's groups: the channels in
    runs of ``DC_GROUP`` (zero-padded), each run by a halving tree (a
    block's tree in shared memory), then the runs' partials in order; so dC
    too equals the kernel's bit for bit."""
    B, S, D, N = a.shape
    T = CHECKPOINT_EVERY
    hs = torch.empty_like(a)
    h = torch.zeros((B, D, N), dtype=a.dtype, device=a.device)
    for t in range(S):
        if h_chk is not None and t and t % T == 0:
            h = h_chk[:, t // T - 1]
        h = a[:, t] * h + b[:, t]
        hs[:, t] = h
    da, db = torch.empty_like(a), torch.empty_like(a)
    zero = torch.zeros_like(h)
    carry = zero if dh_last is None else dh_last
    for t in range(S - 1, -1, -1):
        g = dy[:, t, :, None] * C[:, t, None, :] + carry
        db[:, t] = g
        da[:, t] = g * (hs[:, t - 1] if t > 0 else zero)
        carry = a[:, t] * g
    q = dy[..., None] * hs                                 # [B,S,D,N]
    W = -(-D // DC_GROUP)
    q = torch.nn.functional.pad(q, (0, 0, 0, W * DC_GROUP - D))
    q = q.view(B, S, W, DC_GROUP, N)
    half = DC_GROUP // 2
    while half:
        q = q[:, :, :, :half] + q[:, :, :, half:2 * half]
        half //= 2
    part = q[:, :, :, 0]                                   # [B,S,W,N]
    dC = part[:, :, 0]
    for w in range(1, W):
        dC = dC + part[:, :, w]
    return da, db, dC


def rmsnorm(x: torch.Tensor, scale: torch.Tensor,
            eps: float = 1e-6) -> torch.Tensor:
    """x [..., d]; scale [d] -> x · rsqrt(mean(x², -1) + eps) · scale,
    computed in f32 and returned in x's dtype."""
    xf = x.float()
    ms = xf.square().mean(dim=-1, keepdim=True)
    return (xf * torch.rsqrt(ms + eps) * scale.float()).to(x.dtype)


def rmsnorm_bwd(x: torch.Tensor, scale: torch.Tensor, dy: torch.Tensor,
                eps: float = 1e-6):
    """The gradient of ``rmsnorm``: (dx in x's dtype, dscale [d] f32).

    rstd = rsqrt(mean(x²) + eps), x̂ = x·rstd, g = dy·scale; dx = rstd·(g −
    x̂·mean(g·x̂)), dscale = Σ_rows dy·x̂; all in f32."""
    d = x.shape[-1]
    xf, dyf = x.float(), dy.float()
    rstd = torch.rsqrt(xf.square().mean(dim=-1, keepdim=True) + eps)
    xhat = xf * rstd
    g = dyf * scale.float()
    dx = rstd * (g - xhat * (g * xhat).mean(dim=-1, keepdim=True))
    dscale = (dyf * xhat).reshape(-1, d).sum(dim=0)
    return dx.to(x.dtype), dscale
