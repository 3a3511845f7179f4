"""ctypes wrapper of the hand-written CUDA flash-attention backward
(``csrc/flash_attention_bwd.cu``).  The TPU kernel
``repro/kernels/flash_attention.py::flash_attention`` has no backward: JAX
differentiates the plain path, whose gradient this kernel computes for the
port's forward kernel.  ``ops.flash_attention`` pairs the two in a
``torch.autograd.Function``; the plain twin is
``ref.flash_attention_bwd``.

Built at first use by ``build.py``.  The wrapper checks q, k and v as the
forward's wrapper does and o and dO against q, allocates dQ, dK, dV, the
rows' float32 log-sum-exp and rowsum(dO∘O) scratch and, where the bf16
plan splits a kv head's query heads, the f32 partials of dK and dV with
``torch.empty``; it keeps one zero-initialised int32 ticket buffer per
stream (each launch leaves it zero), launches on the current stream (two
kernels: dQ with the row statistics, then dK and dV), raises on a
non-zero error and counts the call in ``LAUNCHES["flash_attention_bwd"]``.
"""
from __future__ import annotations

import ctypes
import math
from dataclasses import dataclass
from typing import Dict, List, Tuple

import torch

from repro_torch.kernels.build import (DTYPES, CudaLibrary, check, launched,
                                       stream)
from repro_torch.kernels.flash_attention import check_attention_inputs

_p, _i, _f = ctypes.c_void_p, ctypes.c_int, ctypes.c_float
LIB = CudaLibrary(
    "flash_attention_bwd.cu",
    {"flash_attention_bwd_launch": [_p] * 12 + [_i] * 10 + [_f, _i, _i, _p]},
    kernels=("flash_attention_bwd",))

TILE = 64           # query and key rows of a tile (the bf16 kernels)
WAVES = 256         # dK/dV blocks the head split aims for: about two waves
#                     of an H100's 132 SMs at one block an SM
_TICKETS: Dict[Tuple[int, int], torch.Tensor] = {}


@dataclass(frozen=True)
class BwdPlan:
    """The bf16 kernels' launch plan, a function of the shapes alone."""
    B: int
    Hq: int
    Hkv: int
    tile: int          # query and key rows of a tile
    q_tiles: int
    k_tiles: int
    hs: int            # groups the G query heads of a kv head are cut into
    dq_grid: Tuple[int, int]      # (Hq·B, query tiles)
    dkdv_grid: Tuple[int, int]    # (hs·Hkv·B, key tiles)
    sq_pad: int        # rows of a (batch, head) in the LSE and D scratch
    partial: int       # f32 elements of the dK/dV partials (0: hs = 1)
    tickets: int       # int32 tickets of their combine (0: hs = 1)

    def dq_block(self, x: int, y: int, causal: bool) -> Tuple[int, int, int]:
        """(batch, query head, query tile) of dQ block (x, y), as the
        kernel reads its block index."""
        qt = self.q_tiles - 1 - y if causal else y
        return x // self.Hq, x % self.Hq, qt

    def dkdv_block(self, x: int, y: int) -> Tuple[int, int, List[int], int]:
        """(batch, kv head, query heads, key tile) of dK/dV block (x, y),
        as the kernel reads its block index."""
        G = self.Hq // self.Hkv
        gs = G // self.hs
        split, hk = x % self.hs, (x // self.hs) % self.Hkv
        first = hk * G + split * gs
        return (x // (self.hs * self.Hkv), hk,
                list(range(first, first + gs)), y)


def bwd_plan(B: int, Sq: int, Sk: int, Hq: int, Hkv: int,
             hd: int) -> BwdPlan:
    """The smallest head split hs (a divisor of G = Hq / Hkv) whose dK/dV
    grid reaches ``WAVES`` blocks, or G: qwen3's (4, 512, 16, 8) keeps hs
    = 1 (256 blocks), recurrentgemma's (4, 512, 16, 1) gets hs = 8 (256
    blocks), qwen2-vl's (4, 512, 12, 2) hs = 6 (384).  Every order of
    summation in the kernels follows from this plan."""
    G = Hq // Hkv
    q_tiles, k_tiles = -(-Sq // TILE), -(-Sk // TILE)
    blocks = k_tiles * Hkv * B
    hs = next((h for h in range(1, G + 1) if G % h == 0
               and blocks * h >= WAVES), G)
    split = hs > 1
    return BwdPlan(
        B=B, Hq=Hq, Hkv=Hkv, tile=TILE, q_tiles=q_tiles, k_tiles=k_tiles,
        hs=hs, dq_grid=(Hq * B, q_tiles), dkdv_grid=(hs * Hkv * B, k_tiles),
        sq_pad=q_tiles * TILE,
        partial=2 * hs * B * Sk * Hkv * hd if split else 0,
        tickets=B * Hkv * k_tiles if split else 0)


def _tickets(device: torch.device, n: int) -> torch.Tensor:
    """At least ``n`` int32 zeros for the current stream of ``device``."""
    key = (device.index, torch.cuda.current_stream(device).cuda_stream)
    buf = _TICKETS.get(key)
    if buf is None or buf.numel() < n:
        buf = _TICKETS[key] = torch.zeros(n, dtype=torch.int32,
                                          device=device)
    return buf


def flash_attention_bwd(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                        o: torch.Tensor, do: torch.Tensor, *,
                        causal: bool = True, window: int = 0
                        ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """q, o, dO [B,Sq,Hq,hd]; k, v [B,Sk,Hkv,hd] on the card, one dtype ->
    (dQ, dK, dV) in that dtype, for ``o = flash_attention(q, k, v,
    causal=causal, window=window)``."""
    device = check_attention_inputs(q, k, v, q_dims=4)
    check("o", o, q.dtype, q.shape, device)
    check("do", do, q.dtype, q.shape, device)
    for name, t in (("o", o), ("do", do)):
        if t.data_ptr() % 16:
            raise ValueError(f"{name} must be 16-byte aligned")
    B, Sq, Hq, hd = q.shape
    Sk, Hkv = k.shape[1], k.shape[2]
    if k.shape[0] != B or Sk == 0:
        raise ValueError(f"k {tuple(k.shape)} does not match q "
                         f"{tuple(q.shape)}")
    if B > 65535 or Hq > 65535:
        raise ValueError(f"B = {B}, Hq = {Hq} exceed the kernel's grid")
    dq, dk, dv = (torch.empty_like(t) for t in (q, k, v))
    if q.numel() == 0:
        return dq, dk.zero_(), dv.zero_()
    plan = bwd_plan(B, Sq, Sk, Hq, Hkv, hd)
    lse = torch.empty(B * Hq * plan.sq_pad, dtype=torch.float32,
                      device=device)
    dvec = torch.empty_like(lse)
    partial = tickets = None
    if q.dtype == torch.bfloat16 and plan.hs > 1:
        partial = torch.empty(plan.partial, dtype=torch.float32,
                              device=device)
        tickets = _tickets(device, plan.tickets)
    err = LIB.lib().flash_attention_bwd_launch(
        q.data_ptr(), k.data_ptr(), v.data_ptr(), o.data_ptr(),
        do.data_ptr(), dq.data_ptr(), dk.data_ptr(), dv.data_ptr(),
        lse.data_ptr(), dvec.data_ptr(),
        None if partial is None else partial.data_ptr(),
        None if tickets is None else tickets.data_ptr(), B, Sq, Sk, Hq, Hkv,
        hd, int(bool(causal)), int(window), plan.hs, plan.sq_pad,
        1.0 / math.sqrt(hd), DTYPES[q.dtype], device.index, stream(device))
    launched(err, "flash_attention_bwd")
    return dq, dk, dv
