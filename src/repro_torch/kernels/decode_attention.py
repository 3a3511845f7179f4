"""ctypes wrapper of the hand-written CUDA decode-attention kernel
(``csrc/decode_attention.cu``; it replaces the Pallas TPU kernel
``repro/kernels/decode_attention.py::decode_attention``).

Built at first use by ``build.py``.  ``pos`` is a host int: the kernel
reads only the kept cache slots, whose range the host computes and cuts
into splits (``split_plan``) that the one launch spreads over the card and
combines in split order.  A 0-d tensor is read with ``.item()``, which
synchronises with the card.  The wrapper checks its inputs as the flash
wrapper does, allocates the output and the splits' f32 scratch with
``torch.empty``, keeps one zero-initialised int32 counter buffer per
device and stream (the kernel leaves it at zero), launches on the current
stream, raises on a non-zero ``cudaError_t`` and counts the launch in
``LAUNCHES["decode_attention"]``.

The distributed flash-decode (``models.attention``, a cache split along S
over the ``"model"`` axis) takes the kernel's second entry point,
``decode_attention_partial``: a rank's slice of the cache and the part of
the kept range in it (possibly none) give the slice's partial, f32 ``[B,
Hq, hd + 2]`` (o normalised by the slice's own l, then m and l), counted in
``LAUNCHES["decode_attention_partial"]``.  ``combine_partials`` combines
the ranks' partials in rank order, in plain torch on any device: a few
floats a query head, no kernel's work.
"""
from __future__ import annotations

import ctypes
import math
from typing import Dict, Sequence, Tuple, Union

import torch

from repro_torch.kernels.build import CudaLibrary, launched, sm_count, stream
from repro_torch.kernels.flash_attention import DTYPES, check_attention_inputs

_p, _i, _f = ctypes.c_void_p, ctypes.c_int, ctypes.c_float
_ARGS = [_p, _p, _p, _p, _p, _p, _i, _i, _i, _i, _i, _i, _i, _i, _i, _i, _f,
         _i, _i, _p]
LIB = CudaLibrary(
    "decode_attention.cu",
    {"decode_attention_launch": _ARGS,
     "decode_attention_partial_launch": _ARGS},
    kernels=("decode_attention", "decode_attention_partial"))

SPLIT_ROWS = 64          # the fewest slots a split reads: two tiles
BLOCKS_PER_SM = 2        # the blocks a split plan aims for on each SM
MAX_SPLITS = 64          # the kernel combines at most this many splits

_COUNTERS: Dict[Tuple[int, int], torch.Tensor] = {}


def query_group(G: int) -> int:
    """Query heads a block takes: the smallest of 1, 2, 4 and 8 that holds
    G (8 above that: the heads of a kv head then take several blocks)."""
    return next((gm for gm in (1, 2, 4, 8) if G <= gm), 8)


def split_plan(kept: int, B: int, Hkv: int, groups: int,
               sms: int) -> Tuple[int, int]:
    """(splits, chunk): cut ``kept`` slots into ``splits`` contiguous
    chunks of ``chunk`` slots (the last one shorter, none empty) so that
    ``B·Hkv·groups·splits`` blocks give at least ``BLOCKS_PER_SM`` per SM,
    each chunk a multiple of ``SPLIT_ROWS`` slots and at most
    ``MAX_SPLITS`` of them; one split where the range is at most
    ``SPLIT_ROWS`` long."""
    if kept <= SPLIT_ROWS:
        return 1, max(kept, 1)
    want = -(-BLOCKS_PER_SM * sms // (B * Hkv * groups))
    chunk = max(SPLIT_ROWS, kept // want // SPLIT_ROWS * SPLIT_ROWS,
                -(-kept // (MAX_SPLITS * SPLIT_ROWS)) * SPLIT_ROWS)
    return -(-kept // chunk), chunk


def _counters(device: torch.device, n: int) -> torch.Tensor:
    """At least ``n`` int32 zeros for the current stream of ``device``."""
    key = (device.index, torch.cuda.current_stream(device).cuda_stream)
    buf = _COUNTERS.get(key)
    if buf is None or buf.numel() < n:
        buf = _COUNTERS[key] = torch.zeros(n, dtype=torch.int32,
                                           device=device)
    return buf


def _launch(entry, name, q, k, v, out, lo, hi, device) -> None:
    """The kept slots lo..hi of k/v cut into splits and launched."""
    B, Hq, hd = q.shape
    S, Hkv = k.shape[1], k.shape[2]
    G = Hq // Hkv
    GM = query_group(G)
    groups = -(-G // GM)
    splits, chunk = split_plan(hi - lo + 1, B, Hkv, groups,
                               sm_count(device.index))
    part = counters = None
    if splits > 1:
        part = torch.empty(B * Hkv * groups * splits * GM * (hd + 2),
                           dtype=torch.float32, device=device)
        counters = _counters(device, B * Hkv * groups)
    err = entry(
        q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(),
        None if part is None else part.data_ptr(),
        None if counters is None else counters.data_ptr(), B, S, Hkv, G, GM,
        hd, lo, hi, chunk, splits, 1.0 / math.sqrt(hd), DTYPES[q.dtype],
        device.index, stream(device))
    launched(err, name)


def _check(q, k, v) -> torch.device:
    device = check_attention_inputs(q, k, v, q_dims=3)
    if k.shape[0] != q.shape[0] or k.shape[1] == 0:
        raise ValueError(f"k {tuple(k.shape)} does not match q "
                         f"{tuple(q.shape)}")
    return device


def decode_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                     pos: Union[int, torch.Tensor], *,
                     window: int = 0) -> torch.Tensor:
    """q [B,Hq,hd]; k/v [B,S,Hkv,hd] on the card; attend to cache slots
    kpos <= pos (and pos - kpos < window where a window is set) ->
    [B,Hq,hd] in q's dtype."""
    device = _check(q, k, v)
    S = k.shape[1]
    pos = int(pos.item()) if torch.is_tensor(pos) else int(pos)
    if pos < 0:
        raise ValueError(f"pos must be >= 0, got {pos}")
    hi = min(pos, S - 1)
    lo = max(0, pos - window + 1) if window > 0 else 0
    out = torch.empty_like(q)
    if out.numel() == 0:
        return out
    _launch(LIB.lib().decode_attention_launch, "decode_attention", q, k, v,
            out, lo, hi, device)
    return out


def decode_attention_partial(q: torch.Tensor, k: torch.Tensor,
                             v: torch.Tensor, lo: int, hi: int
                             ) -> torch.Tensor:
    """q [B,Hq,hd]; k/v [B,S,Hkv,hd] on the card, a rank's slice of the
    cache; slots lo..hi of the slice kept (``hi < lo`` keeps none) -> the
    slice's partial, f32 [B,Hq,hd + 2]: o = acc / l (0 where l = 0), then m
    (-inf where l = 0) and l."""
    device = _check(q, k, v)
    B, Hq, hd = q.shape
    S = k.shape[1]
    lo, hi = int(lo), int(hi)
    if lo < 0 or hi >= S:
        raise ValueError(f"kept range {lo}..{hi} outside the slice's {S} "
                         f"slots")
    if hi < lo:
        lo, hi = 0, -1
    out = torch.empty((B, Hq, hd + 2), dtype=torch.float32, device=device)
    if out.numel() == 0:
        return out
    _launch(LIB.lib().decode_attention_partial_launch,
            "decode_attention_partial", q, k, v, out, lo, hi, device)
    return out


def slice_range(pos: int, window: int, offset: int, n: int
                ) -> Tuple[int, int]:
    """The kept range of a decode at ``pos`` (``window`` 0: none) within the
    slice of ``n`` slots that starts at global slot ``offset``, in the
    slice's own indices; ``hi < lo`` where the slice keeps none."""
    lo = max(0, pos - window + 1) if window > 0 else 0
    return max(lo - offset, 0), min(pos - offset, n - 1)


def combine_partials(parts: Sequence[torch.Tensor]) -> torch.Tensor:
    """The ranks' partials [B,Hq,hd + 2] (f32, in rank order) combined as
    the kernel combines its splits: M the max of the m's, a rank's weight
    exp(m - M), zero for a rank that kept nothing (not exp(-inf - -inf));
    L = Σ w·l and O = Σ (w·l)·o / L, summed in rank order, 0 where L = 0
    -> [B,Hq,hd] f32."""
    hd = parts[0].shape[-1] - 2
    M = parts[0][..., hd]
    for p in parts[1:]:
        M = torch.maximum(M, p[..., hd])
    L = A = None
    for p in parts:
        m, l = p[..., hd], p[..., hd + 1]
        w = torch.where(m == -math.inf, torch.zeros_like(m),
                        torch.exp(m - M))
        wl = w * l
        a = wl[..., None] * p[..., :hd]
        L, A = (wl, a) if L is None else (L + wl, A + a)
    return A / torch.where(L == 0, torch.ones_like(L), L)[..., None]
