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
"""
from __future__ import annotations

import ctypes
import math
from typing import Dict, Tuple, Union

import torch

from repro_torch.kernels.build import CudaLibrary, launched, sm_count, stream
from repro_torch.kernels.flash_attention import DTYPES, check_attention_inputs

_p, _i, _f = ctypes.c_void_p, ctypes.c_int, ctypes.c_float
LIB = CudaLibrary(
    "decode_attention.cu",
    {"decode_attention_launch": [_p, _p, _p, _p, _p, _p, _i, _i, _i, _i, _i,
                                 _i, _i, _i, _i, _i, _f, _i, _i, _p]},
    kernels=("decode_attention",))

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


def decode_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                     pos: Union[int, torch.Tensor], *,
                     window: int = 0) -> torch.Tensor:
    """q [B,Hq,hd]; k/v [B,S,Hkv,hd] on the card; attend to cache slots
    kpos <= pos (and pos - kpos < window where a window is set) ->
    [B,Hq,hd] in q's dtype."""
    device = check_attention_inputs(q, k, v, q_dims=3)
    B, Hq, hd = q.shape
    S, Hkv = k.shape[1], k.shape[2]
    if k.shape[0] != B or S == 0:
        raise ValueError(f"k {tuple(k.shape)} does not match q "
                         f"{tuple(q.shape)}")
    pos = int(pos.item()) if torch.is_tensor(pos) else int(pos)
    if pos < 0:
        raise ValueError(f"pos must be >= 0, got {pos}")
    hi = min(pos, S - 1)
    lo = max(0, pos - window + 1) if window > 0 else 0
    out = torch.empty_like(q)
    if out.numel() == 0:
        return out
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
    err = LIB.lib().decode_attention_launch(
        q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(),
        None if part is None else part.data_ptr(),
        None if counters is None else counters.data_ptr(), B, S, Hkv, G, GM,
        hd, lo, hi, chunk, splits, 1.0 / math.sqrt(hd), DTYPES[q.dtype],
        device.index, stream(device))
    launched(err, "decode_attention")
    return out
