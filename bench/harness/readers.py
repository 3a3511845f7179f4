"""What the per-layer metric files under ``bench/metrics/`` compute, from
what a run leaves in its ``ctx``: the traced window (``trace``), the
shapes of the flash-attention calls in it (``flash_calls``), the model
FLOPs of the window (``model_flops``, ``window_s``), the serve driver's
step spans on the card (``step_s``), latencies and exit rows.  Each returns None where
the run has nothing to read."""
from __future__ import annotations

import statistics
from typing import Dict, Optional

import numpy as np

from harness import flops

FLASH_FWD = "flash_kernel"          # flash_kernel_wgmma, flash_kernel_f32
FLASH_BWD = "flash_bwd_"            # the dQ and dK/dV kernels
FLASH_BWD_CALL = "flash_bwd_dkdv"   # one a backward call
FOREACH = "multi_tensor_apply"      # torch's _foreach kernels


def mfu(ctx: Dict) -> Optional[float]:
    """Model FLOPs done in the window over the window at the bf16 peak, %."""
    if not ctx.get("window_s") or not ctx.get("model_flops"):
        return None
    return 100.0 * ctx["model_flops"] / (ctx["window_s"]
                                         * flops.BF16_FLOPS_PER_S)


def idle_share(ctx: Dict) -> Optional[float]:
    w = ctx.get("trace")
    if w is None or w.window_s <= 0:
        return None
    return 100.0 * (1.0 - w.busy_s / w.window_s)


def optimizer_share(ctx: Dict) -> Optional[float]:
    """The _foreach kernels' share of the device's busy time, %."""
    w = ctx.get("trace")
    if w is None or w.busy_s <= 0:
        return None
    n, t = w.time_of(lambda name: FOREACH in name)
    return 100.0 * t / w.busy_s if n else None


def flash_fwd_roofline(ctx: Dict) -> Optional[float]:
    """Σ bound over the forward launches / Σ their device time, %.  Each
    forward call launches one kernel; where the trace holds fewer launches
    than the harness recorded calls (a record lost at the window's edge),
    the launches are taken at the calls' mean bound."""
    w, calls = ctx.get("trace"), ctx.get("flash_calls")
    if w is None or not calls:
        return None
    n, t = w.time_of(lambda name: FLASH_FWD in name
                     and FLASH_BWD not in name)
    if not n or t <= 0:
        return None
    bounds = [flops.flash_fwd_bound_s(*c) for c in calls]
    total = sum(bounds) if n == len(calls) else n * sum(bounds) / len(bounds)
    return 100.0 * total / t


def flash_bwd_roofline(ctx: Dict) -> Optional[float]:
    """Σ bound over the backward calls / Σ device time of the backward
    kernels, %; a training window's calls all take one shape."""
    w, calls = ctx.get("trace"), ctx.get("flash_calls")
    if w is None or not calls or len(set(calls)) != 1:
        return None
    n_calls, _ = w.time_of(lambda name: FLASH_BWD_CALL in name)
    _, t = w.time_of(lambda name: FLASH_BWD in name)
    if not n_calls or t <= 0:
        return None
    return 100.0 * n_calls * flops.flash_bwd_bound_s(*calls[0]) / t


def step_ms(ctx: Dict) -> Optional[float]:
    s = ctx.get("step_s")
    return 1e3 * statistics.median(s) if s else None


def full_depth_share(ctx: Dict) -> Optional[float]:
    rows = ctx.get("rows")
    if not rows or not sum(rows.values()):
        return None
    return 100.0 * rows[0] / sum(rows.values())


def p95_ms(ctx: Dict) -> Optional[float]:
    lat = ctx.get("latency_s")
    return float(np.percentile(lat, 95)) * 1e3 if lat else None
