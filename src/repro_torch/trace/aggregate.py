"""The quantile grid and ``quantile_summary`` of
``repro/trace/aggregate.py``, a copy (that module imports jax through its
package), for ``fleet.report``.  The task- and hop-level indices come with
the trace slice (ROADMAP.md)."""
from __future__ import annotations

from typing import Dict, Optional, Sequence

import numpy as np

QS = (0.05, 0.25, 0.5, 0.75, 0.9, 0.95, 0.99)


def quantile_summary(x, qs: Sequence[float] = QS) -> Optional[Dict[str, float]]:
    """``{"p05": ..., "p50": ..., ...}`` of a 1-D sample; ``None`` when the
    sample is empty (a stable null beats a key that comes and goes)."""
    x = np.asarray(x, np.float64)
    if x.size == 0:
        return None
    return {f"p{int(q * 100):02d}": float(np.quantile(x, q)) for q in qs}
