"""Host-side TaskRecord/HopRecord/state-stream decoding (DESIGN.md §10.3),
a copy of ``repro/trace/decode.py`` that also takes tensors (on any
device; they are copied to the host).

``decode`` (tasks) and ``decode_hops`` mask the unwritten slots out of
one or many record buffers (any leading batch shape — a single run's
``[C, F]`` buffer, a sweep point's ``[num_runs, C, F]`` stack) and split
the packed rows back into named numpy columns.  Row order is run-major
then seq-ascending (slot index == seq), so the output is deterministic
in the inputs.
"""
from __future__ import annotations

from typing import Dict

import numpy as np
import torch

from repro_torch.trace import schema


def _host(x, dtype=None) -> np.ndarray:
    """A numpy array of ``x``, copied off the device when it is a tensor."""
    if torch.is_tensor(x):
        x = x.detach().cpu().numpy()
    return np.asarray(x, dtype)


def _decode(records, overflow, fields, int_fields, seq_idx
            ) -> Dict[str, np.ndarray]:
    rec = _host(records, np.float64).reshape(-1, len(fields))
    rec = rec[rec[:, seq_idx] >= 0.0]
    out: Dict[str, np.ndarray] = {}
    for i, name in enumerate(fields):
        col = rec[:, i]
        out[name] = (col.astype(np.int64) if name in int_fields else col)
    out["overflow"] = np.int64(0 if overflow is None
                               else np.sum(_host(overflow)))
    return out


def decode(records, overflow=None) -> Dict[str, np.ndarray]:
    """TaskRecord buffer(s) → dict of per-task numpy columns.

    Integral fields come back as int64, times/energies as float64, plus
    two derived columns: ``latency_s`` (completed − created) and
    ``is_dropped``.  ``overflow`` (scalar or per-run array) is summed into
    the ``"overflow"`` entry (0-d int64) when given.
    """
    out = _decode(records, overflow, schema.FIELDS, schema.INT_FIELDS,
                  schema.SEQ)
    out["latency_s"] = out["completed_t"] - out["created_t"]
    out["is_dropped"] = out["exit_label"] == schema.DROPPED
    return out


def decode_hops(records, overflow=None) -> Dict[str, np.ndarray]:
    """HopRecord buffer(s) → dict of per-hop numpy columns.

    Adds the derived ``transfer_time_s`` column (``t_arrive − t_depart``,
    the hop's full initiate→delivery latency including stalls); convert
    ``stall_ticks`` to seconds with the run's ``tick_s`` when a wall-time
    decomposition is needed (``aggregate.hop_indices`` does).
    """
    out = _decode(records, overflow, schema.HOP_FIELDS,
                  schema.HOP_INT_FIELDS, schema.HOP_SEQ)
    out["transfer_time_s"] = out["t_arrive"] - out["t_depart"]
    return out


def decode_state(state=None, sys=None, epochs=None) -> Dict[str, np.ndarray]:
    """State-stream buffer(s) → dict of epoch-indexed numpy series.

    Accepts any subset of the three flight-recorder buffers (a simulated
    point carries all three; the serve engine emits sys-only or
    state+sys without epochs):

      * ``state``  — ``[S, M, NUM_STATE_GAUGES]`` or ``[R, S, M, G]``
      * ``sys``    — ``[S, NUM_SYS_GAUGES]`` or ``[R, S, SYS]``
      * ``epochs`` — ``[S]`` or ``[R, S]`` slot→epoch map (−1 = unwritten;
        identical across runs, so only row 0 is consulted)

    Returns ``{"epoch": [S'] int64, "num_runs": int}`` plus one
    ``[R, S', M]`` float64 series per :data:`schema.STATE_GAUGES` name and
    one ``[R, S']`` series per :data:`schema.SYS_GAUGES` name (the two
    vocabularies don't collide, so the dict is flat).  Unwritten slots
    (scan ended before the slot's epoch) are masked out of every series.
    """
    out: Dict[str, np.ndarray] = {}
    S = None
    if state is not None:
        st = _host(state, np.float64)
        if st.ndim == 3:
            st = st[None]
        S = st.shape[1]
    if sys is not None:
        sy = _host(sys, np.float64)
        if sy.ndim == 2:
            sy = sy[None]
        S = sy.shape[1] if S is None else S
    if S is None:
        raise ValueError("decode_state needs at least one buffer")
    if epochs is not None:
        ep = _host(epochs, np.float64).reshape(-1, S)[0]
        valid = ep >= 0.0
        out["epoch"] = ep[valid].astype(np.int64)
    else:
        valid = np.ones((S,), bool)
        out["epoch"] = np.arange(S, dtype=np.int64)
    if state is not None:
        for i, name in enumerate(schema.STATE_GAUGES):
            # index the gauge axis first: combining the boolean epoch mask
            # and the gauge index in one subscript would be non-adjacent
            # advanced indexing, which transposes the result dims to the
            # front ([S', R, M] instead of [R, S', M])
            out[name] = st[..., i][:, valid, :]
        out["num_runs"] = int(st.shape[0])
    if sys is not None:
        for i, name in enumerate(schema.SYS_GAUGES):
            out[name] = sy[:, valid, i]
        out["num_runs"] = int(sy.shape[0])
    return out


def split_runs(records, overflow=None, hops: bool = False):
    """``[num_runs, C, F]`` stack → list of per-run decoded dicts."""
    rec = _host(records)
    if rec.ndim == 2:
        rec = rec[None]
    ovf = (np.zeros((rec.shape[0],)) if overflow is None
           else _host(overflow).reshape(rec.shape[0]))
    fn = decode_hops if hops else decode
    return [fn(r, o) for r, o in zip(rec, ovf, strict=True)]
