"""Deterministic synthetic token pipeline; port of
``repro/data/pipeline.py``.

``_batch_np`` is a copy of the reference's (the same numpy generator,
seeded by ``seed·1_000_003 + step``, the same drifting Markov chains, the
same host slice), so both packages train on identical batches.  Batches
are stateless in the step, which is what makes a resume from a checkpoint
bit-identical.  ``batch_at`` and ``Prefetcher`` hand them out as int32
tensors on a device (CUDA unless the caller passes ``device="cpu"``).
"""
from __future__ import annotations

import queue
import threading
from dataclasses import dataclass
from typing import Dict, Iterator

import numpy as np
import torch

from repro_torch.device import resolve_device


@dataclass(frozen=True)
class DataConfig:
    vocab_size: int
    seq_len: int
    global_batch: int
    seed: int = 0
    num_hosts: int = 1
    host_id: int = 0


def _batch_np(cfg: DataConfig, step: int) -> Dict[str, np.ndarray]:
    """Stateless batch for `step` (full global batch, then host slice)."""
    assert cfg.global_batch % cfg.num_hosts == 0
    per_host = cfg.global_batch // cfg.num_hosts
    rng = np.random.default_rng(np.uint64(cfg.seed * 1_000_003 + step))
    # structured synthetic stream: mixture of a few markov chains so the
    # model has something learnable (loss decreases in the train example)
    B, S = cfg.global_batch, cfg.seq_len + 1
    base = rng.integers(0, cfg.vocab_size, (B, 1), dtype=np.int64)
    drift = rng.integers(1, 7, (B, S), dtype=np.int64).cumsum(axis=1)
    toks = (base + drift) % cfg.vocab_size
    lo = cfg.host_id * per_host
    toks = toks[lo:lo + per_host]
    return {"tokens": toks[:, :-1].astype(np.int32),
            "labels": toks[:, 1:].astype(np.int32)}


def _to_device(batch: Dict[str, np.ndarray], device) -> Dict[str,
                                                             torch.Tensor]:
    return {k: torch.from_numpy(v).to(device) for k, v in batch.items()}


def batch_at(cfg: DataConfig, step: int, device=None
             ) -> Dict[str, torch.Tensor]:
    return _to_device(_batch_np(cfg, step), resolve_device(device))


class Prefetcher:
    """Background thread producing batches ahead of the train loop (numpy
    on the host; each is moved to ``device`` when it is taken)."""

    def __init__(self, cfg: DataConfig, start_step: int = 0, depth: int = 2,
                 device=None):
        self.cfg = cfg
        self.device = resolve_device(device)
        self._q: "queue.Queue" = queue.Queue(maxsize=depth)
        self._step = start_step
        self._stop = threading.Event()
        self._thread = threading.Thread(target=self._work, daemon=True)
        self._thread.start()

    def _work(self):
        s = self._step
        while not self._stop.is_set():
            try:
                self._q.put((s, _batch_np(self.cfg, s)), timeout=0.2)
                s += 1
            except queue.Full:
                continue

    def __iter__(self) -> Iterator:
        return self

    def __next__(self):
        step, b = self._q.get()
        return step, _to_device(b, self.device)

    def close(self):
        self._stop.set()
        self._thread.join(timeout=2.0)
