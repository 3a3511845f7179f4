"""Fault-tolerant training driver: checkpoint/restart, failure injection,
straggler mitigation; port of ``repro/runtime/fault.py``.

A train step is a unit of work that can die at any moment.  Recovery =
restore the latest checkpoint into a freshly initialised state
(``checkpoint.restore_into``) + the stateless data pipeline indexed by
step, so a resumed run is bit-identical to an uninterrupted one.

Straggler policy (the paper's congestion-aware early exit, lifted to the
step level): a step slower than ``straggler_factor`` × EMA(step time) is
counted and sheds optional work (the metrics callback, a host sync).

One addition: ``ckpt_dir=None`` runs without checkpoints (no resume, no
save), for a run whose state is too large to write each time, such as a
full-width model on one card.  Step times are host clocks around the
step; a caller on the card that wants device time in them synchronises
inside ``train_step``.
"""
from __future__ import annotations

import dataclasses
import time
from typing import Any, Callable, Dict, Optional

from repro_torch.checkpoint import latest_step, restore_into, save


@dataclasses.dataclass
class DriverConfig:
    ckpt_dir: Optional[str]
    ckpt_every: int = 50
    keep: int = 3
    max_steps: int = 200
    straggler_factor: float = 3.0
    # failure injection for tests: raise at this step, once
    fail_at_step: Optional[int] = None


class StepStats:
    def __init__(self):
        self.ema = None
        self.stragglers = 0
        self.steps = 0

    def update(self, dt: float, factor: float) -> bool:
        straggler = self.ema is not None and dt > factor * self.ema
        self.ema = dt if self.ema is None else 0.9 * self.ema + 0.1 * dt
        self.stragglers += int(straggler)
        self.steps += 1
        return straggler


class FailureInjected(RuntimeError):
    pass


def run_training(cfg: DriverConfig, *, init_state: Callable[[], Any],
                 train_step: Callable[[Any, Dict], Any],
                 batch_fn: Callable[[int], Dict],
                 on_metrics: Optional[Callable[[int, Dict], None]] = None,
                 mesh=None, _failed_once: Dict = None) -> Any:
    """Run (or resume) training to cfg.max_steps with checkpoint/restart.

    ``train_step(state, batch) -> (state, metrics)``; ``init_state()``
    builds the step-0 state, also the template a checkpoint is restored
    into.  ``mesh``: the state is sharded on it (``checkpoint.save`` and
    ``restore_into`` gather and re-shard).  Returns the final state.
    """
    _failed_once = _failed_once if _failed_once is not None else {}
    start = None if cfg.ckpt_dir is None else latest_step(cfg.ckpt_dir)
    state = init_state()
    if start is None:
        start = 0
    else:
        state, _ = restore_into(cfg.ckpt_dir, state, mesh=mesh)
    stats = StepStats()

    step = start
    while step < cfg.max_steps:
        if (cfg.fail_at_step is not None and step == cfg.fail_at_step
                and not _failed_once.get("done")):
            _failed_once["done"] = True
            raise FailureInjected(f"injected failure at step {step}")
        t0 = time.perf_counter()
        batch = batch_fn(step)
        state, metrics = train_step(state, batch)
        straggler = stats.update(time.perf_counter() - t0,
                                 cfg.straggler_factor)
        step += 1
        if on_metrics is not None and not straggler:
            # straggler steps shed the host sync (early-exit analogue)
            on_metrics(step, metrics)
        if cfg.ckpt_dir is not None and (step % cfg.ckpt_every == 0
                                         or step == cfg.max_steps):
            save(cfg.ckpt_dir, step, state, keep=cfg.keep, mesh=mesh)
    return state


def run_with_restarts(cfg: DriverConfig, *, max_restarts: int = 3,
                      **kw) -> Any:
    """Supervisor loop: restart from the latest checkpoint on failure."""
    failed = {}
    for attempt in range(max_restarts + 1):
        try:
            return run_training(cfg, _failed_once=failed, **kw)
        except FailureInjected:
            if attempt == max_restarts:
                raise
            continue
    raise RuntimeError("unreachable")
