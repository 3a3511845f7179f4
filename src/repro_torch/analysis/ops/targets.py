"""The recorded-program registry of the ops tier (the port of
``repro/analysis/jaxpr/targets.py``; DESIGN.md §15.1).

A *target* names one real program of the port and a builder that, given
a device, returns ``(fn, args)``; :func:`trace_targets` records ``fn(*args)``
once under ``torch.float32`` as the default dtype and once under
``torch.float64`` (J002), and the rules lint the recordings.  The 11
targets are the reference's:

* ``sim_*`` — ``run_sim`` end to end: the dense path, the sparse
  neighbour-list path (DESIGN.md §11), the fully traced path (task, hop
  and state streams, §10/§12), and scenario-registry combinations
  (stochastic channel / mobility / fault entries).  The reference traces
  the strategy as an ``int32`` through ``lax.switch``, so its trace holds
  every strategy's branch; the port branches on a Python int, so each sim
  target is recorded once per strategy (``STRATEGIES``) and the findings
  are merged;
* ``kernel_*`` — the φ launchers of ``repro_torch.kernels.ops`` (dense
  and sparse), through the same dispatch the simulator uses: on the card a
  ``kernel:`` event, on the CPU the plain version's ops;
* ``executor_*`` — the three fleet backends' batched runs
  (``fleet.executor.run_batch`` with ``vmap`` / ``streaming`` /
  ``sharded`` over one device), Distributed only: they audit the batching
  wrappers, the sim targets every strategy's body;
* ``serve_congestion_core`` — the numerics of ``SplitServeEngine.step``
  (``core.early_exit``'s congestion update and exit labels).

Targets are small (N = 13, one simulated second: five epochs): the op
stream does not depend on array sizes beyond their shapes, and the
distinctive prime N lets the rules identify the cross-node axis by
dimension.  Programs run on ``device``: the card unless the caller asks
for the CPU (``repro_torch.device.resolve_device``).

A process records each (target, device) once: :func:`trace_targets`
keeps its recordings, so the CLI, the tests and ``chip_smoke.py`` pay for
one pass however many rules read it.
"""
from __future__ import annotations

from dataclasses import dataclass
from typing import Callable, Dict, List, Optional, Tuple

import torch

from repro_torch.analysis.ops.record import Recorder, Recording

#: the distinctive swarm size rules use to recognize the N axis
TARGET_N = 13
#: simulated seconds per target — five epochs at the default period
TARGET_SIM_S = 1.0
#: every strategy, one recording each (LocalOnly … Distributed)
STRATEGIES = (0, 1, 2, 3, 4)
DISTRIBUTED = 4


@dataclass(frozen=True)
class Target:
    name: str
    kind: str                       # sim | kernel | executor | serve
    # (device, strategy) -> (fn, args); strategy None for a target
    # without one
    build: Callable[[torch.device, Optional[int]], Tuple[Callable, tuple]]
    n_axis: Optional[int] = TARGET_N   # None: no cross-node axis to audit
    strategies: Tuple[Optional[int], ...] = (None,)


class TracedTarget:
    """One target's recordings: float32 per strategy always, the float64
    pair for J002 (``err64``: what the float64 run raised, if it did)."""

    def __init__(self, target: Target, rec32: Dict, rec64: Dict, err64):
        self.target = target
        self.name = target.name
        self.n_axis = target.n_axis
        self.rec32: Dict[Optional[int], Recording] = rec32
        self.rec64: Dict[Optional[int], Recording] = rec64
        self.err64: Optional[BaseException] = err64

    def kernels(self) -> Dict[str, int]:
        """Kernel launches over the float32 recordings."""
        out: Dict[str, int] = {}
        for rec in self.rec32.values():
            for k, v in rec.kernels().items():
                out[k] = out.get(k, 0) + v
        return out


def record(fn, args, dtype=torch.float32, full: bool = True) -> Recording:
    """Record ``fn(*args)`` with ``dtype`` as the default dtype (restored
    afterwards)."""
    prev = torch.get_default_dtype()
    torch.set_default_dtype(dtype)
    try:
        with torch.no_grad(), Recorder(full=full) as rec:
            fn(*args)
    finally:
        torch.set_default_dtype(prev)
    return rec.recording()


def warm(fn, args) -> None:
    """Run ``fn(*args)`` once unrecorded: the recordings are of the
    steady state, without what a first call does once (host constants
    filled into a cache, such as ``scenario.burst_probs``)."""
    with torch.no_grad():
        fn(*args)


def record32_64(fn, args) -> Tuple[Recording, Optional[Recording],
                                   Optional[BaseException]]:
    """Record ``fn(*args)`` under float32 and float64 default dtypes;
    returns (rec32, rec64, err64).  ``rec64``/``err64`` are mutually
    exclusive: a raise under float64 is itself a J002 signal (the
    program's types depend on the default dtype).  Run it on a warm
    program (:func:`warm`): a first call's cache fills would otherwise
    make the two streams differ."""
    rec32 = record(fn, args)
    try:
        return rec32, record(fn, args, torch.float64, full=False), None
    except Exception as err:                 # the J002 signal, not a crash
        return rec32, None, err


# ---------------------------------------------------------------------------
# the targets
# ---------------------------------------------------------------------------


def _sim_cfg(**over):
    from repro_torch.configs import SwarmConfig
    return SwarmConfig(num_workers=TARGET_N, sim_time_s=TARGET_SIM_S, **over)


def _keys(device):
    """One run's key, [1, 2]."""
    from repro_torch import rng
    return rng.split(rng.PRNGKey(0, device=device), 1)


def _sim_builder(**over):
    def build(device, strategy):
        from repro_torch.swarm.simulator import run_sim
        cfg = _sim_cfg(**over)

        def fn(keys, strategy):
            return run_sim(keys, cfg, strategy, TARGET_N)
        return fn, (_keys(device), strategy)
    return build


def _uniform(gen, shape, device, lo=0.5, hi=1.5):
    return (torch.rand(shape, generator=gen, dtype=torch.float32)
            * (hi - lo) + lo).to(device)


def _kernel_dense(device, strategy):
    from repro_torch.kernels import ops
    n, gen = TARGET_N, torch.Generator().manual_seed(0)
    inv_phi = _uniform(gen, (1, n), device)
    F = torch.ones((1, n), dtype=torch.float32, device=device)
    d_tx = torch.ones((1, n, n), dtype=torch.float32, device=device)
    return ops.diffusive_phi, (inv_phi, F, d_tx)


def _kernel_sparse(device, strategy):
    from repro_torch.kernels import ops
    n, K, gen = TARGET_N, 4, torch.Generator().manual_seed(0)
    inv_phi = _uniform(gen, (1, n), device)
    F = torch.ones((1, n), dtype=torch.float32, device=device)
    nbr = torch.arange(K, dtype=torch.int32, device=device).expand(
        1, n, K).contiguous()
    d_tx_e = torch.ones((1, n, K), dtype=torch.float32, device=device)
    return ops.diffusive_phi_sparse, (inv_phi, F, d_tx_e, nbr)


def _executor(backend: str, runs: int, kw: Callable):
    def build(device, strategy):
        from repro_torch import rng
        from repro_torch.fleet.executor import run_batch
        cfg = _sim_cfg()

        def fn(key, strategy):
            return run_batch(key, cfg, strategy, TARGET_N, runs,
                             backend=backend, **kw(device))
        return fn, (rng.PRNGKey(0, device=device), strategy)
    return build


def _serve_congestion_core(device, strategy):
    from repro_torch.core.early_exit import (CongestionState,
                                             congestion_update, exit_label)
    n_stages = 4

    def fn(prev_T, prev_D, qlens):
        state = congestion_update(CongestionState(prev_T, prev_D), qlens,
                                  dt=0.01, alpha=0.3)
        return state.prev_T, state.D, exit_label(state.D, 1.5, 2.5)
    z = torch.zeros((n_stages,), dtype=torch.float32, device=device)
    return fn, (z, z, z)


def all_targets() -> List[Target]:
    sim = dict(strategies=STRATEGIES)
    return [
        Target("sim_dense", "sim", _sim_builder(), **sim),
        Target("sim_sparse", "sim",
               _sim_builder(neighbor_mode="sparse", neighbor_k=4), **sim),
        Target("sim_traced", "sim",
               _sim_builder(trace_capacity=64, trace_hop_capacity=64,
                            trace_state_every=2), **sim),
        Target("sim_scenario_stochastic", "sim",
               _sim_builder(channel_model="log_normal_corr",
                            mobility_model="gauss_markov",
                            fault_model="markov"), **sim),
        Target("sim_scenario_fading", "sim",
               _sim_builder(channel_model="rician",
                            mobility_model="levy_flight"), **sim),
        Target("kernel_phi_dense", "kernel", _kernel_dense),
        Target("kernel_phi_sparse", "kernel", _kernel_sparse),
        # n_axis=None: the executor targets audit the *batching wrappers*
        # (dtype drift, host data, index provenance); the cross-node-axis
        # loop audit runs on the sim targets, which run the same body
        Target("executor_vmap", "executor",
               _executor("vmap", 3, lambda d: {"device": d}), n_axis=None,
               strategies=(DISTRIBUTED,)),
        Target("executor_streaming", "executor",
               _executor("streaming", 2,
                         lambda d: {"device": d, "chunk_size": 2}),
               n_axis=None, strategies=(DISTRIBUTED,)),
        Target("executor_sharded", "executor",
               _executor("sharded", 1, lambda d: {"devices": [d]}),
               n_axis=None, strategies=(DISTRIBUTED,)),
        Target("serve_congestion_core", "serve", _serve_congestion_core,
               n_axis=None),
    ]


# (device, target name) -> TracedTarget: a process records each once
_TRACED: Dict[Tuple[str, str], TracedTarget] = {}


def trace_target(t: Target, device: torch.device) -> TracedTarget:
    """Record one target on ``device``, every strategy, float32 and
    float64 (cached per process)."""
    key = (str(device), t.name)
    if key not in _TRACED:
        rec32, rec64, err64 = {}, {}, None
        for i, s in enumerate(t.strategies):
            fn, args = t.build(device, s)
            if i == 0:       # the caches a first call fills are per config
                warm(fn, args)
            r32, r64, err = record32_64(fn, args)
            rec32[s] = r32
            if err is not None:
                err64 = err64 or err
            else:
                rec64[s] = r64
        _TRACED[key] = TracedTarget(t, rec32, rec64, err64)
    return _TRACED[key]


def trace_targets(targets: Optional[List[Target]] = None, device=None
                  ) -> Dict[str, TracedTarget]:
    """Record every target (shared across all J rules) on ``device``: CUDA
    unless the caller asks for another device; it raises where CUDA is
    absent."""
    from repro_torch.device import resolve_device
    dev = resolve_device(device)
    return {t.name: trace_target(t, dev)
            for t in (all_targets() if targets is None else targets)}
