"""Execution backends for Monte-Carlo sweep points (DESIGN.md §8.2); port
of ``repro/fleet/executor.py``.

All three backends batch the *seed* axis of one :class:`SweepPoint` around
the simulator's ``run_sim`` over an explicit run axis, from the same keys
``rng.split(key, num_runs)`` as the reference, and are bit-identical on
equal ``(cfg, strategy, n, num_runs, seed)`` — proven by tests — so the
choice is purely operational:

  * ``vmap``      — one ``run_sim`` over all runs on one device; the
                    default, and ``swarm.simulator.run_many``'s path.
  * ``sharded``   — the run axis split into one contiguous slice per
                    device (by default every visible CUDA device), each
                    slice run on its own device, the results concatenated
                    in run order on the first.  The run count is padded up
                    to a multiple of the device count by repeating the last
                    key (padding is computed then discarded — never
                    over-split the key, key-prefix stability does not hold
                    across split widths).
  * ``streaming`` — a host loop over fixed-size chunks of the keys, the
                    last one padded as above; each chunk is one ``run_sim``
                    and its metrics go to the host, so device memory holds
                    one chunk's state whatever the run count.  With a store
                    attached, each completed chunk checkpoints, and a
                    killed sweep resumes at the last completed chunk.

Bit-identity rests on the port's determinism rule: no float reduction
crosses runs before ``summarize``, and every reduction inside a run has an
order that does not depend on how many runs share the batch (ROADMAP.md).

The telemetry streams (``trace_*`` configs) are refused by the simulator
(``swarm/simulator.init_state``), so no trace leaves ride through here yet.

Spans: ``run_point`` fills ``_compile_s`` / ``_execute_s`` as the
reference's does, so a report reads the same.  The port compiles nothing per
point (the kernel libraries are built once by ``kernels/build.py``), so
``_compile_s`` is 0.0; ``_execute_s`` ends in a device synchronise.
"""
from __future__ import annotations

import time
from typing import Dict, Optional, Sequence

import numpy as np
import torch

from repro_torch import rng
from repro_torch.configs import SwarmConfig
from repro_torch.device import resolve_device
from repro_torch.fleet.store import ResultStore, code_version, point_digest
from repro_torch.fleet.sweep import SweepPoint, SweepSpec
from repro_torch.swarm.simulator import run_sim

BACKENDS = ("vmap", "sharded", "streaming")
DEFAULT_CHUNK = 8


class SweepInterrupted(RuntimeError):
    """Raised by the streaming backend when ``max_chunks`` is reached —
    a deterministic stand-in for preemption in resume tests; progress up to
    the interrupt is checkpointed in the store."""


def _pad_keys(keys: torch.Tensor, to: int) -> torch.Tensor:
    pad = to - keys.shape[0]
    if pad <= 0:
        return keys
    return torch.cat([keys, keys[-1:].expand(pad, *keys.shape[1:])])


def _sync(device: torch.device) -> None:
    if device.type == "cuda":
        torch.cuda.synchronize(device)


def _run(keys: torch.Tensor, cfg: SwarmConfig, strategy: int, n: int
         ) -> Dict[str, torch.Tensor]:
    with torch.no_grad():
        return run_sim(keys, cfg, int(strategy), n)


def _shard_devices(device, devices) -> list:
    """The sharded backend's devices: ``devices`` as given, else one shard
    on ``device`` when the caller names one, else every visible CUDA
    device (raising where there is none)."""
    if devices is not None:
        return [torch.device(d) for d in devices]
    if device is not None:
        return [torch.device(device)]
    resolve_device(None)                     # raises without CUDA
    return [torch.device("cuda", i)
            for i in range(torch.cuda.device_count())]


def _run_sharded(key, cfg: SwarmConfig, strategy, n: int, num_runs: int,
                 devices: Sequence[torch.device]) -> Dict[str, torch.Tensor]:
    D = len(devices)
    padded = (num_runs + D - 1) // D * D
    per = padded // D
    keys = _pad_keys(rng.split(key.to(devices[0]), num_runs), padded)
    parts = [_run(keys[i * per:(i + 1) * per].to(dev), cfg, strategy, n)
             for i, dev in enumerate(devices)]
    return {k: torch.cat([p[k].to(devices[0]) for p in parts])[:num_runs]
            for k in parts[0]}


def _run_streaming(key, cfg: SwarmConfig, strategy, n: int, num_runs: int,
                   chunk_size: int, device: torch.device,
                   store: Optional[ResultStore] = None,
                   digest: Optional[str] = None,
                   max_chunks: Optional[int] = None,
                   spans: Optional[Dict] = None,
                   progress=None, label: Optional[str] = None
                   ) -> Dict[str, np.ndarray]:
    chunk = max(1, min(chunk_size, num_runs))
    n_chunks = (num_runs + chunk - 1) // chunk
    keys = rng.split(key.to(device), num_runs)
    if spans is not None:
        spans["_compile_s"] = 0.0
        spans.setdefault("_execute_s", 0.0)

    done, accum = 0, None
    if store is not None and digest is not None:
        done, accum = store.load_partial(digest, chunk_size=chunk)
        done = min(done, n_chunks)

    for c in range(done, n_chunks):
        if max_chunks is not None and c >= max_chunks:
            raise SweepInterrupted(
                f"stopped after {c}/{n_chunks} chunks (max_chunks)")
        ks = _pad_keys(keys[c * chunk:(c + 1) * chunk], chunk)
        t0 = time.perf_counter()
        out = {k: v.cpu().numpy() for k, v in
               _run(ks, cfg, strategy, n).items()}
        if spans is not None:
            spans["_execute_s"] += time.perf_counter() - t0
        if accum is None:
            accum = out
        else:
            accum = {k: np.concatenate([accum[k], out[k]]) for k in accum}
        if store is not None and digest is not None:
            store.save_partial(digest, c + 1, accum, chunk)
        if progress is not None:
            progress.emit(event="chunk", label=label, chunk=c + 1,
                          chunks=n_chunks, t=time.time())

    return {k: v[:num_runs] for k, v in accum.items()}


# ---------------------------------------------------------------------------
# public API
# ---------------------------------------------------------------------------


def run_batch(key: torch.Tensor, cfg: SwarmConfig, strategy, n: int,
              num_runs: int, *, backend: str = "vmap",
              chunk_size: int = DEFAULT_CHUNK, device=None,
              devices: Optional[Sequence] = None,
              spans: Optional[Dict] = None) -> Dict[str, torch.Tensor]:
    """Run ``num_runs`` Monte-Carlo simulations of ``(cfg, strategy, n)``
    from ``key`` (uint32[2]).

    Returns a dict of ``[num_runs]`` float32 tensors (see ``summarize``),
    bit-identical across backends: on ``device`` (CUDA unless the caller
    says otherwise; it raises where there is none), on the first shard's
    device for ``sharded`` (``devices``, by default every visible CUDA
    device).  ``swarm.run_many`` is this function's ``vmap`` backend.  A
    ``spans`` dict receives ``"_compile_s"`` (0.0: nothing is compiled per
    point) and ``"_execute_s"`` (ended by a device synchronise).
    """
    t0 = time.perf_counter()
    if backend == "vmap":
        dev = resolve_device(device)
        out = _run(rng.split(key.to(dev), num_runs), cfg, strategy, n)
    elif backend == "sharded":
        devs = _shard_devices(device, devices)
        dev = devs[0]
        out = _run_sharded(key, cfg, strategy, n, num_runs, devs)
    elif backend == "streaming":
        dev = resolve_device(device)
        out = {k: torch.from_numpy(v).to(dev) for k, v in _run_streaming(
            key, cfg, strategy, n, num_runs, chunk_size, dev).items()}
    else:
        raise ValueError(f"unknown backend {backend!r}; one of {BACKENDS}")
    if spans is not None:
        _sync(dev)
        spans["_compile_s"] = 0.0
        spans["_execute_s"] = time.perf_counter() - t0
    return out


def run_point(point: SweepPoint, *, backend: str = "vmap",
              store: Optional[ResultStore] = None,
              chunk_size: int = DEFAULT_CHUNK,
              max_chunks: Optional[int] = None,
              progress=None, device=None,
              devices: Optional[Sequence] = None,
              spans: Optional[Dict] = None) -> Dict[str, np.ndarray]:
    """Execute one sweep point, consulting/filling ``store`` if given;
    returns host (numpy float32) metrics.

    A caller-supplied ``spans`` dict receives ``"_compile_s"`` /
    ``"_execute_s"`` when the point is actually computed (a store hit
    fills nothing — it cost neither), keeping the returned metrics
    identical between computed and cached paths.  ``progress`` receives
    per-chunk rows (streaming).
    """
    if backend not in BACKENDS:
        raise ValueError(f"unknown backend {backend!r}; one of {BACKENDS}")
    digest = point_digest(point) if store is not None else None
    if store is not None:
        hit = store.get(digest)
        if hit is not None:
            return hit
    key = rng.PRNGKey(point.seed)
    if backend == "streaming":
        dev = resolve_device(device)
        metrics = _run_streaming(key, point.cfg, point.strategy, point.n,
                                 point.num_runs, chunk_size, dev,
                                 store=store, digest=digest,
                                 max_chunks=max_chunks, spans=spans,
                                 progress=progress, label=point.label)
    else:
        out = run_batch(key, point.cfg, point.strategy, point.n,
                        point.num_runs, backend=backend, device=device,
                        devices=devices, spans=spans)
        metrics = {k: v.cpu().numpy() for k, v in out.items()}
    if store is not None:
        store.put(digest, metrics, meta={
            "label": point.label, "backend": backend,
            "code_version": code_version()})
    return metrics


def execute(spec: SweepSpec, *, backend: str = "vmap",
            store: Optional[ResultStore] = None,
            chunk_size: int = DEFAULT_CHUNK,
            verbose: bool = False,
            progress=None, device=None,
            devices: Optional[Sequence] = None
            ) -> Dict[str, Dict[str, np.ndarray]]:
    """Expand and run a whole sweep; returns ``{point.label: metrics}``.

    Each point's wall time (including any cache hit) is recorded under the
    ``"_wall_s"`` pseudo-metric, and a computed point's spans under
    ``"_compile_s"`` / ``"_execute_s"`` (None on a store hit); reports skip
    underscore keys.  ``progress`` is an optional ``ProgressWriter``
    (``fleet/dispatch.py``): the single-process path then emits the same
    ``progress.jsonl`` rows as a dispatched run.
    """
    points = spec.expand()
    if progress is not None:
        progress.emit(event="sweep_start", sweep=spec.name,
                      total=len(points), t=time.time())
    out = {}
    for pt in points:
        t0 = time.perf_counter()
        spans: Dict[str, float] = {}
        m = dict(run_point(pt, backend=backend, store=store,
                           chunk_size=chunk_size, progress=progress,
                           device=device, devices=devices, spans=spans))
        m["_wall_s"] = time.perf_counter() - t0
        m["_compile_s"] = spans.get("_compile_s")
        m["_execute_s"] = spans.get("_execute_s")
        if verbose:
            print(f"[fleet:{spec.name}] {pt.label} "
                  f"({m['_wall_s']:.2f}s, backend={backend})")
        if progress is not None:
            row = {"event": "point", "label": pt.label,
                   "digest": point_digest(pt) if store is not None
                   else None,
                   "worker": "local", "num_runs": pt.num_runs,
                   "wall_s": round(m["_wall_s"], 3),
                   "cached": spans.get("_execute_s") is None,
                   "t": time.time()}
            if m["_compile_s"] is not None:
                row["compile_s"] = round(m["_compile_s"], 3)
                row["execute_s"] = round(m["_execute_s"], 3)
            progress.emit(**row)
        out[pt.label] = m
    return out
