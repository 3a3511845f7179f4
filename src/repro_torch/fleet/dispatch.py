"""Multi-host sweep dispatch: fleet points across processes (DESIGN.md §9);
port of ``repro/fleet/dispatch.py``.

The executors (`fleet/executor.py`) scale one point's Monte-Carlo axis over
the devices of one process; this module scales the *point* axis of a whole
:class:`SweepSpec` over worker processes — locally via ``multiprocessing``
spawn (a forked CUDA context is unusable), remotely via a rank/world-size
env contract (one process per host, the variables of the reference; with a
coordinator given, ``torch.distributed`` is initialised from it).  Three design rules keep the
distributed run equivalent to a local one:

  * **The store is the only coordination channel.**  Workers share nothing
    but a :class:`ResultStore` root (a shared filesystem in the multi-host
    case).  Completed points are content-addressed results; in-flight
    points are advisory lease files; a streaming point killed mid-chunk
    resumes from its `repro_torch.checkpoint` partial.  There is no dispatcher
    process to lose.
  * **Work-stealing with idempotent execution.**  Each worker first walks
    its round-robin shard of the expanded points (``points[rank::world]``),
    then steals any remaining point whose lease is missing or expired — so
    a killed worker's points re-enter the pool after ``lease_ttl_s``, the
    fleet-level analogue of the paper's fault-tolerant forwarding.  Leases
    only provide liveness, not mutual exclusion: execution is idempotent
    (results are bit-identical and published by atomic rename), so a
    double-claim costs wall time, never correctness.
  * **Deterministic gather.**  ``collect`` reads results back in expansion
    order from the store, so the report JSON is byte-identical to a
    single-process run no matter how points were interleaved across workers
    (tested in ``tests/test_torch_dispatch.py``).

Progress surface: every completed point appends one JSON line to a shared
``progress.jsonl`` (O_APPEND single-write, safe across processes); the
``sweep_start`` row carries the point total, so ``render_progress`` can
show completed/total, points/min and ETA while a sweep is running anywhere
on the fleet.  Streaming points append an ``event: "chunk"`` row per
completed chunk, and computed point rows carry the executor's
``compile_s`` / ``execute_s`` spans.  Points run with the state stream on
(``trace_state_every > 0``) also append live swarm-health rows, ``event:
"gauges"`` per computed point and the same gauges on each ``chunk`` row:
the flight recorder's final system gauges (mean and max queue depth, φ
spread, completion rate, simulated time), which ``render_progress``
shows beside the ETA.

Env contract (remote mode — set per host, then run
``python -m repro_torch.fleet.dispatch`` on each)::

    REPRO_FLEET_HOSTS=h0,h1,h2   # optional roster; len() defaults the world
    REPRO_FLEET_WORLD_SIZE=3     # explicit world size (overrides roster)
    REPRO_FLEET_RANK=1           # this process's rank in [0, world)
    REPRO_FLEET_COORD=h0:9876    # optional torch.distributed coordinator

Workers run on the card unless given ``device="cpu"`` (``--device cpu``).
"""
from __future__ import annotations

import argparse
import dataclasses
import json
import multiprocessing
import os
import socket
import threading
import time
from typing import Dict, List, Optional

import numpy as np

from repro_torch.fleet.executor import (BACKENDS, DEFAULT_CHUNK, GAUGES,
                                        run_point)
from repro_torch.fleet.store import ResultStore, point_digest
from repro_torch.fleet.sweep import SweepSpec

ENV_RANK = "REPRO_FLEET_RANK"
ENV_WORLD = "REPRO_FLEET_WORLD_SIZE"
ENV_HOSTS = "REPRO_FLEET_HOSTS"
ENV_COORD = "REPRO_FLEET_COORD"

DEFAULT_LEASE_TTL_S = 30.0   # reclaim delay after a worker dies; live
                             # workers heartbeat-renew at ttl/2, so slow
                             # points never expire just by being slow
_POLL_S = 0.2                # wait between scans while peers hold leases


# ---------------------------------------------------------------------------
# env contract
# ---------------------------------------------------------------------------


@dataclasses.dataclass(frozen=True)
class WorkerEnv:
    rank: int
    world: int
    coordinator: Optional[str] = None


def worker_env(environ=None) -> WorkerEnv:
    """Parse the ``REPRO_FLEET_*`` contract; defaults to a world of one."""
    env = os.environ if environ is None else environ
    hosts = [h for h in env.get(ENV_HOSTS, "").split(",") if h]
    world = int(env.get(ENV_WORLD, len(hosts) or 1))
    rank = int(env.get(ENV_RANK, 0))
    if world < 1 or not 0 <= rank < world:
        raise ValueError(
            f"bad fleet env: rank={rank} world={world} "
            f"(need 0 <= {ENV_RANK} < {ENV_WORLD})")
    return WorkerEnv(rank=rank, world=world,
                     coordinator=env.get(ENV_COORD) or None)


def maybe_init_distributed(env: WorkerEnv, device=None) -> bool:
    """``torch.distributed.init_process_group`` from the env contract, when
    a coordinator is given (``tcp://<coordinator>``, NCCL on the card, gloo
    on the CPU).

    Point sharding itself needs no collective coordination (the store is
    the only channel); this exists so a worker's process group spans the
    fleet when a coordinator address is provided.
    """
    if env.coordinator is None or env.world <= 1:
        return False
    import torch
    import torch.distributed as dist
    cpu = device is not None and torch.device(device).type == "cpu"
    dist.init_process_group(backend="gloo" if cpu else "nccl",
                            init_method=f"tcp://{env.coordinator}",
                            world_size=env.world, rank=env.rank)
    return True


# ---------------------------------------------------------------------------
# progress surface
# ---------------------------------------------------------------------------


class ProgressWriter:
    """Append-only JSONL progress rows, multi-process safe.

    Each row is one ``write()`` of a single line to an O_APPEND stream —
    atomic for short lines on POSIX — so any number of local or remote
    workers may share one file without interleaving partial lines.

    A ``sweep_start`` row *truncates* the file first: the file always holds
    the latest sweep, so it never grows without bound across runs and
    re-parses stay cheap.  (The dispatcher writes
    ``sweep_start`` before workers write rows; a straggler row from a prior
    sweep erased by the truncation is re-surfaced by the cached-row scan in
    ``run_worker``.)
    """

    def __init__(self, path: str):
        self.path = path
        d = os.path.dirname(path)
        if d:
            os.makedirs(d, exist_ok=True)

    def emit(self, **row) -> None:
        mode = "w" if row.get("event") == "sweep_start" else "a"
        with open(self.path, mode) as f:
            f.write(json.dumps(row, sort_keys=True) + "\n")


def read_progress(path: str) -> List[Dict]:
    if not os.path.exists(path):
        return []
    rows = []
    with open(path) as f:
        for line in f:
            line = line.strip()
            if not line:
                continue
            try:
                rows.append(json.loads(line))
            except json.JSONDecodeError:
                continue     # torn tail line of a live writer: skip
    return rows


def progress_summary(rows: List[Dict]) -> Optional[Dict]:
    """Completed/total, points/min and ETA for the *latest* sweep in rows."""
    start_idx = None
    for i, r in enumerate(rows):
        if r.get("event") == "sweep_start":
            start_idx = i
    if start_idx is None:
        return None
    start = rows[start_idx]
    done = {}
    for r in rows[start_idx + 1:]:
        if r.get("event") == "point":
            # digest may be emitted as null (storeless execute rows):
            # fall back to the label, never collapse onto one None key
            done[r.get("digest") or r.get("label")] = r
    completed, total = len(done), int(start.get("total", 0))
    ts = [r["t"] for r in done.values() if "t" in r]
    elapsed = (max(ts) - start["t"]) if ts and "t" in start else 0.0
    rate = completed / (elapsed / 60.0) if elapsed > 0 else 0.0
    eta = (total - completed) / (rate / 60.0) if rate > 0 else None
    gauges = None
    for r in rows[start_idx + 1:]:
        # live swarm health: the latest gauges or chunk row of this sweep
        # (present only when points run with the state stream on)
        if "queue_depth_mean" in r:
            gauges = {k: r[k] for k in GAUGES if k in r}
    return {"sweep": start.get("sweep", "?"), "completed": completed,
            "total": total, "points_per_min": rate, "eta_s": eta,
            "gauges": gauges}


def render_progress(summary: Optional[Dict]) -> str:
    if summary is None:
        return "no sweep in progress file yet"
    eta = ("--" if summary["eta_s"] is None
           else f"{summary['eta_s']:.0f}s")
    line = (f"[{summary['sweep']}] {summary['completed']}/{summary['total']} "
            f"points · {summary['points_per_min']:.1f} points/min · "
            f"ETA {eta}")
    g = summary.get("gauges")
    if g:
        line += (f" · q̄ {g.get('queue_depth_mean', 0):.1f}"
                 f"/max {g.get('queue_depth_max', 0):.0f}")
        if "phi_spread" in g:
            line += f" · φΔ {g['phi_spread']:.2f}"
        line += f" · done {100.0 * g.get('completion_rate', 0):.0f}%"
    return line


# ---------------------------------------------------------------------------
# worker loop
# ---------------------------------------------------------------------------


def _worker_id(rank: int) -> str:
    return f"{socket.gethostname()}:{os.getpid()}:r{rank}"


def claim_order(num_points: int, rank: int, world: int) -> List[int]:
    """Round-robin shard first, then everyone else's points (steal order)."""
    own = list(range(rank, num_points, world))
    rest = [i for i in range(num_points) if i % world != rank % world]
    return own + rest


def _renew_loop(store: ResultStore, digest: str, owner: str,
                ttl_s: float, stop: threading.Event) -> None:
    while not stop.wait(max(ttl_s / 2.0, 0.05)):
        store.renew_lease(digest, owner, ttl_s)


def run_worker(spec: SweepSpec, store: ResultStore, *, rank: int = 0,
               world: int = 1, backend: str = "vmap",
               chunk_size: int = DEFAULT_CHUNK,
               lease_ttl_s: float = DEFAULT_LEASE_TTL_S,
               progress: Optional[ProgressWriter] = None,
               max_points: Optional[int] = None,
               poll_s: float = _POLL_S, device=None) -> int:
    """One worker's claim-and-compute loop; returns points computed here.

    Blocks until *every* point of ``spec`` has a result in ``store`` (some
    computed here, some by peers), so a caller returning from this function
    may immediately ``collect``.  ``max_points`` makes the worker exit
    early after computing that many points — the dispatch-level analogue of
    the streaming backend's ``max_chunks`` (a deterministic stand-in for a
    killed worker in resume tests).
    """
    points = spec.expand()
    digests = [point_digest(p) for p in points]
    me = _worker_id(rank)
    computed = 0
    emitted = set()    # digests this worker has written a progress row for

    def emit(i, wall, cached, spans=None):
        emitted.add(digests[i])
        if progress is not None:
            row = {"event": "point", "label": points[i].label,
                   "digest": digests[i], "worker": me,
                   "num_runs": points[i].num_runs,
                   "wall_s": round(wall, 3), "cached": cached,
                   "t": time.time()}
            if spans and spans.get("_compile_s") is not None:
                row["compile_s"] = round(spans["_compile_s"], 3)
                row["execute_s"] = round(spans["_execute_s"], 3)
            progress.emit(**row)

    while True:
        progressed = False
        for i in claim_order(len(points), rank, world):
            if max_points is not None and computed >= max_points:
                return computed
            dig = digests[i]
            if store.has(dig):
                # already in the store (cache hit / peer / earlier run):
                # still surface it once, or a resumed dispatch's progress
                # file would never reach the sweep_start total
                if dig not in emitted:
                    emit(i, 0.0, cached=True)
                continue
            if not store.try_claim(dig, me, lease_ttl_s):
                continue     # live lease elsewhere; revisit next scan
            # heartbeat: renew the lease while the point computes, so only
            # a *dead* worker's lease ever expires into a steal — a slow
            # point never exceeds its TTL just by being slow
            stop = threading.Event()
            renewer = threading.Thread(
                target=_renew_loop,
                args=(store, dig, me, lease_ttl_s, stop), daemon=True)
            renewer.start()
            try:
                if store.has(dig):
                    continue     # completed between has() and claim
                t0 = time.perf_counter()
                spans: Dict[str, float] = {}
                run_point(points[i], backend=backend, store=store,
                          chunk_size=chunk_size, progress=progress,
                          device=device, spans=spans)
                wall = time.perf_counter() - t0
            finally:
                stop.set()
                renewer.join()
                store.release_lease(dig, owner=me)
            computed += 1
            progressed = True
            emit(i, wall, cached=False, spans=spans)
        if all(store.has(d) for d in digests):
            return computed
        if not progressed:
            time.sleep(poll_s)   # peers hold live leases: wait, then rescan
                                 # (a dead peer's lease expires into steals)


# ---------------------------------------------------------------------------
# local multi-process dispatch
# ---------------------------------------------------------------------------


def _worker_entry(spec_json: str, store_root: str, rank: int, world: int,
                  backend: str, chunk_size: int, lease_ttl_s: float,
                  progress_path: Optional[str],
                  max_points: Optional[int], device) -> None:
    """Spawn target (module-level for picklability under 'spawn')."""
    spec = SweepSpec.from_json(spec_json)
    store = ResultStore(store_root)
    progress = ProgressWriter(progress_path) if progress_path else None
    run_worker(spec, store, rank=rank, world=world, backend=backend,
               chunk_size=chunk_size, lease_ttl_s=lease_ttl_s,
               progress=progress, max_points=max_points, device=device)


def spawn_workers(spec: SweepSpec, store_root: str, world: int, *,
                  backend: str = "vmap", chunk_size: int = DEFAULT_CHUNK,
                  lease_ttl_s: float = DEFAULT_LEASE_TTL_S,
                  progress_path: Optional[str] = None,
                  max_points: Optional[int] = None, device=None) -> List:
    """Start ``world`` spawned worker processes over a shared store root.

    'spawn' (not fork) so every worker initializes its own CUDA context —
    a CUDA context does not survive a fork.
    """
    ctx = multiprocessing.get_context("spawn")
    device = None if device is None else str(device)
    procs = [
        ctx.Process(target=_worker_entry,
                    args=(spec.to_json(), store_root, r, world, backend,
                          chunk_size, lease_ttl_s, progress_path,
                          max_points, device),
                    name=f"fleet-worker-r{r}")
        for r in range(world)]
    for p in procs:
        p.start()
    return procs


def collect(spec: SweepSpec, store: ResultStore
            ) -> Dict[str, Dict[str, np.ndarray]]:
    """Deterministic gather: every point of ``spec``, in expansion order.

    Reading back from the store (rather than returning in completion
    order) is what makes the multi-worker report byte-identical to a
    single-process run.  Raises if any point is missing — redispatch to
    resume; completed points are cache hits, partial streaming points
    resume at their last chunk.
    """
    out = {}
    missing = []
    for pt in spec.expand():
        m = store.get(point_digest(pt))
        if m is None:
            missing.append(pt.label)
        else:
            out[pt.label] = m
    if missing:
        raise RuntimeError(
            f"sweep {spec.name!r}: {len(missing)} point(s) missing from "
            f"store (first: {missing[0]!r}); redispatch to resume")
    return out


def dispatch(spec: SweepSpec, store: ResultStore, *, workers: int = 2,
             backend: str = "vmap", chunk_size: int = DEFAULT_CHUNK,
             lease_ttl_s: float = DEFAULT_LEASE_TTL_S,
             progress_path: Optional[str] = None,
             max_points_per_worker: Optional[int] = None, device=None
             ) -> Dict[str, Dict[str, np.ndarray]]:
    """Run ``spec`` across ``workers`` local processes and collect.

    ``workers <= 1`` runs the claim loop in-process (same lease/progress
    protocol, no spawn cost).  Workers that die are survivable: as long as
    one worker lives, expired leases are stolen and the sweep completes;
    if all die, ``collect`` raises and a re-``dispatch`` resumes from the
    store.
    """
    if backend not in BACKENDS:
        raise ValueError(f"unknown backend {backend!r}; one of {BACKENDS}")
    progress = ProgressWriter(progress_path) if progress_path else None
    if progress is not None:
        progress.emit(event="sweep_start", sweep=spec.name,
                      total=len(spec.expand()), t=time.time())
    if workers <= 1:
        run_worker(spec, store, rank=0, world=1, backend=backend,
                   chunk_size=chunk_size, lease_ttl_s=lease_ttl_s,
                   progress=progress, max_points=max_points_per_worker,
                   device=device)
    else:
        procs = spawn_workers(spec, store.root, workers, backend=backend,
                              chunk_size=chunk_size, lease_ttl_s=lease_ttl_s,
                              progress_path=progress_path,
                              max_points=max_points_per_worker,
                              device=device)
        for p in procs:
            p.join()
        failed = [(p.name, p.exitcode) for p in procs if p.exitcode != 0]
        try:
            return collect(spec, store)
        except RuntimeError as e:
            if failed:
                # an incomplete sweep with dead workers: surface the exit
                # codes, or 'redispatch to resume' hides a systematic
                # child crash (bad spec, device init failure under spawn)
                raise RuntimeError(
                    f"{e}; worker processes exited non-zero: {failed} "
                    "(see their stderr for the underlying error)") from e
            raise
    return collect(spec, store)


def run_sweep(spec: SweepSpec, store: ResultStore, *,
              workers: Optional[int] = None, backend: str = "vmap",
              chunk_size: int = DEFAULT_CHUNK,
              lease_ttl_s: float = DEFAULT_LEASE_TTL_S,
              progress_path: Optional[str] = None, device=None
              ) -> Optional[Dict[str, Dict[str, np.ndarray]]]:
    """Entry point covering both dispatch modes.

    With the ``REPRO_FLEET_*`` env contract set (one process per host),
    this process becomes that rank's worker against the shared store; every
    rank blocks until the sweep completes, then rank 0 collects and returns
    (other ranks return ``None``).  Otherwise it is a local multi-process
    ``dispatch`` with ``workers`` processes (default 1).
    """
    env = worker_env()
    if env.world > 1:
        maybe_init_distributed(env, device)
        progress = ProgressWriter(progress_path) if progress_path else None
        if env.rank == 0 and progress is not None:
            progress.emit(event="sweep_start", sweep=spec.name,
                          total=len(spec.expand()), t=time.time())
        run_worker(spec, store, rank=env.rank, world=env.world,
                   backend=backend, chunk_size=chunk_size,
                   lease_ttl_s=lease_ttl_s, progress=progress,
                   device=device)
        return collect(spec, store) if env.rank == 0 else None
    return dispatch(spec, store, workers=workers or 1, backend=backend,
                    chunk_size=chunk_size, lease_ttl_s=lease_ttl_s,
                    progress_path=progress_path, device=device)


# ---------------------------------------------------------------------------
# spec publication + CLI
# ---------------------------------------------------------------------------


def publish_spec(spec: SweepSpec, store: ResultStore) -> str:
    """Write the spec JSON into the store so remote workers can find it by
    name: ``python -m repro_torch.fleet.dispatch --spec <name> --store
    <root>``."""
    d = os.path.join(store.root, "sweeps")
    os.makedirs(d, exist_ok=True)
    path = os.path.join(d, spec.name + ".json")
    tmp = path + ".tmp"
    with open(tmp, "w") as f:
        f.write(spec.to_json())
    os.replace(tmp, path)
    return path


def _load_spec(ref: str, store: ResultStore) -> SweepSpec:
    path = ref if os.path.exists(ref) else os.path.join(
        store.root, "sweeps", ref + ".json")
    if not os.path.exists(path):
        raise FileNotFoundError(
            f"spec {ref!r}: not a file and not published under "
            f"{os.path.join(store.root, 'sweeps')}")
    with open(path) as f:
        return SweepSpec.from_json(f.read())


def main(argv=None) -> None:
    ap = argparse.ArgumentParser(
        prog="python -m repro_torch.fleet.dispatch",
        description="Run a published SweepSpec as one fleet worker (env "
                    "contract) or a local worker pool (--workers).")
    ap.add_argument("--spec", required=True,
                    help="path to a SweepSpec JSON, or a name published "
                         "via publish_spec under <store>/sweeps/")
    ap.add_argument("--store", required=True, help="shared store root")
    ap.add_argument("--workers", type=int, default=0,
                    help="local worker processes; 0 = follow the "
                         "REPRO_FLEET_* env contract in-process")
    ap.add_argument("--backend", default="vmap", choices=BACKENDS)
    ap.add_argument("--chunk-size", type=int, default=DEFAULT_CHUNK)
    ap.add_argument("--lease-ttl", type=float, default=DEFAULT_LEASE_TTL_S)
    ap.add_argument("--progress", default=None,
                    help="progress.jsonl path")
    ap.add_argument("--device", default=None,
                    help="'cpu' to run on the CPU (default: the card)")
    args = ap.parse_args(argv)

    store = ResultStore(args.store)
    spec = _load_spec(args.spec, store)
    res = run_sweep(spec, store, workers=args.workers or None,
                    backend=args.backend, chunk_size=args.chunk_size,
                    lease_ttl_s=args.lease_ttl,
                    progress_path=args.progress, device=args.device)
    if res is not None:
        print(f"[fleet.dispatch] sweep {spec.name!r}: "
              f"{len(res)} points complete in {store.root}")


if __name__ == "__main__":
    main()
