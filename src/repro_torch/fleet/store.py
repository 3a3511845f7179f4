"""Content-addressed sweep-result store with resumable checkpoints
(DESIGN.md §8.3); port of ``repro/fleet/store.py``.

A sweep point is addressed by the SHA-256 of everything that determines its
numbers: the full ``SwarmConfig``, strategy, swarm size, Monte-Carlo run
count, seed, a git-describable code version and the implementation tag
``IMPL``.  Both packages live in one checkout, so ``git describe`` gives
them the same version; the tag keeps a port digest from ever equalling the
reference's for the same point, so two stores sharing a root never serve
one package's numbers to the other.  Because the executor
backends are bit-identical (tested), the digest deliberately excludes the
backend — a result computed by the streaming path on one host is a valid
cache hit for a ``vmap`` re-run on another.

Layout under the store root::

    <root>/<digest[:2]>/<digest>/result.json    # final (atomic rename)
    <root>/<digest[:2]>/<digest>/partial/       # checkpoint chunk dir

``result.json`` stores per-run float32 metrics as JSON floats; float32 →
float64 → decimal → float32 round-trips exactly, so a cache hit reproduces
the computed arrays bit-for-bit.  Partial progress from the streaming
backend goes through ``repro_torch.checkpoint.ckpt`` (atomic ``step_<k>`` dirs):
a sweep killed mid-point resumes at the last completed chunk and, because
per-run results are bitwise stable, yields the same report JSON as an
uninterrupted run (tested in ``tests/test_torch_fleet.py``).
"""
from __future__ import annotations

import dataclasses
import functools
import hashlib
import json
import os
import shutil
import subprocess
import time
from typing import Dict, Optional, Tuple

import numpy as np

from repro_torch.checkpoint import ckpt
from repro_torch.fleet.sweep import SweepPoint

IMPL = "repro_torch"


def _git(args, cwd, text=True):
    out = subprocess.run(["git"] + args, cwd=cwd, capture_output=True,
                         text=text, timeout=30)
    if out.returncode != 0:
        raise RuntimeError(f"git {args[0]} failed: {out.stderr}")
    return out.stdout


def _dirty_digest(cwd: str) -> str:
    """Content hash of everything uncommitted: the tracked diff plus each
    untracked (non-ignored) file.  A bare ``--dirty`` suffix would alias
    *every* dirty tree to one cache version and serve stale results across
    uncommitted edits."""
    h = hashlib.sha256(_git(["diff", "HEAD"], cwd, text=False))
    for rel in _git(["ls-files", "--others", "--exclude-standard"],
                    cwd).splitlines():
        h.update(rel.encode())
        path = os.path.join(cwd, rel)
        if os.path.isfile(path):
            with open(path, "rb") as f:
                h.update(f.read())
    return h.hexdigest()[:12]


@functools.lru_cache(maxsize=1)
def code_version() -> str:
    """Git-describable code version for cache keys.

    ``REPRO_CODE_VERSION`` overrides (hermetic builds / tests); falls back
    to ``git describe --always --dirty`` at this file's repo — with the
    ``-dirty`` suffix refined by a content hash of the uncommitted changes,
    so editing the code always moves the cache key — then to ``"unknown"``
    outside a git checkout (deployments without git should pin
    ``REPRO_CODE_VERSION`` to a build id, or stale hits become possible).
    """
    env = os.environ.get("REPRO_CODE_VERSION")
    if env:
        return env
    cwd = os.path.dirname(os.path.abspath(__file__))
    try:
        desc = _git(["describe", "--always", "--dirty"], cwd).strip()
        if desc.endswith("-dirty"):
            desc += "." + _dirty_digest(cwd)
        return desc or "unknown"
    except (OSError, RuntimeError, subprocess.SubprocessError):
        return "unknown"


def _compact_trace(key: str, v) -> np.ndarray:
    """Trim trailing all-unwritten slots off a record buffer
    (``trace_records`` / ``trace_hops``).

    Slots are seq-indexed, so a buffer sized generously above the record
    count is mostly ``seq = -1`` sentinel rows; persisting them as JSON
    would bloat ``result.json`` by the (capacity / records) ratio.  Only
    slots past the last written seq of *any* run are dropped — per-run
    shape structure and every written record survive, so decode/export of
    a cache hit equals the freshly computed buffer.  Both schemas keep
    ``seq`` in column 0 (asserted), so one trim covers both streams.

    The flight-recorder buffers (``trace_state`` / ``trace_state_sys`` /
    ``trace_state_epochs``) are *epoch*-indexed with exact static size
    S = ceil(n_epochs / every) — no sentinel slack to trim — so they pass
    through here untouched (nested ``tolist`` in ``put`` round-trips any
    rank).
    """
    rec = np.asarray(v, np.float32)
    if (key not in ("trace_records", "trace_hops") or rec.ndim != 3
            or rec.shape[1] == 0):
        return rec
    from repro_torch.trace import schema
    assert schema.SEQ == 0 and schema.HOP_SEQ == 0
    written = np.nonzero((rec[..., 0] >= 0).any(axis=0))[0]
    return rec[:, :int(written[-1]) + 1 if written.size else 0]


def point_digest(point: SweepPoint, version: Optional[str] = None) -> str:
    """Content address of a sweep point's result; ``IMPL`` is in it
    whatever the version (``REPRO_CODE_VERSION`` included)."""
    payload = {
        "impl": IMPL,
        "cfg": dataclasses.asdict(point.cfg),
        "strategy": int(point.strategy),
        "n": int(point.n),
        "num_runs": int(point.num_runs),
        "seed": int(point.seed),
        "code_version": version if version is not None else code_version(),
    }
    blob = json.dumps(payload, sort_keys=True).encode()
    return hashlib.sha256(blob).hexdigest()


class ResultStore:
    """Digest-keyed result cache + per-chunk resume state for one store root."""

    def __init__(self, root: str):
        self.root = root

    def _dir(self, digest: str) -> str:
        return os.path.join(self.root, digest[:2], digest)

    def _partial_dir(self, digest: str) -> str:
        return os.path.join(self._dir(digest), "partial")

    def _lease_path(self, digest: str) -> str:
        return os.path.join(self.root, "leases", digest + ".json")

    # ---- final results ---------------------------------------------------

    def has(self, digest: str) -> bool:
        return os.path.exists(os.path.join(self._dir(digest), "result.json"))

    def get(self, digest: str) -> Optional[Dict[str, np.ndarray]]:
        path = os.path.join(self._dir(digest), "result.json")
        if not os.path.exists(path):
            return None
        with open(path) as f:
            doc = json.load(f)
        return {k: np.asarray(v, np.float32)
                for k, v in doc["metrics"].items()}

    def put(self, digest: str, metrics: Dict[str, np.ndarray],
            meta: Optional[Dict] = None) -> str:
        d = self._dir(digest)
        os.makedirs(d, exist_ok=True)
        # nested tolist() keeps array shapes (the trace record buffers are
        # [num_runs, capacity, fields]); for the historical 1-D metric
        # vectors the emitted JSON is byte-identical to the flat form
        doc = {
            "meta": meta or {},
            "metrics": {k: _compact_trace(k, v).tolist()
                        for k, v in metrics.items()},
        }
        tmp = os.path.join(d, "result.json.tmp")
        with open(tmp, "w") as f:
            json.dump(doc, f)
        os.replace(tmp, os.path.join(d, "result.json"))
        self.clear_partial(digest)
        return os.path.join(d, "result.json")

    # ---- streaming-resume chunk checkpoints ------------------------------

    def save_partial(self, digest: str, chunks_done: int,
                     accum: Dict[str, np.ndarray],
                     chunk_size: int) -> None:
        """Checkpoint the first ``chunks_done`` chunks' per-run metrics."""
        ckpt.save(self._partial_dir(digest), chunks_done, dict(accum),
                  keep=1, extra={"metrics": sorted(accum),
                                 "chunk_size": int(chunk_size)})

    def load_partial(self, digest: str, chunk_size: Optional[int] = None
                     ) -> Tuple[int, Optional[Dict[str, np.ndarray]]]:
        """Returns (chunks_done, accum) of the newest partial checkpoint,
        or (0, None) when there is nothing to resume.

        ``chunks_done`` only indexes runs together with the chunk size it
        was written under — with ``chunk_size`` given, a partial written
        under a *different* chunking is discarded (resuming it would skip
        or duplicate Monte-Carlo runs) and the sweep restarts cleanly.
        """
        d = self._partial_dir(digest)
        step = ckpt.latest_step(d)
        if step is None:
            return 0, None
        with open(os.path.join(d, f"step_{step:08d}",
                               "manifest.json")) as f:
            extra = json.load(f)["extra"]
        if chunk_size is not None and extra.get("chunk_size") != chunk_size:
            self.clear_partial(digest)
            return 0, None
        like = {k: 0 for k in extra["metrics"]}
        tree, _ = ckpt.restore(d, like, step=step)
        return step, {k: np.asarray(v) for k, v in tree.items()}

    def clear_partial(self, digest: str) -> None:
        shutil.rmtree(self._partial_dir(digest), ignore_errors=True)

    # ---- point leases (fleet/dispatch.py work-stealing) ------------------
    #
    # A lease is an advisory exclusive claim on a point, held by one worker
    # while it computes.  ``try_claim`` is an atomic create-exclusive of a
    # JSON lease file; a lease whose deadline passed is *stealable*: any
    # worker may remove it and re-claim, so points held by a killed worker
    # return to the pool after ``ttl_s`` (the fleet-level analogue of the
    # paper's fault-tolerant forwarding — stalled work resumes elsewhere).
    #
    # The unlink-then-create steal has a benign TOCTOU window (two stealers
    # may both end up computing the point): leases only need *liveness*,
    # not mutual exclusion, because execution is idempotent — results are
    # content-addressed and bit-identical across backends and workers, and
    # ``put`` publishes by atomic rename.  A double-claim costs wall time,
    # never correctness.

    def try_claim(self, digest: str, owner: str, ttl_s: float) -> bool:
        """Claim ``digest`` for ``owner`` until ``now + ttl_s``.

        Returns False when another worker holds an unexpired lease.  An
        expired lease is stolen (removed and re-claimed).
        """
        path = self._lease_path(digest)
        os.makedirs(os.path.dirname(path), exist_ok=True)
        doc = json.dumps({"digest": digest, "owner": owner,
                          "deadline": time.time() + ttl_s})
        for _ in range(2):          # second pass: after stealing an expiry
            try:
                fd = os.open(path, os.O_CREAT | os.O_EXCL | os.O_WRONLY)
            except FileExistsError:
                info = self.lease_info(digest)
                if info is not None and info["deadline"] > time.time():
                    return False    # live lease held elsewhere
                try:                # expired (or unreadable): steal
                    os.unlink(path)
                except FileNotFoundError:
                    pass            # a racing stealer got there first
                continue
            with os.fdopen(fd, "w") as f:
                f.write(doc)
            return True
        return False

    def renew_lease(self, digest: str, owner: str, ttl_s: float) -> bool:
        """Extend ``owner``'s lease; False if it was lost (stolen/expired)."""
        info = self.lease_info(digest)
        if info is None or info["owner"] != owner:
            return False
        path = self._lease_path(digest)
        tmp = path + f".{owner}.tmp"
        with open(tmp, "w") as f:
            json.dump({"digest": digest, "owner": owner,
                       "deadline": time.time() + ttl_s}, f)
        os.replace(tmp, path)
        return True

    def release_lease(self, digest: str, owner: Optional[str] = None
                      ) -> None:
        """Remove the lease; with ``owner`` given, only if still held by
        that owner — a worker whose lease was stolen must not unlink the
        stealer's fresh lease on its way out."""
        if owner is not None:
            info = self.lease_info(digest)
            if info is not None and info.get("owner") != owner:
                return
        try:
            os.unlink(self._lease_path(digest))
        except FileNotFoundError:
            pass

    def lease_info(self, digest: str) -> Optional[Dict]:
        """{"owner", "deadline"} of the current lease, or None."""
        try:
            with open(self._lease_path(digest)) as f:
                return json.load(f)
        except (FileNotFoundError, json.JSONDecodeError):
            return None
