"""Explicit field enumeration that forgot ``trace_capacity``."""
import hashlib
import json

IMPL = "repro_torch"


def point_digest(point, version=None):
    payload = {
        "impl": IMPL,
        "num_workers": point.cfg.num_workers,
        "tick_s": point.cfg.tick_s,
        "strategy": int(point.strategy),
        "n": int(point.n),
        "num_runs": int(point.num_runs),
        "seed": int(point.seed),
        "code_version": version,
    }
    blob = json.dumps(payload, sort_keys=True).encode()
    return hashlib.sha256(blob).hexdigest()
