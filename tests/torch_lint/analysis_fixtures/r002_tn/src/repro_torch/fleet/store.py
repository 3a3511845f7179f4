"""Wholesale cfg digest: every SwarmConfig field covered by construction."""
import dataclasses
import hashlib
import json

IMPL = "repro_torch"


def point_digest(point, version=None):
    payload = {
        "impl": IMPL,
        "cfg": dataclasses.asdict(point.cfg),
        "strategy": int(point.strategy),
        "num_runs": int(point.num_runs),
        "seed": int(point.seed),
        "code_version": version,
    }
    blob = json.dumps(payload, sort_keys=True).encode()
    return hashlib.sha256(blob).hexdigest()
