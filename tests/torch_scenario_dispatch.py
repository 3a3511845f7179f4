"""Third-party scenario models through spawned fleet workers.

    PYTHONPATH=src:tests python tests/torch_scenario_dispatch.py OUT_DIR \\
        [--device cpu] [--late]

Registers the toy models and the built-in aliases of
``torch_scenario_models.py`` at module level, then sweeps them (and the
built-in names) over two spawned workers (``fleet.dispatch``) into a
store under ``OUT_DIR``.  Under ``spawn`` a worker re-imports this module
as its main module, so the module-level registrations run there too: the
report is byte-identical to ``execute``'s in this process, and the alias
points equal the built-in ones on every leaf.  With ``--late`` the models
are registered inside ``main`` instead, which a worker never runs: the
sweep must fail in the workers with the unknown name.  Exits non-zero on
any mismatch.
"""
import argparse
import dataclasses
import json
import sys

import numpy as np

import repro_torch.swarm as swarm
import torch_scenario_models as toys
from repro_torch import fleet
from repro_torch.configs import SwarmConfig

LATE = "--late" in sys.argv
if not LATE:
    toys.register(swarm, toys.port_toys())
    toys.register(swarm, toys.port_aliases())

CFG = dataclasses.replace(SwarmConfig(), num_workers=6, queue_slots=8,
                          sim_time_s=1.0)
AXES = {"scenario": (("toy", toys.TOY), ("alias", toys.ALIAS),
                     ("builtin", toys.BUILTIN))}


def report(res) -> str:
    return json.dumps(fleet.build_report(res), sort_keys=True)


def main() -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("out")
    ap.add_argument("--device", default=None)
    ap.add_argument("--late", action="store_true")
    args = ap.parse_args()
    if args.late:
        toys.register(swarm, toys.port_toys())
        toys.register(swarm, toys.port_aliases())
    spec = fleet.SweepSpec.build("third_party", CFG, axes=AXES,
                                 strategies=(swarm.RANDOM, swarm.DISTRIBUTED),
                                 num_runs=2)
    store = fleet.ResultStore(args.out)
    if args.late:
        try:
            fleet.dispatch(spec, store, workers=2, device=args.device)
        except RuntimeError as e:
            assert "exited non-zero" in str(e), e
            print("models registered inside main did not reach the workers")
            return 0
        print("a worker ran a model registered after the spawn")
        return 1
    want = fleet.execute(spec, device=args.device)
    got = fleet.dispatch(spec, store, workers=2, device=args.device)
    if report(got) != report(want):
        print("the two workers' report differs from execute's")
        return 1
    for s in ("Random", "Distributed"):
        a = want[f"scenario=alias/strategy={s}"]
        b = want[f"scenario=builtin/strategy={s}"]
        bad = [k for k in b if not k.startswith("_")
               and not np.array_equal(a[k], b[k])]
        if bad:
            print(f"{s}: the aliases differ from the built-ins: {bad}")
            return 1
    print(f"{len(got)} points over two spawned workers: report "
          f"byte-identical to execute's; aliases equal the built-ins")
    return 0


if __name__ == "__main__":
    sys.exit(main())
