"""Run the paper's UAV-swarm simulation head-to-head on the PyTorch port: all
five offloading strategies at 30 workers, with and without
congestion-aware early exit (the twin of ``examples/swarm_simulation.py``).

Scenario selection is pure config, and the Monte-Carlo batch executes
through the port's fleet engine — e.g. random-waypoint mobility over a
log-normal channel with node churn, Monte-Carlo axis sharded over the
visible cards:

    PYTHONPATH=src python examples/torch_swarm_simulation.py --num-runs 16 \\
        --backend sharded \\
        --mobility random_waypoint --channel log_normal --fault markov

``--backend streaming`` caps memory at one swarm state per chunk (the
N >= 1k regime); all backends are bit-identical.

``--procs N`` goes one level up: the strategy sweep becomes a SweepSpec
dispatched across N worker *processes* through
``repro_torch.fleet.dispatch`` (lease-file work stealing over a shared
store) — same numbers, point axis parallel.

``--trace out.json`` additionally runs one per-task-telemetry simulation
of the Distributed strategy (``repro_torch.trace``): prints the task-level
latency CDF / hop / exit-label indices plus the hop-resolved transfer
decomposition, and writes a Chrome-trace/Perfetto timeline with one slice
+ flow arrow per *hop* — load it at https://ui.perfetto.dev or
chrome://tracing.  ``--trace-hops 0`` drops back to task records only (net
src→dst arrows).  ``--trace-state EVERY`` additionally turns on the
per-epoch flight recorder for that run: prints the φ-convergence summary
and adds Perfetto *counter tracks* to the same timeline file.

Runs on the card unless ``--device`` names another device (``cpu``), and
raises where there is none.  ``main`` returns each strategy's metrics.
"""
import argparse
import dataclasses
import os
import tempfile

import numpy as np
import torch

from repro_torch import rng
from repro_torch.configs import SwarmConfig
from repro_torch.device import resolve_device
from repro_torch.fleet import (BACKENDS, ResultStore, SweepSpec, dispatch,
                               run_batch)
from repro_torch.swarm.scenario import (CHANNEL_MODELS, FAULT_MODELS,
                                        MOBILITY_MODELS)
from repro_torch.swarm.simulator import STRATEGY_NAMES


def show(tag, m):
    print(f"  {tag:14s} latency={np.mean(m['avg_latency_s']):7.3f}s  "
          f"remaining={np.mean(m['remaining_gflops']):9.1f} GF  "
          f"jain={np.mean(m['jain_fairness']):.3f}  "
          f"E/task={np.mean(m['energy_per_task_j']):.3f} J  "
          f"acc={np.mean(m['avg_accuracy']):.3f}  "
          f"FOM={np.mean(m['fom']):9.1f}")


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--num-runs", "--runs", dest="num_runs", type=int,
                    default=8, help="Monte-Carlo runs per strategy")
    ap.add_argument("--workers", type=int, default=30)
    ap.add_argument("--sim-time", type=float, default=50.0)
    ap.add_argument("--backend", default="vmap", choices=BACKENDS,
                    help="fleet executor backend (bit-identical; sharded "
                         "splits runs over devices, streaming bounds memory)")
    ap.add_argument("--chunk-size", type=int, default=8,
                    help="runs per chunk for --backend streaming")
    ap.add_argument("--procs", type=int, default=1,
                    help="dispatch the strategy sweep across this many "
                         "worker processes (repro_torch.fleet.dispatch)")
    ap.add_argument("--store", default=None,
                    help="shared store root for --procs > 1 "
                         "(default: a temp dir)")
    ap.add_argument("--mobility", default="circular",
                    choices=sorted(MOBILITY_MODELS))
    ap.add_argument("--channel", default="two_ray",
                    choices=sorted(CHANNEL_MODELS))
    ap.add_argument("--fault", default="none", choices=sorted(FAULT_MODELS))
    ap.add_argument("--trace", default=None, metavar="OUT_JSON",
                    help="run one traced Distributed simulation and write "
                         "a Chrome-trace/Perfetto timeline here")
    ap.add_argument("--trace-capacity", type=int, default=65536,
                    help="TaskRecord slots for --trace (records beyond "
                         "this count as overflow)")
    ap.add_argument("--trace-hops", type=int, default=65536,
                    metavar="CAPACITY",
                    help="HopRecord slots for --trace (one record per "
                         "delivered transfer; 0 disables the hop stream "
                         "and falls back to net src->dst arrows)")
    ap.add_argument("--trace-state", type=int, default=0, metavar="EVERY",
                    help="flight recorder for --trace: sample the swarm "
                         "state every EVERY epochs (0 disables) — prints "
                         "the φ-convergence summary and adds Perfetto "
                         "counter tracks to the timeline")
    ap.add_argument("--device", default=None,
                    help="torch device (default: cuda, required)")
    args = ap.parse_args(argv)
    device = resolve_device(args.device)
    # the sharded backend's shards: every visible card, or the one device
    devices = None if device.type == "cuda" else [device]
    n_dev = torch.cuda.device_count() if device.type == "cuda" else 1

    key = rng.PRNGKey(0)
    cfg = dataclasses.replace(SwarmConfig(), num_workers=args.workers,
                              sim_time_s=args.sim_time,
                              mobility_model=args.mobility,
                              channel_model=args.channel,
                              fault_model=args.fault)
    print(f"{args.workers} UAVs, {args.sim_time:.0f}s, {args.num_runs} runs "
          f"(backend={args.backend}, {n_dev} device(s), "
          f"{args.procs} proc(s)), "
          "bursty Markov arrivals (60 ms mean), scenario="
          f"{args.mobility}/{args.channel}/fault:{args.fault}")

    cfg_ee = dataclasses.replace(cfg, early_exit_enabled=True)

    if args.trace:
        from repro_torch.trace import (decode, decode_hops, decode_state,
                                       hop_indices, state_indices,
                                       trace_indices, write_chrome_trace)
        cfg_tr = dataclasses.replace(cfg,
                                     trace_capacity=args.trace_capacity,
                                     trace_hop_capacity=args.trace_hops,
                                     trace_state_every=args.trace_state)
        m = run_batch(key, cfg_tr, 4, args.workers, 1, device=device)
        dec = decode(m["trace_records"], m["trace_overflow"])
        idx = trace_indices(dec)
        print(f"\nper-task telemetry (Distributed, 1 run, "
              f"capacity {args.trace_capacity}):")
        print(f"  tasks={idx['task_count']} dropped={idx['dropped_count']} "
              f"overflow={idx['trace_overflow']}")
        if idx["task_latency_cdf_s"] is not None:
            cdf = idx["task_latency_cdf_s"]
            print(f"  latency p50={cdf['p50']:.3f}s p95={cdf['p95']:.3f}s "
                  f"p99={cdf['p99']:.3f}s  "
                  f"jain={idx['task_latency_jain']:.3f}")
            print(f"  hops={idx['hop_histogram']} "
                  f"exits={idx['exit_label_histogram']}")
        hdec = None
        if args.trace_hops > 0:
            hdec = decode_hops(m["trace_hops"], m["trace_hop_overflow"])
            hix = hop_indices(hdec, tick_s=cfg_tr.tick_s)
            print(f"  hop records={hix['hop_count']} over {hix['link_count']}"
                  f" links, stalled={hix['stalled_hop_count']} "
                  f"overflow={hix['hop_overflow']}")
            if hix["hop_transfer_time_s_quantiles"] is not None:
                ht = hix["hop_transfer_time_s_quantiles"]
                qw = hix["hop_queue_wait_s_quantiles"]
                print(f"  hop time p50={ht['p50']:.3f}s p95={ht['p95']:.3f}s"
                      f"  queue-wait p95={qw['p95']:.3f}s")
        sdec = None
        if args.trace_state > 0:
            sdec = decode_state(m["trace_state"], m["trace_state_sys"],
                                m["trace_state_epochs"])
            six = state_indices(sdec)
            eps = six["phi_epochs_to_eps"]
            print(f"  flight recorder: {six['state_sample_count']} samples "
                  f"(every {args.trace_state}), "
                  f"phi->5% at epoch {eps if eps is not None else 'n/a'}, "
                  f"queue jain final={six['queue_jain_final']}, "
                  f"energy={six['energy_drain_j_curve'][-1]:.1f} J")
        path = write_chrome_trace(args.trace, dec, hdec, cfg_tr.tick_s,
                                  state=sdec)
        print(f"wrote {path} "
              "(open in chrome://tracing or ui.perfetto.dev)")

    results = {}
    if args.procs > 1:
        # two specs — the five plain strategies, then Distributed+EE (a
        # different config) — dispatched over a shared store; workers
        # claim points by lease and steal from dead peers
        store = ResultStore(args.store or
                            tempfile.mkdtemp(prefix="repro_torch_fleet_"))
        spec = SweepSpec.build(
            "swarm_example", cfg, strategies=range(len(STRATEGY_NAMES)),
            num_runs=args.num_runs)
        res = dispatch(spec, store, workers=args.procs,
                       backend=args.backend, chunk_size=args.chunk_size,
                       progress_path=os.path.join(store.root,
                                                  "progress.jsonl"),
                       device=args.device)
        spec_ee = SweepSpec.build("swarm_example_ee", cfg_ee,
                                  strategies=(4,), num_runs=args.num_runs)
        res_ee = dispatch(spec_ee, store, workers=args.procs,
                          backend=args.backend, chunk_size=args.chunk_size,
                          device=args.device)
        print(f"\n(dispatched over {args.procs} processes, "
              f"store={store.root})")
        print("\nno early exit (paper Fig. 4 regime):")
        for pt in spec.expand():
            results[STRATEGY_NAMES[pt.strategy]] = res[pt.label]
            show(STRATEGY_NAMES[pt.strategy], res[pt.label])
        print("\nDistributed + congestion-aware early exit (Fig. 7):")
        (pt_ee,) = spec_ee.expand()
        results["Distributed+EE"] = res_ee[pt_ee.label]
        show("Distributed+EE", res_ee[pt_ee.label])
        return results

    def batch(cfg, s):
        m = run_batch(key, cfg, s, args.workers, args.num_runs,
                      backend=args.backend, chunk_size=args.chunk_size,
                      device=device, devices=devices)
        return {k: v.cpu().numpy() for k, v in m.items()}

    print("\nno early exit (paper Fig. 4 regime):")
    for s, name in enumerate(STRATEGY_NAMES):
        results[name] = batch(cfg, s)
        show(name, results[name])

    print("\nDistributed + congestion-aware early exit (Fig. 7):")
    results["Distributed+EE"] = batch(cfg_ee, 4)
    show("Distributed+EE", results["Distributed+EE"])
    return results


if __name__ == "__main__":
    main()
