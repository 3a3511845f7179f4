"""`repro_torch.fleet` — sharded Monte-Carlo sweep engine (DESIGN.md §8-9);
port of ``repro.fleet``.

Declare a scenario grid as a :class:`SweepSpec`, execute it on any backend
(``vmap`` / ``sharded`` / ``streaming`` — bit-identical), cache/resume
through :class:`ResultStore`, aggregate with :mod:`repro_torch.fleet.report`,
and scale the point axis over processes/hosts with
:mod:`repro_torch.fleet.dispatch`.  Everything runs on the card unless the
caller passes ``device="cpu"``.
"""
from repro_torch.fleet.dispatch import (ProgressWriter, WorkerEnv, collect,
                                        dispatch, progress_summary,
                                        publish_spec, read_progress,
                                        render_progress, run_sweep,
                                        run_worker, spawn_workers,
                                        worker_env)
from repro_torch.fleet.executor import (BACKENDS, SweepInterrupted, execute,
                                        run_batch, run_point)
from repro_torch.fleet.report import (build_report, ci95, latency_cdf,
                                      load_bench_json, point_indices,
                                      write_bench_json)
from repro_torch.fleet.store import ResultStore, code_version, point_digest
from repro_torch.fleet.sweep import SweepPoint, SweepSpec

__all__ = ["SweepSpec", "SweepPoint", "BACKENDS", "SweepInterrupted",
           "execute", "run_batch", "run_point",
           "ResultStore", "point_digest", "code_version",
           "build_report", "point_indices", "latency_cdf", "ci95",
           "load_bench_json", "write_bench_json",
           "dispatch", "run_sweep", "run_worker", "spawn_workers",
           "collect", "publish_spec", "worker_env", "WorkerEnv",
           "ProgressWriter", "read_progress", "progress_summary",
           "render_progress"]
