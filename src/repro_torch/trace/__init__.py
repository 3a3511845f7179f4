"""`repro_torch.trace`: per-task, per-hop and swarm-state telemetry
(DESIGN.md §10, §12, §14.4), port of ``repro.trace``.

The simulator accumulates scalar sums only; this package captures one
fixed-width :mod:`~repro_torch.trace.schema` TaskRecord per finished task,
one HopRecord per delivered transfer and, every N-th epoch, a snapshot of
per-node and swarm-wide gauges (the flight recorder), *inside* the epoch
loop on the simulator's device (:mod:`~repro_torch.trace.record`).  On the
host, :mod:`~repro_torch.trace.decode` turns the buffers into numpy
columns, :mod:`~repro_torch.trace.aggregate` into the paper's task-, hop-
and state-level indices, :mod:`~repro_torch.trace.critical` splits each
task's latency into compute / queue-wait / airtime / stall segments that
sum back exactly, and :mod:`~repro_torch.trace.export` writes a
Chrome-trace/Perfetto timeline.

Enabled by ``SwarmConfig.trace_capacity > 0`` (tasks),
``trace_hop_capacity > 0`` (hops) and ``trace_state_every > 0`` (state),
independently; with the defaults 0 no trace state exists.
"""
from repro_torch.trace import schema
from repro_torch.trace.aggregate import (exit_label_histogram, hop_airtime_s,
                                         hop_energy_j, hop_histogram,
                                         hop_indices, int_histogram,
                                         jain_fairness, link_bits,
                                         link_energy_j, quantile_summary,
                                         state_indices, trace_indices)
from repro_torch.trace.critical import (SEGMENTS, attribute, decompose,
                                        hop_stall_fraction, segment_indices)
from repro_torch.trace.decode import (decode, decode_hops, decode_state,
                                      split_runs)
from repro_torch.trace.export import (chrome_trace_events, hop_trace_events,
                                      state_counter_events,
                                      write_chrome_trace)
from repro_torch.trace.record import (init_hops, init_state_stream,
                                      init_trace, state_enabled, traced_push,
                                      write_hop_records, write_records,
                                      write_state)

__all__ = ["schema", "decode", "decode_hops", "decode_state", "split_runs",
           "trace_indices", "hop_indices", "state_indices", "link_bits",
           "hop_airtime_s", "hop_energy_j", "link_energy_j",
           "quantile_summary", "jain_fairness",
           "hop_histogram", "exit_label_histogram", "int_histogram",
           "chrome_trace_events", "hop_trace_events",
           "state_counter_events", "write_chrome_trace",
           "init_trace", "init_hops", "init_state_stream", "state_enabled",
           "traced_push", "write_records", "write_hop_records",
           "write_state",
           "SEGMENTS", "decompose", "segment_indices", "attribute",
           "hop_stall_fraction"]
