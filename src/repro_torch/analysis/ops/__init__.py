"""swarmlint's ops tier — auditing the recorded op streams of the port's
real programs (the port of ``repro.analysis.jaxpr``; DESIGN.md §15).

The AST tier reads source text; this tier reads what the port actually
runs.  The registry in ``targets.py`` names the real programs (simulator
paths, φ launchers, executor backends, the serve engine's numeric core),
``record.py`` records each once per strategy under float32 and float64
default dtypes on a device, and the rules lint the shared recordings:

  * **J001 loop-reduction purity** (``rules.py``) — no cross-node float
    reductions inside the simulator loop (DESIGN.md §8.2, the port's
    determinism rule).
  * **J002 dtype stability** (``rules.py``) — the program's dtypes must
    not depend on torch's default dtype.
  * **J003 index audit** (``rules.py``) — every clamp-made or
    where-redirected gather/scatter index carries an inline
    ``# oob: <reason>`` annotation.
  * **J004 host-data bloat** (``rules.py``) — no large host data made
    into tensors inside a program call.
  * **J005 op-stream fingerprint stability** (``fingerprint.py``) —
    sweep points differing only in data run identical programs.

Findings share the AST tier's :class:`~repro_torch.analysis.astutil.Finding`
type and ``analysis_baseline_torch.toml`` matching; ``python -m
repro_torch.analysis --tier ops`` (or ``all``) runs this tier.  Like every
port entry point it runs on the card unless the caller asks for the CPU
(``device="cpu"``), and raises where CUDA is absent.
"""
from __future__ import annotations

import time
from typing import Dict, List, Optional, Sequence

from repro_torch.analysis.astutil import Finding
from repro_torch.analysis.ops import fingerprint, rules
from repro_torch.analysis.ops.targets import all_targets, trace_targets

OPS_RULES = {
    "J001": rules.check_j001,
    "J002": rules.check_j002,
    "J003": rules.check_j003,
    "J004": rules.check_j004,
    "J005": fingerprint.check_j005,
}


def run_ops(root: str, rule_ids: Optional[Sequence[str]] = None,
            device=None, report: Optional[Dict] = None) -> List[Finding]:
    """Record the target registry once on ``device`` (CUDA unless the
    caller asks for another device) and run the selected J rules over the
    shared recordings.  Returns raw findings (the caller applies the
    baseline, as for the AST rules).  A ``report`` dict receives what the
    run saw: per target its ops and kernel launches, the stand-in sweeps'
    fingerprint tables, and the seconds spent recording."""
    from repro_torch.device import resolve_device
    dev = resolve_device(device)
    ids = list(rule_ids) if rule_ids is not None else sorted(OPS_RULES)
    t0 = time.perf_counter()
    # J005 records its own sweeps; don't pay for the target registry
    # unless a structural rule actually runs
    traced = (trace_targets(device=dev) if any(i != "J005" for i in ids)
              else {})
    t_targets = time.perf_counter() - t0
    findings: List[Finding] = []
    tables: List[Dict] = []
    for rid in ids:
        if rid == "J005":
            findings.extend(fingerprint.check_j005(traced, root, dev,
                                                   tables))
        else:
            findings.extend(OPS_RULES[rid](traced, root))
    if report is not None:
        report.update({
            "device": str(dev),
            "targets": {name: {"ops": sum(len(r) for r in
                                          tt.rec32.values()),
                               "kernels": tt.kernels()}
                        for name, tt in traced.items()},
            "sweeps": tables,
            "targets_s": t_targets,
            "total_s": time.perf_counter() - t0,
        })
    return findings


__all__ = ["OPS_RULES", "run_ops", "all_targets", "trace_targets"]
