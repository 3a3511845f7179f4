"""R003 true negative: a pure loop; impure helpers exist but are
unreachable from it."""
import time

import torch


def _step(x):
    return x * 2.0


def _epoch(st, keys, epoch_idx, strategy, cfg, profile):
    return _step(st)


def run_sim(keys, cfg, strategy, n=None):
    return _epoch(torch.ones(()), keys, 0, strategy, cfg, None)


def host_report(metrics):
    # impure on purpose — but only ever called from the host side, never
    # from the loop's call graph, so the rule must stay silent
    print({k: v.cpu().numpy() for k, v in metrics.items()}, time.time())
