"""R003 true positives: a wall clock and a host read reachable from the
simulator loop."""
import time

import torch


def _stamp(x):
    return x + time.time()      # host clock inside the loop


def _sync(x):
    return x + x.sum().item()   # waits for the card, every epoch


def _epoch(st, keys, epoch_idx, strategy, cfg, profile):
    return _sync(_stamp(st))


def run_sim(keys, cfg, strategy, n=None):
    return _epoch(torch.zeros(()), keys, 0, strategy, cfg, None)
