"""R003 true positive through a registry dict literal: the loop reaches
a registered model by dispatch, which no call graph shows."""
from typing import Callable, NamedTuple

import numpy as np


class MobilityModel(NamedTuple):
    init: Callable
    step: Callable


def _ghost_init(keys, cfg, n):
    return {}


def _ghost_step(state, keys, cfg, t0):
    return state, np.random.uniform(size=(n_nodes(state), 2))


def n_nodes(state):
    return len(state)


MOBILITY_MODELS = {
    "ghost": MobilityModel(_ghost_init, _ghost_step),
}
