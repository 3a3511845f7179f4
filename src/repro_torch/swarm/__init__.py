"""Swarm simulator: scenario models, queues, transfers and the epoch loop.

The public API is the reference's (``repro.swarm``), name for name.  Code
inside the port imports the submodules, never these re-exports, so that
``trace.record``'s import of ``swarm.queues`` closes no cycle."""
from repro_torch.swarm.neighbors import (comm_range_m, grid_geometry,
                                         mask_neighbors, neighbor_lists)
from repro_torch.swarm.scenario import (CHANNEL_EDGE_MODELS, CHANNEL_MODELS,
                                        FAULT_MODELS, MOBILITY_MODELS,
                                        get_channel, get_channel_edges,
                                        get_fault, get_mobility,
                                        mask_adjacency, register_channel,
                                        register_channel_edges,
                                        register_fault, register_mobility)
from repro_torch.swarm.simulator import (DISTRIBUTED, GREEDY, LOCAL_ONLY,
                                         RANDOM, RANDOM_ACYCLIC,
                                         STRATEGY_NAMES, run_many, run_sim)
from repro_torch.swarm.tasks import TaskProfile, make_profile

__all__ = ["run_sim", "run_many", "make_profile", "TaskProfile",
           "LOCAL_ONLY", "RANDOM", "RANDOM_ACYCLIC", "GREEDY", "DISTRIBUTED",
           "STRATEGY_NAMES",
           "MOBILITY_MODELS", "CHANNEL_MODELS", "CHANNEL_EDGE_MODELS",
           "FAULT_MODELS",
           "register_mobility", "register_channel", "register_channel_edges",
           "register_fault", "get_mobility", "get_channel",
           "get_channel_edges", "get_fault", "mask_adjacency",
           "neighbor_lists", "mask_neighbors", "comm_range_m",
           "grid_geometry"]
