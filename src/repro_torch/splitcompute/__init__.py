"""Split computing of a decoder-only LM over heterogeneous executors: the
φ-driven stage planner and the split-serve engine (port of
``repro.splitcompute``; ``planner`` comes in a later slice)."""
from repro_torch.splitcompute.partitioner import (StagePlan, plan_stages,
                                                  split_points)
from repro_torch.splitcompute.serve_engine import (ServeStats,
                                                   SplitServeEngine)

__all__ = ["StagePlan", "plan_stages", "split_points", "ServeStats",
           "SplitServeEngine"]
