"""Split computing of a decoder-only LM over heterogeneous executors: the
φ-driven stage planner, its cost model and refinement, and the split-serve
engine (port of ``repro.splitcompute``)."""
from repro_torch.splitcompute.partitioner import (StagePlan, plan_stages,
                                                  split_points)
from repro_torch.splitcompute.planner import (PipelineCost, layer_profile,
                                              plan_and_refine, plan_cost,
                                              refine_plan)
from repro_torch.splitcompute.serve_engine import (ServeStats,
                                                   SplitServeEngine)

__all__ = ["StagePlan", "plan_stages", "split_points", "SplitServeEngine",
           "ServeStats", "PipelineCost", "plan_cost", "refine_plan",
           "plan_and_refine", "layer_profile"]
