"""AdamW with global-norm clip and a cosine schedule; port of
``repro/optim``."""
from repro_torch.optim.adamw import (OptConfig, OptState, apply_updates,
                                     clip_by_global_norm, global_norm,
                                     global_norm_sharded, init_opt,
                                     opt_specs, schedule)

__all__ = ["OptConfig", "OptState", "init_opt", "opt_specs",
           "apply_updates", "schedule", "global_norm",
           "global_norm_sharded", "clip_by_global_norm"]
