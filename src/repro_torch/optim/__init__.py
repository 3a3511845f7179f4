"""AdamW with global-norm clip and a cosine schedule; port of
``repro/optim``."""
from repro_torch.optim.adamw import (OptConfig, OptState, apply_updates,
                                     clip_by_global_norm, global_norm,
                                     init_opt, schedule)

__all__ = ["OptConfig", "OptState", "init_opt", "apply_updates", "schedule",
           "global_norm", "clip_by_global_norm"]
