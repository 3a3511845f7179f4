"""The synthetic token pipeline; port of ``repro/data``."""
from repro_torch.data.pipeline import DataConfig, Prefetcher, batch_at

__all__ = ["DataConfig", "batch_at", "Prefetcher"]
