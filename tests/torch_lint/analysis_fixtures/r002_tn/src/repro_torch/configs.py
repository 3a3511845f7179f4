"""R002 true negative config: covered wholesale by the digest."""
import dataclasses


@dataclasses.dataclass(frozen=True)
class SwarmConfig:
    num_workers: int = 8
    tick_s: float = 0.05
    trace_capacity: int = 0
