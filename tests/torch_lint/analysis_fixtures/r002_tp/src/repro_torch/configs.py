"""R002 true positive config: one field never reaches the digest."""
import dataclasses


@dataclasses.dataclass(frozen=True)
class SwarmConfig:
    num_workers: int = 8
    tick_s: float = 0.05
    trace_capacity: int = 0     # missing from point_digest
