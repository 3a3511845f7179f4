"""R002 true negative spec: every field digested or exempted."""
import dataclasses


@dataclasses.dataclass(frozen=True)
class SweepSpec:
    name: str = ""          # display label — exempted in the baseline
    base: object = None
    num_runs: int = 1
    seed: int = 0
