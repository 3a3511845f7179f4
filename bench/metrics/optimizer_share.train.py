"""Share of the card's busy time in the _foreach kernels of optim.adamw, %."""
from harness.readers import optimizer_share as read  # noqa: F401
