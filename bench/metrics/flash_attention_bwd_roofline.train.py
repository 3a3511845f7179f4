"""Flash backward's bound over its device time, summed over the traced calls, %."""
from harness.readers import flash_bwd_roofline as read  # noqa: F401
