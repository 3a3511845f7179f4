"""Flash forward's bound over its device time, summed over the traced launches, %."""
from harness.readers import flash_fwd_roofline as read  # noqa: F401
