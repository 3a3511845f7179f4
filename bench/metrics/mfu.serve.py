"""Model FLOPs of the requests finished in the window over the window at 989 TFLOP/s, %."""
from harness.readers import mfu as read  # noqa: F401
