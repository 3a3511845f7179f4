"""Model FLOPs of the requests finished in the window (at the depth served) over the window at 989 TFLOP/s, %."""
from harness.readers import mfu as read  # noqa: F401
