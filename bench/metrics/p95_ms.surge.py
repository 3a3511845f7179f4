"""95th percentile latency of the requests finished in the window, ms."""
from harness.readers import p95_ms as read  # noqa: F401
