"""Median span on the card of one engine step() in the window (CUDA events
around the call), ms."""
from harness.readers import step_ms as read  # noqa: F401
