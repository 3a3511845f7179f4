"""Rows finished at exit label 0 (full depth) among those finished in the window, %."""
from harness.readers import full_depth_share as read  # noqa: F401
