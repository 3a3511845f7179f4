"""Share of the traced window with no operation on the card, %."""
from harness.readers import idle_share as read  # noqa: F401
