"""Share of the traced window in which no operation ran on the card."""
from bench.metrics._stats import idle_share as read  # noqa: F401
