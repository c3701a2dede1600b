"""90th percentile of the 2D k-space-to-image seconds (host clock)."""
from portbench.lib.readers import p90 as read  # noqa: F401
