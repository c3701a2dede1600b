"""2D slices per second over the window (host clock)."""
from portbench.lib.readers import rate as read  # noqa: F401
