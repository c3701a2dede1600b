"""3D volumes per second over the window, fed through the program's
stream (host clock)."""
from portbench.lib.readers import rate as read  # noqa: F401
